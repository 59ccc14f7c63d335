#!/usr/bin/env python3
"""Each phase's seconds of a checkout's ``chip_smoke.py``, on the card.

    python3 tools/chip_smoke_phases.py [--tree DIR]

Loads ``DIR/chip_smoke.py`` (default: this checkout) with ``DIR/src`` first
on the path, wraps the kernel build and every phase ``main()`` calls (those
of the list below that the tree has; a phase called inside another counts
in the outer one's time) in a timer, and runs its ``main()``:
the script's own checks and output, then one JSON line
``{"tree": DIR, "phase_s": {...}, "total_s": ...}``.  Trees from before
the script printed its phase seconds itself are timed the same way, so two
trees compare phase by phase in one call (``git archive <parent> | tar -x
-C build/parent``, then ``--tree build/parent`` and ``--tree .``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PHASES = ("lm_setup", "lm_long_setups", "kernel_phase", "main_path_phase",
          "lm_path_phase", "lm_relu_phase", "lm_long_phase", "ragged_merge_phase",
          "merge_phase", "stem_breakdown_phase", "search_phase", "serve_phase",
          "serve_lm_phase", "frontend_phase", "seed_oracle_phase",
          "deploy_phase", "deploy_kernel_phase", "examples_phase", "mesh_phase", "analysis_phase",
          "mesh_kernel_phase", "zoo_phase", "train_phase", "dryrun_phase")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(__file__), ".."))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timed", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import build

    times: dict = {}
    active: list = []                   # a phase called inside another is its time

    def timed(name, fn):
        def run(*args, **kwargs):
            if active:
                return fn(*args, **kwargs)
            active.append(name)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times[name] = times.get(name, 0.0) + time.perf_counter() - t0
                active.pop()
        return run

    build.build_all = timed("build", build.build_all)
    for name in PHASES:
        if hasattr(smoke, name):
            setattr(smoke, name, timed(name, getattr(smoke, name)))
    t0 = time.perf_counter()
    smoke.main()
    print(json.dumps({"tree": tree, "phase_s": times,
                      "total_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
