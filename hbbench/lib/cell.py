"""Find every piece of a cell by name.

``BENCHMARK.json`` names a cell's configuration and traffic mix.  The
pieces are files of their own under ``hbbench/``:

- ``configs/<config>/config.json``: the sizes as run; ``model.py`` beside
  it makes the weights and inputs from the seed and binds the program to
  them; ``reference.py`` is the plain PyTorch forward;
- ``workloads/<traffic>.json``: the mix (loop, clients, plan, limits);
- ``plans/<plan>.json``: each ReLU group's (k, m), or the rule giving it;
- ``loops/<loop>.py``: the generator that drives the window;
- ``metrics/<metric>.py``: one reader per metric.

A later change adds a configuration, a mix, a plan or a metric by adding
files and entries; no file here needs an edit for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_module(path: pathlib.Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold
    '.' and '-', which a plain import does not take)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _safe(name: str) -> str:
    return "hbbench_" + "".join(c if c.isalnum() else "_" for c in name)


def manifest(path: pathlib.Path = MANIFEST) -> Dict:
    return _json(path)


def config_dir(config: str) -> pathlib.Path:
    return BENCH / "configs" / config


def config_module(config: str):
    return load_module(config_dir(config) / "model.py", _safe(f"cfg_{config}"))


def reference_module(config: str):
    return load_module(config_dir(config) / "reference.py", _safe(f"ref_{config}"))


def plan_data(plan: str) -> Dict:
    return _json(BENCH / "plans" / f"{plan}.json")


def workload_data(traffic: str) -> Dict:
    return _json(BENCH / "workloads" / f"{traffic}.json")


def loop_module(loop: str):
    return load_module(BENCH / "loops" / f"{loop}.py", _safe(f"loop_{loop}"))


def metric_module(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py", _safe(f"metric_{metric}"))


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with every piece it names, loaded."""

    name: str
    chips: int
    config_name: str
    cfg: Dict                  # config.json with the mix's request sizes
    workload: Dict
    plan: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def model(self):
        return config_module(self.config_name)

    @property
    def reference(self):
        return reference_module(self.config_name)

    @property
    def loop(self):
        return loop_module(self.workload.get("loop", "closed"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of the manifest, every piece loaded; raises
    ``KeyError`` for a cell the manifest does not hold."""
    bench = bench if bench is not None else manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = workload_data(entry["traffic"])
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"],
        cfg={**_json(config_dir(entry["config"]) / "config.json"),
             **workload.get("request", {})},
        workload=workload, plan=plan_data(workload["plan"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
