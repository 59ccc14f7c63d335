"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors
(twin of the reference's ``launch/dryrun.py``).

For each cell this starts torch's ``fake`` process group of 256 or 512
ranks in this one process, builds the 16x16 single-pod or 2x16x16
multi-pod ``DeviceMesh`` over it (the multi-pod one traced as (pod·data,
model) = (32, 16): the rules and the constraints never place a tensor on
pod without data, so every rank holds the same blocks, a collective over
both is one collective, as XLA issues it, and DTensor's sharding
propagation, whose cost grows with the mesh's dims, takes a fraction of
the time), makes the step's inputs DTensors with
the partition rules' placements (``launch/specs.py``) under
``FakeTensorMode``, and runs the step (train_step / prefill / decode_step)
once under ``runtime/op_analyzer`` with the in-model constraints' context
mesh set.  Nothing is allocated and no collective moves a byte.  It
records, for rank 0 (every rank of these meshes does the same work), the
peak of live storage, the FLOPs, bytes and collectives, and the roofline
terms priced at the H100's datasheet peaks (``runtime/roofline.py``), and
writes one JSON per cell under results/dryrun_torch/.  The ``"hlo"``
figures keep the reference's key but are counted from the aten ops each
rank dispatches, not from compiled HLO; ``trace_s`` takes the place of
``lower_s`` / ``compile_s``.

``--mpc`` dry-runs the paper's MPC ResNet serving step on the (party=2,
data=256) mesh, baseline vs HummingBird: each rank's rounds and bytes, as
``plan.schedule()`` gives them for its shard of the batch of 512, and its
block of the triple pool (``launch/serve.mpc_input_specs``), priced with
``mpc_roofline_terms``; nothing runs.  ``--mpc --mpc-arch NAME`` traces
the private LM's plan instead (``models/lm.trace`` over shape-only
params), or one ResNet for ``resnet18`` / ``resnet50``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod-only|--singlepod-only]
  python -m repro_torch.launch.dryrun --mpc [--mpc-budget 8of64]
  python -m repro_torch.launch.dryrun --mpc --mpc-arch qwen1.5-0.5b-smoke
Add ``--device cpu`` to trace with CPU fake tensors on a machine without a
card; the default is ``cuda``, which raises without one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..api.plan import LAN, WAN
from ..configs import SHAPES, all_names, get as get_arch, shape_applicable
from ..configs.base import ArchConfig, ShapeConfig
from ..configs.resnet import RESNET18, RESNET50
from ..core.hummingbird import HBConfig, HBLayer
from ..device import Device, resolve as resolve_device
from ..models import lm, resnet
from ..runtime import constraints, op_analyzer
from ..runtime.roofline import mpc_roofline_terms, roofline_terms
from ..train import optimizer as opt_lib
from . import mesh as mesh_lib, serve as serve_lib, specs as specs_lib
from . import train as train_lib

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MPC_BATCH = 512          # the paper's Figure 1 setup: 512 CIFAR inferences
MPC_MESH = {"party": 2, "data": 256}


def _step_fn(cfg: ArchConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return train_lib.make_train_step(cfg, opt_lib.AdamW(),
                                         n_microbatches=cfg.train_microbatches)
    if shape.kind == "prefill":
        return serve_lib.make_prefill_step(cfg, max_len=shape.seq_len)
    return serve_lib.make_decode_step(cfg)


@contextlib.contextmanager
def _real_index_math():
    """DTensor computes a strided shard's offsets with ``torch.arange`` and
    ``.tolist()``; under ``FakeTensorMode`` those index tensors would be
    fake and hold no values, so that arithmetic runs on real ones."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.local_shard_size_and_offset

    def real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def trace_step(cfg: ArchConfig, shape: ShapeConfig,
               mesh_shape: Tuple[int, ...] = (16, 16), *,
               device: Device = None) -> dict:
    """One cell: ``cfg``'s step at ``shape`` on a fake process group of
    ``prod(mesh_shape)`` ranks and a mesh of that shape ("data", "model";
    "pod" in front of three dims, "data" alone for one), traced once on
    fake tensors.  Returns the record's measured part."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device)
    names = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(mesh_shape)]
    n_chips = 1
    for k in mesh_shape:
        n_chips *= k
    traced = mesh_shape
    if len(mesh_shape) == 3:
        # pod and data flattened into one dim (the module doc says why)
        traced = (mesh_shape[0] * mesh_shape[1], mesh_shape[2])
    mesh_lib.fake_process_group(n_chips)
    try:
        mesh = mesh_lib.make_device_mesh(traced, names[-len(traced):], device=dev)
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True), _real_index_math(), \
                constraints.use_mesh(mesh):
            args, kwargs = specs_lib.input_specs(cfg, shape, mesh, device=dev)
            m = op_analyzer.analyze(_step_fn(cfg, shape), *args, **kwargs)
            arg_bytes = op_analyzer.nbytes((args, kwargs))
        trace_s = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    return {
        "n_chips": n_chips, "mesh": dict(zip(names, mesh_shape)),
        "traced_mesh": dict(zip(names[-len(traced):], traced)),
        "device": dev.type, "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "temp_bytes": m.peak_bytes - arg_bytes,
                   "total_bytes": m.peak_bytes, "peak_bytes": m.peak_bytes},
        "hlo": {"flops": m.flops, "bytes": m.bytes,
                "collective_bytes": m.collective_bytes,
                "collectives": m.collective_counts,
                "aten_ops": sum(m.op_counts.values())},
        "roofline": roofline_terms(cfg, shape, m, n_chips),
    }


def run_cell(arch: str, shape_name, multi_pod: bool, overrides=None, *,
             device: Device = None, mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """``shape_name``: a name of ``SHAPES`` or a ``ShapeConfig``;
    ``mesh_shape`` replaces the production mesh (e.g. (1, 1), one card)."""
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    if mesh_shape is None:
        mesh_shape = mesh_lib.PRODUCTION_SHAPES[multi_pod][0]
    out = {"arch": arch, "shape": shape.name, "multi_pod": multi_pod, "status": "ok"}
    out.update(trace_step(cfg, shape, tuple(mesh_shape), device=device))
    if overrides:
        out["overrides"] = overrides
    return out


def run_mpc_cell(rcfg, hb, tag: str, cone: bool = False) -> dict:
    """The MPC ResNet step on the (party 2, data 256) mesh, per rank."""
    t0 = time.perf_counter()
    params, x, triples, key = serve_lib.mpc_input_specs(
        rcfg, MPC_BATCH, MPC_MESH, hb, cone=cone)
    pool = [leaf for b in triples if b is not None for leaf in _bundle_leaves(b)]
    pool_bytes = sum(s.block_bytes for s in pool)
    arg_bytes = (x.block_bytes + key.block_bytes + pool_bytes
                 + sum(s.block_bytes for s in opt_lib.tree_leaves(params)))
    per_rank = MPC_BATCH // MPC_MESH["data"]
    meta = opt_lib.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                           params)
    plan = resnet.trace(meta, rcfg, per_rank, hb=resnet.hb_or_exact(hb, rcfg), cone=cone)
    sched = plan.schedule()
    m = op_analyzer.Metrics(flops=0.0, bytes=float(arg_bytes),
                            collective_bytes=float(sched.bytes_tx),
                            collective_counts={"exchange": sched.n_rounds})
    n_chips = MPC_MESH["party"] * MPC_MESH["data"]
    return {
        "arch": f"{rcfg.name}-mpc-{tag}", "shape": f"cifar_b{MPC_BATCH}",
        "multi_pod": True, "status": "ok", "n_chips": n_chips,
        "mesh": dict(MPC_MESH), "trace_s": round(time.perf_counter() - t0, 2),
        "mpc": {"batch_per_rank": per_rank, "rounds": sched.n_rounds,
                "bytes_tx": sched.bytes_tx, "pool_bytes_per_rank": pool_bytes,
                "n_relu_calls": len(plan.calls),
                "budget_fraction": plan.hb.budget_fraction(),
                "latency_lan_s": sched.latency(LAN.bandwidth_bps, LAN.rtt_s),
                "latency_wan_s": sched.latency(WAN.bandwidth_bps, WAN.rtt_s)},
        "memory": {"argument_bytes": arg_bytes, "temp_bytes": None},
        "hlo": {"flops": None, "bytes": m.bytes,
                "collective_bytes": m.collective_bytes,
                "collectives": m.collective_counts},
        "roofline": mpc_roofline_terms(m, n_chips=n_chips),
    }


def _bundle_leaves(bundle):
    out = []
    for member in (bundle.bin_init, bundle.bin_levels, bundle.b2a, bundle.mult):
        for t in (member if isinstance(member, tuple) and not hasattr(member, "a")
                  else (member,)):
            out += [t.a, t.b, t.c]
    return out


def run_lm_mpc_cell(acfg: ArchConfig, budget: str, batch: int = 1, seq: int = 32) -> dict:
    """Trace-only dry run of the private LM: the reduced-ring plan (PWL
    activations, ReLU attention, Beaver opens) and its exact schedule
    prediction, over shape-only (meta) params in float32, the dtype the
    MPC path encodes its weights from."""
    t0 = time.perf_counter()
    params = opt_lib.tree_map(lambda leaf: torch.empty(leaf.shape, dtype=torch.float32,
                                                device="meta"),
                       specs_lib.param_shapes(acfg, "serve"))
    plan = lm.trace(params, acfg, batch, seq)
    if budget != "baseline":
        k, m = (21, 0) if budget == "eco" else (21, 13)
        hb = HBConfig(tuple(HBLayer(k=k, m=m) for _ in range(plan.hb.n_groups)),
                      plan.hb.group_elements)
        plan = lm.trace(params, acfg, batch, seq, hb=hb)
    sched = plan.schedule()
    return {
        "arch": f"{acfg.name}-mpc-lm-{budget}", "shape": f"b{batch}_s{seq}",
        "multi_pod": False, "status": "ok", "n_chips": 1,
        "trace_s": round(time.perf_counter() - t0, 2),
        "lm": {"n_relu_calls": len(plan.calls), "n_opens": len(plan.opens),
               "rounds": sched.n_rounds, "bytes_tx": sched.bytes_tx,
               "budget_fraction": plan.hb.budget_fraction(),
               "latency_lan_s": sched.latency(LAN.bandwidth_bps, LAN.rtt_s),
               "latency_wan_s": sched.latency(WAN.bandwidth_bps, WAN.rtt_s)},
    }


def hb_config_for(rcfg, budget: str):
    """Representative found configs (search engine output)."""
    n_groups = 1 + len(rcfg.stage_blocks)
    if budget == "baseline":
        return None
    if budget == "eco":
        layers = tuple(HBLayer(k=21, m=0) for _ in range(n_groups))
    else:  # 8/64
        layers = tuple(HBLayer(k=21, m=13) for _ in range(n_groups))
    return HBConfig(layers, tuple(1 for _ in range(n_groups)))


def _error(base: dict, e: BaseException) -> dict:
    return dict(base, status="error", error=f"{type(e).__name__}: {e}",
                trace=traceback.format_exc()[-2000:])


def _write(name: str, out: dict, results: Path) -> None:
    from ..kernels import ops

    out["kernel_launches"] = ops.launch_counts()   # the dry run launches none
    results.mkdir(parents=True, exist_ok=True)
    (results / name).write_text(json.dumps(out, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mpc", action="store_true")
    ap.add_argument("--mpc-arch", default=None,
                    help="registry arch name for a private-LM MPC cell (e.g. "
                         "qwen1.5-0.5b-smoke), or resnet18 / resnet50 alone; "
                         "default: the paper's ResNet pair")
    ap.add_argument("--mpc-budget", default="8of64",
                    choices=["baseline", "eco", "8of64", "8of64cone"])
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--singlepod-only", action="store_true")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ArchConfig overrides")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (cuda, or cpu when "
                         "asked; cuda raises without a card)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="with --global-batch and --kind: a ShapeConfig of "
                         "its own instead of --shape")
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--kind", default="train", choices=["train", "prefill", "decode"])
    ap.add_argument("--mesh", default=None,
                    help="a mesh shape instead of the production meshes, "
                         "e.g. 1x1 (one card) or 4 (data alone)")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the JSON")
    args = ap.parse_args(argv)
    results = Path(args.out)
    device = resolve_device(args.device)

    meshes = [False, True]
    if args.multipod_only:
        meshes = [True]
    if args.singlepod_only:
        meshes = [False]

    if args.mpc:
        budget = args.mpc_budget.replace("cone", "")
        resnets = {"resnet18": RESNET18, "resnet50": RESNET50}
        if args.mpc_arch and args.mpc_arch not in resnets:
            acfg = get_arch(args.mpc_arch)
            base = {"arch": f"{acfg.name}-mpc-lm-{budget}"}
            try:
                out = run_lm_mpc_cell(acfg, budget)
            except Exception as e:       # noqa: BLE001 (the cell records it)
                out = _error(base, e)
            _write(f"mpc_lm_{acfg.name}_{budget}{args.tag}.json", out, results)
            print(json.dumps({k: v for k, v in out.items() if k != "trace"}))
            return
        chosen = ([resnets[args.mpc_arch]] if args.mpc_arch
                  else [RESNET18, RESNET50])
        for rcfg in chosen:
            cone = args.mpc_budget.endswith("cone")
            tag = args.mpc_budget
            try:
                out = run_mpc_cell(rcfg, hb_config_for(rcfg, budget), tag, cone=cone)
            except Exception as e:       # noqa: BLE001 (the cell records it)
                out = _error({"arch": f"{rcfg.name}-mpc-{tag}"}, e)
            _write(f"mpc_{rcfg.name}_{tag}{args.tag}.json", out, results)
            print(json.dumps({k: v for k, v in out.items() if k != "trace"}))
        return

    overrides = json.loads(args.override) if args.override else None
    if args.seq_len is not None:
        shapes = [ShapeConfig(f"{args.kind}_b{args.global_batch}_s{args.seq_len}",
                              args.seq_len, args.global_batch, args.kind)]
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
    mesh_shape = (tuple(int(k) for k in args.mesh.split("x")) if args.mesh
                  else None)
    if mesh_shape is not None:
        meshes = [False]
    archs = [args.arch] if args.arch else all_names()
    for arch in archs:
        for shape in shapes:
            name = shape if isinstance(shape, str) else shape.name
            for multi_pod in meshes:
                tag = (args.mesh if mesh_shape else
                       ("multi" if multi_pod else "single"))
                base = {"arch": arch, "shape": name, "multi_pod": multi_pod}
                try:
                    out = run_cell(arch, shape, multi_pod, overrides, device=device,
                                   mesh_shape=mesh_shape)
                except Exception as e:   # noqa: BLE001 (the cell records it)
                    out = _error(base, e)
                _write(f"{arch}_{name}_{tag}{args.tag}.json", out, results)
                brief = {k: out.get(k) for k in
                         ("arch", "shape", "multi_pod", "status", "trace_s",
                          "error", "reason")}
                brief["memory"] = out.get("memory", {})
                brief["hlo"] = out.get("hlo", {})
                brief["roofline"] = out.get("roofline", {})
                print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
