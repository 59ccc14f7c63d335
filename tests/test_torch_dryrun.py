"""The port's dry run against the reference's, on the CPU (torch on one
thread):

- (a) the partition rules: for every registry arch at full width, in both
  modes, on (16, 16) and (2, 16, 16), the port's ``param_spec`` equals the
  reference's leaf by leaf (the AdamW ``m``/``v`` leaves too), and so do
  ``cache_spec`` at decode_32k and long_500k where it applies and
  ``batch_spec``; the reference is called on ``jax.sharding.AbstractMesh``
  with its shapes from ``jax.eval_shape``;
- (b) ``tests/test_runtime.py``'s rule and constraint tests on the port;
- (c) per-card counts: a smoke train step dry-run on a (1, 1) mesh counts
  what ``op_analyzer`` counts for the same step run for real, with no
  collective byte; on a data-only mesh of 4 fake ranks each card counts a
  quarter of the FLOPs and the gradient reductions show as collectives;
  ``peak_bytes`` equals a peak counted by hand; with a real one-rank
  context mesh ``apply`` gives the logits it gives without one;
- (d) ``run_lm_mpc_cell`` for ``qwen1.5-0.5b-smoke`` equals the
  reference's field for field at every budget;
- (e) ``mpc_input_specs`` equals the reference's in shapes and party/data
  dims for RESNET_SMOKE at batch 2 and RESNET18 at batch 512;
- (f) ``report`` / ``make_experiments`` tables from smoke cells' JSON, the
  MFU column at the H100 peak;
- (g) the train step runs under ``FakeTensorMode`` (it reads nothing back
  to the host), and its learning rate and bias corrections equal the
  reference's.

Each process group these tests start is destroyed before the test ends.
"""
import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES, all_names, get as jget
from repro.models import encdec as jencdec, lm as jlm
from repro.runtime import sharding as jsh
from repro.train import optimizer as jopt
from repro_torch.configs import RESNET18, RESNET_SMOKE, get
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import TokenPipeline
from repro_torch.launch import dryrun, make_experiments, report, serve, specs
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tencdec, lm as tlm
from repro_torch.runtime import constraints, op_analyzer, roofline, sharding
from repro_torch.train import optimizer as topt

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SMOKE = "qwen1.5-0.5b-smoke"
SMOKE_SHAPE = ShapeConfig("smoke_train", 32, 4, "train")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(p) -> tuple:
    return tuple(p)


def _jax_paths(tree):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: out.__setitem__(jsh._path_str(p), tuple(leaf.shape)), tree)
    return out


def _port_paths(tree):
    return {path: leaf.shape for path, leaf in sharding.tree_paths(tree)}


@functools.lru_cache(maxsize=None)
def _shapes(name: str):
    """(reference param + AdamW shapes, the port's), as {path: shape}."""
    cfg = jget(name)
    init = jencdec.init if cfg.family == "encdec" else jlm.init
    params = jax.eval_shape(functools.partial(init, cfg=cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    ref = _jax_paths(params)
    ref.update(_jax_paths(jax.eval_shape(jopt.AdamW().init, params)))
    tcfg = get(name)
    shapes = specs.param_shapes(tcfg, "train")
    port = _port_paths(shapes)
    port.update(_port_paths(specs.shapes_of(lambda: topt.AdamW().init(topt.tree_map(
        lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype), shapes)))))
    return ref, port


# ---------------------------------------------------------------------------
# (a) the rules against the reference

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", all_names())
def test_param_specs_equal_the_reference(name, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh, tmesh = AbstractMesh(shape, axes), dict(zip(axes, shape))
    ref, port = _shapes(name)
    assert set(port) == set(ref)
    assert any(p.startswith("m/") for p in port) and any(p.startswith("v/") for p in port)
    for mode in ("train", "serve"):
        for path, shp in ref.items():
            assert tuple(port[path]) == shp, path
            want = _spec(jsh.param_spec(path, shp, jmesh, mode, jget(name)))
            got = sharding.param_spec(path, shp, tmesh, mode, get(name))
            assert got == want, (name, mode, path)
        sharding.placements(got, tmesh)         # every spec maps onto the mesh


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_and_batch_specs_equal_the_reference(mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh, tmesh = AbstractMesh(shape, axes), dict(zip(axes, shape))
    checked = 0
    for name in all_names():
        jcfg, tcfg = jget(name), get(name)
        for shape_name in ("decode_32k", "long_500k"):
            s = JSHAPES[shape_name]
            if shape_name == "long_500k" and not jcfg.sub_quadratic:
                continue
            if jcfg.family == "encdec":
                ref = jax.eval_shape(functools.partial(
                    jencdec.init_cache, jcfg, s.global_batch, s.seq_len, s.seq_len))
                port = specs.shapes_of(lambda: tencdec.init_cache(
                    tcfg, s.global_batch, s.seq_len, s.seq_len, device="cpu"))
            else:
                ref = jax.eval_shape(functools.partial(
                    jlm.init_cache, jcfg, s.global_batch, s.seq_len))
                port = specs.shapes_of(lambda: tlm.init_cache(
                    tcfg, s.global_batch, s.seq_len, device="cpu"))
            ref_paths, port_paths = _jax_paths(ref), _port_paths(port)
            assert set(ref_paths) == set(port_paths), name
            for path, shp in ref_paths.items():
                assert tuple(port_paths[path]) == shp
                assert sharding.cache_spec(path, shp, tcfg, tmesh) == _spec(
                    jsh.cache_spec(path, shp, jcfg, jmesh)), (name, shape_name, path)
                checked += 1
    assert checked > 0
    for batch in (1, 4, 16, 32, 128, 256, 512, 24):
        for extra in (1, 2):
            assert sharding.batch_spec(batch, tmesh, extra) == _spec(
                jsh.batch_spec(batch, jmesh, extra))


def test_placements_split_major_to_minor_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    assert sharding.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    assert sharding.placements(("model",), {"data": 4}) == (Replicate(),)
    assert sharding.placements(("data",), {"data": 1, "model": 1}) == (
        Replicate(), Replicate())
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), mesh)
    assert sharding.local_shape((64, 32), (("pod", "data"), "model"), mesh) == (2, 2)


# ---------------------------------------------------------------------------
# (b) tests/test_runtime.py's rule and constraint tests on the port

def _mesh11():
    return {"data": 1, "model": 1}


def test_param_spec_rules():
    mesh = _mesh11()
    spec = sharding.param_spec("layers/attn/wq/w", (24, 64, 64), mesh, "train")
    assert spec[0] is None  # stacked layer axis never sharded
    spec = sharding.param_spec("m/layers/mlp/w_up", (24, 64, 128), mesh, "train")
    assert len(spec) == 3   # optimizer-state paths match the same rules
    spec = sharding.param_spec("final_norm/scale", (64,), mesh, "train")
    assert spec == (None,)


def test_cache_spec_rules():
    mesh = _mesh11()
    spec = sharding.cache_spec("kv/k", (4, 8, 128, 4, 64), None, mesh)
    assert len(spec) == 5
    spec = sharding.cache_spec("ssm/h", (4, 8, 128, 16), None, mesh)
    assert len(spec) >= 3


def test_constraints_noop_without_mesh():
    x = torch.ones((4, 4))
    assert constraints.context_mesh() is None
    assert constraints.shard(x, "dp", "tp") is x
    assert constraints.like(x, x) is x
    assert constraints.grad_placed(x) is x
    assert constraints.splittable(x, 0, 3) is x
    assert not constraints.axis_divides("dp", 4)
    with constraints.use_mesh({"data": 2, "model": 1}):
        assert constraints.shard(x, "dp", "tp") is x          # a plain tensor
        assert constraints.axis_divides("dp", 4)
        assert not constraints.axis_divides("tp", 4)           # size 1
        assert constraints.spec_for((4, 4, 3), ("dp", "tp", "dp"), {"data": 2}) == (
            "data", None, None)
    assert constraints.context_mesh() is None


# ---------------------------------------------------------------------------
# (c) per-card counts

@pytest.fixture(scope="module")
def smoke_cells():
    """The smoke train step counted for real and dry-run on (1, 1) and on a
    data-only mesh of 4 fake ranks."""
    cfg = dataclasses.replace(get(SMOKE), n_layers=2)
    opt = topt.AdamW()
    state = ttrain.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=SMOKE_SHAPE.seq_len,
                          batch=SMOKE_SHAPE.global_batch).batch_at(0, device="cpu")
    real = op_analyzer.analyze(ttrain.make_train_step(cfg, opt), state, batch)
    cells = {ms: dryrun.trace_step(cfg, SMOKE_SHAPE, ms, device="cpu")
             for ms in ((1, 1), (4,))}
    return real, cells


def test_one_card_dry_run_counts_the_real_step(smoke_cells):
    real, cells = smoke_cells
    one = cells[(1, 1)]
    assert one["hlo"]["flops"] == real.flops
    assert one["hlo"]["bytes"] == real.bytes
    assert one["memory"]["peak_bytes"] == real.peak_bytes
    assert one["hlo"]["collective_bytes"] == 0 and one["hlo"]["collectives"] == {}
    assert not dist.is_initialized()


def test_data_axis_divides_flops_and_shows_gradient_reductions(smoke_cells):
    real, cells = smoke_cells
    four = cells[(4,)]
    assert four["hlo"]["flops"] == pytest.approx(real.flops / 4, rel=0.01)
    assert four["hlo"]["collective_bytes"] > 0
    assert {"reduce_scatter_tensor", "all_reduce"} <= set(four["hlo"]["collectives"])
    assert four["memory"]["peak_bytes"] < cells[(1, 1)]["memory"]["peak_bytes"]
    assert four["n_chips"] == 4 and four["mesh"] == {"data": 4}


def test_peak_bytes_counted_by_hand():
    x = torch.zeros(1000)             # 4000 B, the argument, live throughout

    def f(x):
        a = x * 2                     # 8000 B live
        b = a + 1                     # 12000 B
        del a                         # 8000 B
        d = torch.cat([b, b])         # 16000 B: the peak
        del b                         # 12000 B
        return d.sum()                # 12004 B

    m = op_analyzer.analyze(f, x)
    assert m.peak_bytes == 16000
    assert m.flops == 0 and m.collective_bytes == 0


@contextlib.contextmanager
def _one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_apply_on_a_one_rank_context_mesh_gives_the_same_logits():
    from repro_torch.launch import mesh as mesh_lib

    cfg = dataclasses.replace(get(SMOKE), n_layers=2)
    params = tlm.init(cfg, torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(2))
    want = tlm.apply(params, tokens, cfg)
    with _one_rank_group():
        mesh = mesh_lib.make_device_mesh((1, 1), ("data", "model"), device="cpu")
        dparams = sharding.param_shardings(params, mesh, "serve", cfg)
        dtokens = sharding.distribute(tokens, sharding.batch_spec(2, mesh), mesh)
        with constraints.use_mesh(mesh):
            got = tlm.apply(dparams, dtokens, cfg)
        got = got.full_tensor()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (d) the private LM's MPC cell

def _reference_lm_mpc_cell(budget: str) -> dict:
    from repro.api.plan import LAN, WAN
    from repro.core.hummingbird import HBConfig, HBLayer

    acfg = jget(SMOKE)
    params = jax.eval_shape(functools.partial(jlm.init, cfg=acfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    plan = jlm.trace(params, acfg, 1, 32)
    if budget != "baseline":
        k, m = (21, 0) if budget == "eco" else (21, 13)
        hb = HBConfig(tuple(HBLayer(k=k, m=m) for _ in range(plan.hb.n_groups)),
                      plan.hb.group_elements)
        plan = jlm.trace(params, acfg, 1, 32, hb=hb)
    sched = plan.schedule()
    return {"n_relu_calls": len(plan.calls), "n_opens": len(plan.opens),
            "rounds": sched.n_rounds, "bytes_tx": sched.bytes_tx,
            "budget_fraction": plan.hb.budget_fraction(),
            "latency_lan_s": sched.latency(LAN.bandwidth_bps, LAN.rtt_s),
            "latency_wan_s": sched.latency(WAN.bandwidth_bps, WAN.rtt_s)}


@pytest.mark.parametrize("budget,rounds,nbytes", [
    ("baseline", 92, 138739712), ("eco", 84, 52047872), ("8of64", 68, 26771456)])
def test_lm_mpc_cell_equals_the_reference(budget, rounds, nbytes):
    out = dryrun.run_lm_mpc_cell(get(SMOKE), budget)
    assert out["status"] == "ok" and out["arch"] == f"{SMOKE}-mpc-lm-{budget}"
    assert out["lm"] == _reference_lm_mpc_cell(budget)
    assert (out["lm"]["rounds"], out["lm"]["bytes_tx"]) == (rounds, nbytes)
    assert (out["lm"]["n_relu_calls"], out["lm"]["n_opens"]) == (8, 12)


# ---------------------------------------------------------------------------
# (e) the MPC step's input specs

def _dims(spec, axis):
    return [i for i, s in enumerate(spec) if s == axis]


def _ref_leaf(x):
    return x.lo if hasattr(x, "lo") else x


def _compare_triples(port, ref):
    assert len(port) == len(ref)
    checked = 0
    for pb, rb in zip(port, ref):
        assert (pb is None) == (rb is None)
        if pb is None:
            continue
        pairs = [(pb.bin_init, rb.bin_init), (pb.b2a, rb.b2a), (pb.mult, rb.mult)]
        if isinstance(pb.bin_levels, tuple):
            pairs += list(zip(pb.bin_levels, rb.bin_levels))
        else:
            pairs.append((pb.bin_levels, rb.bin_levels))
        for pt, rt in pairs:
            for f in ("a", "b", "c"):
                p, r = getattr(pt, f), _ref_leaf(getattr(rt, f))
                assert p.shape == tuple(r.shape)
                for axis in ("party", "data"):
                    assert _dims(p.spec, axis) == _dims(tuple(r.sharding.spec), axis)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("which", ["smoke", "resnet18"])
def test_mpc_input_specs_equal_the_reference(which):
    from repro.configs import RESNET18 as J18, RESNET_SMOKE as JSMOKE
    from repro.launch import serve as jserve
    from repro.launch.mesh import make_mpc_smoke_mesh

    if which == "smoke":
        jcfg, tcfg, batch, jmesh = JSMOKE, RESNET_SMOKE, 2, make_mpc_smoke_mesh()
        tmesh = {"party": 1, "data": 1}
    else:
        jcfg, tcfg, batch = J18, RESNET18, 512
        jmesh, tmesh = AbstractMesh((2, 256), ("party", "data")), {"party": 2, "data": 256}
    for cone in (False, True):
        jp, lo, hi, jt, jk = jserve.mpc_input_specs(jcfg, batch, jmesh, None, cone=cone)
        tp, x, tt, tk = serve.mpc_input_specs(tcfg, batch, tmesh, None, cone=cone)
        assert x.shape == tuple(lo.shape) == tuple(hi.shape)
        assert x.dtype == torch.int64
        for axis in ("party", "data"):
            assert _dims(x.spec, axis) == _dims(tuple(lo.sharding.spec), axis)
        assert x.block == tuple(d // (tmesh[a] if a else 1) for d, a in zip(x.shape, x.spec))
        jleaves = jax.tree_util.tree_leaves(jp)
        tleaves = [leaf for _, leaf in sharding.tree_paths(tp)]
        assert sorted(tuple(j.shape) for j in jleaves) == sorted(t.shape for t in tleaves)
        assert all(set(t.spec) == {None} for t in tleaves)
        _compare_triples(tt, jt)
        assert tk.shape == tuple(jk.shape) and set(tk.spec) == {None}


# ---------------------------------------------------------------------------
# (f) the tables

def test_tables_from_smoke_cells(smoke_cells, tmp_path):
    _, cells = smoke_cells
    cell = dict(cells[(4,)], arch=SMOKE, shape=SMOKE_SHAPE.name, multi_pod=False,
                status="ok")
    (tmp_path / "smoke.json").write_text(json.dumps(cell))
    lm_cell = dryrun.run_lm_mpc_cell(get(SMOKE), "8of64")
    (tmp_path / "lm.json").write_text(json.dumps(lm_cell))
    (tmp_path / "err.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "multi_pod": True, "status": "error",
         "error": "RuntimeError: why"}))
    loaded = make_experiments.load(tmp_path)
    d = next(c for c in loaded if c["_file"] == "smoke")
    r = d["roofline"]
    want = (r["model_flops_global"] / 4 / roofline.PEAK_FLOPS) / r["step_time_bound_s"]
    assert make_experiments.PEAK == roofline.PEAK_FLOPS
    assert make_experiments.mfu(d) == pytest.approx(want)
    table = make_experiments.roofline_table(loaded)
    assert SMOKE in table and make_experiments._fmt(want, 4) in table
    assert "error (RuntimeError: why)" in make_experiments.dryrun_table(loaded, True)
    assert "| 8of64 | 68 |" in make_experiments.lm_mpc_table(loaded)
    row = next(line for line in make_experiments.summary_table(loaded).splitlines()
               if line.startswith(f"| {SMOKE} |"))
    assert f"MFU {make_experiments._fmt(want, 2)}" in row and row.endswith("| - |")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        make_experiments.main(["--results", str(tmp_path)])
        report.main(["--results", str(tmp_path)])
    text = out.getvalue()
    assert "Single-pod" in text and "MPC private LM" in text and SMOKE in text


# ---------------------------------------------------------------------------
# (g) the train step reads nothing back to the host

def test_train_step_runs_under_fake_tensor_mode():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    cfg = dataclasses.replace(get(SMOKE), n_layers=2)
    opt = topt.AdamW(schedule=topt.Schedule(peak_lr=1e-3, warmup_steps=5, decay_steps=50))
    with FakeTensorMode():
        state = ttrain.init_state(cfg, opt, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((2, 16), dtype=torch.int64),
                 "labels": torch.zeros((2, 16), dtype=torch.int64)}
        new, metrics = ttrain.make_train_step(cfg, opt)(state, batch)
        for x in (metrics["loss"], metrics["lr"], metrics["gnorm"], new.step):
            assert isinstance(x, FakeTensor)
        with pytest.raises(Exception):
            float(metrics["lr"])                 # a host read would raise
        af = topt.Adafactor()
        state = ttrain.init_state(cfg, af, torch.Generator().manual_seed(0))
        ttrain.make_train_step(cfg, af)(state, batch)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 30, 49, 50, 80, 20000])
def test_lr_and_bias_corrections_equal_the_reference(step):
    for kw in ({}, dict(peak_lr=1e-2, warmup_steps=5, decay_steps=50),
               dict(peak_lr=3e-3, warmup_steps=0, decay_steps=0)):
        jlr = np.asarray(jopt.Schedule(**kw)(jnp.asarray(step, jnp.int32)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            lr = topt.Schedule(**kw)(s)
            assert lr.dtype == torch.float32 and lr.ndim == 0
            np.testing.assert_allclose(lr.numpy(), jlr, rtol=2e-7)
    t_j = jnp.asarray(step, jnp.int32).astype(jnp.float32) + 1.0
    t_t = topt._step_f32(torch.tensor(step, dtype=torch.int32)) + 1.0
    for b in (0.9, 0.95):
        np.testing.assert_array_equal((1 - topt._pow_f32(b, t_t)).numpy(),
                                      np.asarray(1 - b ** t_j))
    np.testing.assert_array_equal((1.0 - t_t ** (-0.8)).numpy(),
                                  np.asarray(1.0 - t_j ** (-0.8)))


def test_dry_run_modules_import_neither_jax_nor_the_reference():
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for sub in ("runtime/sharding.py", "runtime/constraints.py", "launch/specs.py",
                "launch/dryrun.py", "launch/report.py", "launch/make_experiments.py",
                "launch/mesh.py", "launch/serve.py", "runtime/op_analyzer.py"):
        tree = ast.parse((root / sub).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")], sub


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        dryrun.main(["--mpc", "--mpc-arch", SMOKE])
    with pytest.raises(RuntimeError, match="no GPU"):
        dryrun.trace_step(get(SMOKE), SMOKE_SHAPE, (1, 1))
    assert not dist.is_initialized()


def test_vocab_parallel_nll_equals_log_softmax_and_its_gradient():
    """The vocab-split loss on a one-rank mesh whose one dim "splits" the
    vocab (a block of the whole of it): values and gradients equal the
    plain log-softmax and gather's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import mesh as mesh_lib

    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((2, 6, 40), generator=gen, dtype=torch.float32)
    labels = torch.randint(0, 40, (2, 6), generator=gen)
    labels[0, 3] = -1                            # a masked position
    ref = logits.clone().requires_grad_(True)
    want = -torch.gather(torch.log_softmax(ref, -1), -1,
                         labels.clamp_min(0)[..., None])[..., 0]
    want = torch.where(labels >= 0, want, torch.logsumexp(ref, -1))
    want.sum().backward()
    with _one_rank_group():
        mesh = mesh_lib.make_device_mesh((1,), ("model",), device="cpu")
        leaf = logits.clone().requires_grad_(True)
        dl = DTensor.from_local(leaf, mesh, [Shard(2)], run_check=False)
        dlab = DTensor.from_local(labels, mesh, [Replicate()], run_check=False)
        assert constraints.vocab_split(dl)
        got = constraints.vocab_parallel_nll(dl, dlab)
        got.sum().backward()
        got = got.full_tensor()
    # float32 sums in another order than log_softmax's
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=1e-6, atol=1e-6)
