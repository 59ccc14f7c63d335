"""The port's training path against the reference's, on the CPU at the smoke
width (d_model 64, 2 layers, float32):

- ``TokenPipeline`` batches equal the reference's exactly at several steps;
- ``AdamW``, ``Adafactor`` and ``SGD`` updates on the same tree equal the
  reference's within 1e-6 relative over three steps, and the port mirrors
  ``tests/test_nn.py``'s optimizer tests;
- one train step's loss within 1e-5 and every gradient within 1e-4 of the
  reference's for ``qwen1.5-0.5b``, ``mixtral-8x22b`` (with the router
  aux loss), ``falcon-mamba-7b`` and ``seamless-m4t-medium`` (``-smoke``,
  2 layers), the reference's ``init`` carried across;
- ``state_from_jax``: the reference takes three AdamW steps and the port
  continues with the fourth, against the reference's fourth;
- microbatched equals plain; remat "dots", "dots_all" and "full" give the
  gradients of "none", and each recomputes exactly the matmuls its policy
  does not save;
- all ten architectures take one finite step that moves the params
  (``tests/test_archs_smoke.py``'s ``test_one_train_step``);
- port-only mirrors of ``tests/test_fault_tolerance.py``'s training cases
  (``tests/test_torch_checkpoint.py`` mirrors the store's): determinism by
  step, failure and restart, restart equal to the uninterrupted run bit for
  bit, elastic restore onto a device, the straggler hook.

Each architecture's reference run (its init and its loss and gradient, or
its four steps) is one jitted program compiled at XLA backend level 0,
built once per module.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import all_names, get as jget
from repro.data import TokenPipeline as JPipeline
from repro.launch import train as jtrain
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.train import loop as loop_lib, optimizer as topt

B, S = 2, 16                    # the gradient tests' batch
GRAD_ARCHS = ("qwen1.5-0.5b", "mixtral-8x22b", "falcon-mamba-7b",
              "seamless-m4t-medium")
# float32 through 2 layers, sums in other orders than XLA's (seen <= 5e-6)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
OPT_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref(fn, *args):
    """``fn(*args)`` as one jitted program at XLA backend level 0, as numpy."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": "0"})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _cfgs(name: str, **kw):
    """(reference, port) ``-smoke`` configs at 2 layers."""
    return (dataclasses.replace(jget(name + "-smoke"), n_layers=2, **kw),
            dataclasses.replace(configs.get(name + "-smoke"), n_layers=2, **kw))


def _flat(tree):
    """Leaves in the reference's pytree order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _batches(cfg, b: int, s: int, step: int = 0):
    """The same batch for both packages: the pipelines' tokens and labels,
    seeded numpy source frames for enc-dec."""
    jb = dict(JPipeline(cfg.vocab, s, b).batch_at(step))
    tb = TokenPipeline(cfg.vocab, s, b).batch_at(step, device="cpu")
    if cfg.family == "encdec":
        src = np.random.default_rng(step).normal(size=(b, s, cfg.d_model)).astype(np.float32)
        jb["src_embeds"], tb["src_embeds"] = jnp.asarray(src), torch.from_numpy(src)
    return jb, tb


# ---------------------------------------------------------------------------
# Data and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(97, 16, 4, 3), (151936, 64, 2, 0),
                                                  (1024, 33, 3, 1)])
def test_token_pipeline_equals_reference(vocab, seq, batch, seed):
    ref, port = JPipeline(vocab, seq, batch, seed), TokenPipeline(vocab, seq, batch, seed)
    for step in (0, 11, 12, 123456):
        want, got = ref.batch_at(step), port.batch_at(step, device="cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _opt_tree(rng):
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "s": {"x": rng.normal(size=(2, 3, 5)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.0, "clip_norm": 0.1}),
    ("adafactor", {}), ("sgd", {"weight_decay": 0.01}),
    ("adamw", {"schedule": "warm"}), ("adafactor", {"schedule": "warm"})])
def test_optimizer_updates_equal_reference(name, kw):
    """Three steps on the same tree and gradients (changing each step), the
    step given as a 0-d tensor and as an int."""
    if kw.get("schedule") == "warm":
        kw = {"schedule": dict(peak_lr=0.05, warmup_steps=2, decay_steps=10)}
    jkw = {k: (jopt.Schedule(**v) if k == "schedule" else v) for k, v in kw.items()}
    tkw = {k: (topt.Schedule(**v) if k == "schedule" else v) for k, v in kw.items()}
    jo, to = jopt.get(name, **jkw), topt.get(name, **tkw)
    rng = np.random.default_rng(0)
    p = _opt_tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = topt.tree_map(torch.from_numpy, p)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: (a * (0.3 - step) + 0.01).astype(np.float32),
                                   _opt_tree(rng))
        jp, js, _ = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                              jnp.asarray(step, jnp.int32))
        tstep = torch.tensor(step, dtype=torch.int32) if step % 2 else step
        tp, ts, _ = to.update(topt.tree_map(torch.from_numpy, g), ts, tp, tstep)
    for want, got in ((jp, tp), (js, ts)):
        for a, b in zip(jax.tree_util.tree_leaves(want), _flat(got)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=OPT_RTOL, atol=1e-30)


def test_adamw_against_manual_reference():
    """``tests/test_nn.py``'s manual first AdamW step, on the port."""
    opt = topt.AdamW(schedule=topt.Schedule(peak_lr=0.1, warmup_steps=1, decay_steps=0),
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, clip_norm=1e9)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    p2, _, _ = opt.update(g, opt.init(p), p, torch.zeros((), dtype=torch.int32))
    expect = p["w"].numpy() - 0.1 * g["w"].numpy() / (np.abs(g["w"].numpy()) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-5)


def test_adafactor_and_sgd_smoke():
    """``tests/test_nn.py``'s smoke of the other two, on the port; Adafactor's
    state is factored for the matrix only."""
    p = {"w": torch.ones((8, 4)), "b": torch.zeros((4,))}
    g = topt.tree_map(lambda x: torch.ones_like(x) * 0.1, p)
    for opt in (topt.Adafactor(), topt.SGD()):
        p2, st2, _ = opt.update(g, opt.init(p), p, 0)
        assert torch.isfinite(p2["w"]).all()
        assert float((p2["w"] - p["w"]).abs().sum()) > 0
    f = topt.Adafactor().init(p)["f"]
    assert set(f["w"]) == {"row", "col"} and f["w"]["row"].shape == (8,)
    assert set(f["b"]) == {"v"}


# ---------------------------------------------------------------------------
# One step against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grad_runs():
    """Per architecture: the reference's init, batch, loss and gradients."""
    out = {}
    for name in GRAD_ARCHS:
        jcfg, tcfg = _cfgs(name)
        jb, tb = _batches(jcfg, B, S)

        def prog(key, batch, jcfg=jcfg):
            params = jtrain.init_state(key, jcfg, jopt.SGD()).params
            loss, grads = jax.value_and_grad(jtrain.loss_fn)(params, batch, jcfg)
            return params, loss, grads

        params, loss, grads = _ref(prog, jax.random.PRNGKey(0), jb)
        out[name] = (tcfg, params, tb, float(loss), grads)
    return out


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_train_step_loss_and_gradients_equal_reference(grad_runs, name):
    tcfg, params, tb, want_loss, want_grads = grad_runs[name]
    tparams = topt.tree_map(lambda p: p.requires_grad_(True),
                            tlm.params_from_jax(params, "cpu"))
    loss, grads = ttrain.value_and_grad(tparams, tb, tcfg)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    got = _flat(ttrain._rebuild(tparams, grads))
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL)
    if name == "mixtral-8x22b":     # the aux loss is large enough to show
        with torch.no_grad():
            aux = ttrain._moe_aux(ttrain._compute_params(tparams, tcfg), tb, tcfg)
        assert 0.01 * float(aux) > 100 * LOSS_TOL


@pytest.fixture(scope="module")
def four_steps():
    """The reference's init and four AdamW steps (batches 0-3) on the qwen
    smoke model: the state after three and after four."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    opt = jopt.AdamW(schedule=jopt.Schedule(peak_lr=1e-2, warmup_steps=1, decay_steps=0))
    pipe = JPipeline(jcfg.vocab, S, B)

    def prog(key):
        state = jtrain.init_state(key, jcfg, opt)
        step = jtrain.make_train_step(jcfg, opt)
        for i in range(3):
            state, _ = step(state, pipe.batch_at(i))
        last, metrics = step(state, pipe.batch_at(3))
        return state, last, metrics["loss"]

    s3, s4, loss4 = _ref(prog, jax.random.PRNGKey(0))
    return tcfg, s3, s4, float(loss4)


def test_state_from_jax_continues_the_reference(four_steps):
    """The reference's state after 3 steps carried across; the port's 4th
    step gives the reference's 4th: loss, params, both moments."""
    tcfg, s3, s4, loss4 = four_steps
    state = ttrain.state_from_jax(s3, "cpu")
    assert int(state.step) == 3 and state.step.device.type == "cpu"
    opt = topt.AdamW(schedule=topt.Schedule(peak_lr=1e-2, warmup_steps=1, decay_steps=0))
    batch = TokenPipeline(tcfg.vocab, S, B).batch_at(3, device="cpu")
    new, metrics = ttrain.make_train_step(tcfg, opt)(state, batch)
    assert abs(float(metrics["loss"]) - loss4) <= LOSS_TOL
    assert int(new.step) == 4
    for got, want in ((new.params, s4.params), (new.opt_state, s4.opt_state)):
        for g, w in zip(_flat(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL)


# ---------------------------------------------------------------------------
# Port only: microbatches, remat, every architecture
# ---------------------------------------------------------------------------

def test_microbatched_step_equals_reference_and_plain():
    """Two microbatches of SGD (no momentum) on the qwen smoke model: the
    port's step against the reference's two-microbatch step (loss and
    params), and against its own one-batch step (``tests/test_system.py``'s
    tolerances; ``tests/test_torch_system.py`` repeats that test as it is)."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", remat="none")
    sched = dict(peak_lr=0.1, warmup_steps=0, decay_steps=0)
    jo = jopt.SGD(schedule=jopt.Schedule(**sched), momentum=0.0)
    to = topt.SGD(schedule=topt.Schedule(**sched), momentum=0.0)
    jb, tb = _batches(jcfg, 4, S)

    def prog(key, batch):
        state = jtrain.init_state(key, jcfg, jo)
        new, metrics = jtrain.make_train_step(jcfg, jo, n_microbatches=2)(state, batch)
        return state, new, metrics["loss"]

    s0, s1, loss = _ref(prog, jax.random.PRNGKey(0), jb)
    state = ttrain.state_from_jax(s0, "cpu")
    got, metrics = ttrain.make_train_step(tcfg, to, n_microbatches=2)(state, tb)
    assert abs(float(metrics["loss"]) - float(loss)) <= LOSS_TOL
    for g, w in zip(_flat(got.params), jax.tree_util.tree_leaves(s1.params)):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL)
    plain, m1 = ttrain.make_train_step(tcfg, to, n_microbatches=1)(state, tb)
    np.testing.assert_allclose(float(m1["loss"]), float(metrics["loss"]), rtol=1e-4)
    for a, b in zip(topt.tree_leaves(plain.params), topt.tree_leaves(got.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-3)


class _CountMatmuls(TorchDispatchMode):
    """bmm/mm dispatches, by whether the product has a batch extent > 1."""

    def __init__(self):
        super().__init__()
        self.n = {"unbatched": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default):
            batched = func is torch.ops.aten.bmm.default and args[0].shape[0] > 1
            self.n["batched" if batched else "unbatched"] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_give_the_gradients_of_none_and_save_their_dots():
    """Every policy's gradients equal "none"'s bit for bit.  In the
    backward, "dots_all" recomputes no matmul, "dots" only the attention's
    batched QK^T and PV (its projections saved), "full" those and the
    projections; under no_grad every mode is the serving forward."""
    base = dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=2)
    batch = TokenPipeline(base.vocab, 16, 2).batch_at(0, device="cpu")
    state = ttrain.init_state(base, topt.SGD(), torch.Generator().manual_seed(0))
    counts, grads = {}, {}
    for mode in ("none", "dots_all", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        params = topt.tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        loss = ttrain.loss_fn(params, batch, cfg)
        counter = _CountMatmuls()
        with counter:
            grads[mode] = torch.autograd.grad(loss, topt.tree_leaves(params))
        counts[mode] = counter.n
        with torch.no_grad():
            logits = tlm.apply(state.params, batch["tokens"], cfg)
        if mode == "none":
            serving = logits
        assert torch.equal(logits, serving)
    for mode in ("dots_all", "dots", "full"):
        assert all(torch.equal(a, b) for a, b in zip(grads[mode], grads["none"])), mode
    none = counts["none"]
    assert counts["dots_all"] == none
    # per layer: QK^T and PV (one query chunk at 16 tokens) recomputed
    assert counts["dots"] == {"unbatched": none["unbatched"],
                              "batched": none["batched"] + 2 * base.n_layers}
    assert counts["full"]["batched"] == counts["dots"]["batched"]
    assert counts["full"]["unbatched"] > none["unbatched"]
    with pytest.raises(ValueError, match="remat"):
        tlm.apply(state.params, batch["tokens"], dataclasses.replace(base, remat="some"))


def _arch_inputs(cfg, gen):
    """``tests/test_archs_smoke.py``'s inputs: 2 x 32 positions, stub frontend
    tokens first for the VLM, source frames for enc-dec."""
    n, s_tok, fe = 2, 32, None
    if cfg.frontend != "none":
        fe = torch.randn((n, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
        s_tok = 32 - cfg.n_frontend_tokens
    tokens = torch.randint(0, cfg.vocab, (n, s_tok), generator=gen)
    batch = {"tokens": tokens, "labels": ttrain.shift_labels(
        tokens, pad_prefix=cfg.n_frontend_tokens if fe is not None else 0)}
    if fe is not None:
        batch["frontend"] = fe
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn((n, 32, cfg.d_model), generator=gen)
    return batch


@pytest.mark.parametrize("name", all_names())
def test_one_train_step(name):
    cfg = dataclasses.replace(configs.get(name + "-smoke"), n_layers=2)
    opt = topt.AdamW(schedule=topt.Schedule(peak_lr=1e-3, decay_steps=0))
    state = ttrain.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batch = _arch_inputs(cfg, torch.Generator().manual_seed(1))
    state2, metrics = ttrain.make_train_step(cfg, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.step) == 1
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(topt.tree_leaves(state2.params), topt.tree_leaves(state.params)))
    assert delta > 0


def test_shift_labels_equals_reference():
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6)
    for pad in (0, 3):
        want = np.asarray(jtrain.shift_labels(jnp.asarray(tokens), pad_prefix=pad))
        got = ttrain.shift_labels(torch.from_numpy(tokens), pad_prefix=pad)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's training cases, on the port
# ---------------------------------------------------------------------------

@pytest.fixture()
def small_cfg():
    return dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=2)


def test_data_pipeline_deterministic_by_step():
    pipe = TokenPipeline(vocab=97, seq_len=16, batch=4, seed=3)
    b1, b2 = pipe.batch_at(11, device="cpu"), pipe.batch_at(11, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], pipe.batch_at(12, device="cpu")["tokens"])


def test_failure_restart_resumes_exactly(small_cfg, tmp_path):
    pipe = TokenPipeline(vocab=small_cfg.vocab, seq_len=32, batch=4)
    lc = loop_lib.LoopConfig(total_steps=10, ckpt_every=4, ckpt_dir=str(tmp_path),
                             async_ckpt=False)
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        loop_lib.run(small_cfg, pipe, lc, hooks={"fail_at": 6}, device="cpu")
    assert store.latest_step(str(tmp_path)) == 4
    rep = loop_lib.run(small_cfg, pipe, lc, device="cpu")
    assert rep.resumed_from == 4
    assert rep.final_step == 10 and len(rep.losses) == 6
    assert np.isfinite(rep.losses).all()


def test_restart_equals_uninterrupted(small_cfg, tmp_path):
    """Bitwise-equal params and moments: 8 straight against fail-resume,
    the second with the async checkpointer."""
    pipe = TokenPipeline(vocab=small_cfg.vocab, seq_len=32, batch=4)
    opt = topt.AdamW()
    d1, d2 = tmp_path / "a", tmp_path / "b"
    lc1 = loop_lib.LoopConfig(total_steps=8, ckpt_every=100, ckpt_dir=str(d1),
                              async_ckpt=False)
    loop_lib.run(small_cfg, pipe, lc1, optimizer=opt, device="cpu")
    s1, _ = loop_lib.elastic_restore(str(d1), small_cfg, opt, device="cpu")
    lc2 = loop_lib.LoopConfig(total_steps=8, ckpt_every=4, ckpt_dir=str(d2))
    with pytest.raises(RuntimeError):
        loop_lib.run(small_cfg, pipe, lc2, optimizer=opt, hooks={"fail_at": 6},
                     device="cpu")
    rep = loop_lib.run(small_cfg, pipe, lc2, optimizer=opt, device="cpu")
    assert rep.resumed_from == 4
    s2, manifest = store.restore(str(d2), s1)
    assert manifest["extra"] == {"final": True} and int(s2.step) == 8
    for tree in ("params", "opt_state"):
        for a, b in zip(topt.tree_leaves(getattr(s1, tree)),
                        topt.tree_leaves(getattr(s2, tree))):
            assert torch.equal(a, b)


def test_elastic_restore_onto_device(small_cfg, tmp_path):
    """The latest checkpoint onto a named device (the port's form beside
    the reference's mesh form, below), every leaf of the config's shape
    and dtype, the step on the host; a checkpoint of another config
    refuses."""
    pipe = TokenPipeline(vocab=small_cfg.vocab, seq_len=32, batch=4)
    lc = loop_lib.LoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                             async_ckpt=False)
    loop_lib.run(small_cfg, pipe, lc, device="cpu")
    state, manifest = loop_lib.elastic_restore(str(tmp_path), small_cfg, topt.AdamW(),
                                               device="cpu")
    assert int(state.step) == 4 and manifest["step"] == 4
    leaves = topt.tree_leaves(state.params) + topt.tree_leaves(state.opt_state)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in leaves)
    assert manifest["paths"][0] == ".params/embed/table"
    wider = dataclasses.replace(small_cfg, d_model=2 * small_cfg.d_model)
    with pytest.raises(ValueError, match="checkpoint leaf"):
        loop_lib.elastic_restore(str(tmp_path), wider, topt.AdamW(), device="cpu")


@pytest.mark.parametrize("group", ["gloo-1", "fake-2x2"])
def test_elastic_restore_on_named_mesh(small_cfg, tmp_path, group):
    """tests/test_fault_tolerance.py's mesh restore: the latest checkpoint
    onto a (data, model) ``DeviceMesh``, every params and optimizer-state
    leaf a DTensor whose placements are ``sharding.placements`` of the
    rules' spec for "train", its values bit-equal to the device restore's
    (on one gloo rank the whole leaf; on rank 0 of a fake 2 x 2 group,
    where the rules split leaves over both axes, rank 0's block)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import sharding

    pipe = TokenPipeline(vocab=small_cfg.vocab, seq_len=32, batch=4)
    lc = loop_lib.LoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                             async_ckpt=False)
    loop_lib.run(small_cfg, pipe, lc, device="cpu")
    opt = topt.AdamW()
    want, _ = loop_lib.elastic_restore(str(tmp_path), small_cfg, opt, device="cpu")
    if group == "gloo-1":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        shape = (1, 1)
    else:
        mesh_lib.fake_process_group(4)
        shape = (2, 2)
    try:
        mesh = mesh_lib.make_device_mesh(shape, ("data", "model"), device="cpu")
        state, manifest = loop_lib.elastic_restore(str(tmp_path), small_cfg, opt,
                                                   mesh=mesh)
        assert int(state.step) == 4 and manifest["step"] == 4
        split = 0
        for tree in ("params", "opt_state"):
            got = dict(sharding.tree_paths(getattr(state, tree)))
            ref = dict(sharding.tree_paths(getattr(want, tree)))
            assert got.keys() == ref.keys()
            for path, dt in got.items():
                whole = ref[path]
                spec = sharding.param_spec(path, tuple(whole.shape), mesh, "train",
                                           small_cfg)
                assert isinstance(dt, DTensor) and dt.device_mesh is mesh
                assert tuple(dt.placements) == sharding.placements(spec, mesh)
                assert dt.shape == whole.shape and dt.dtype == whole.dtype
                block = whole
                for i, p in enumerate(dt.placements):
                    if isinstance(p, Shard):
                        split += 1
                        block = block.narrow(p.dim, 0, block.shape[p.dim] // shape[i])
                if group == "gloo-1":
                    assert torch.equal(dt.full_tensor(), whole)
                assert torch.equal(dt.to_local(), block)
        assert split > 0 if group == "fake-2x2" else split == 0
    finally:
        dist.destroy_process_group()


def test_straggler_watchdog(small_cfg):
    base = TokenPipeline(vocab=small_cfg.vocab, seq_len=32, batch=4)
    seen = []

    class SlowPipe:
        def batch_at(self, step, device=None):
            if step == 8:
                time.sleep(2.0)  # injected straggler inside the timed window
            return base.batch_at(step, device=device)

    lc = loop_lib.LoopConfig(total_steps=10, ckpt_dir=None, straggler_factor=3.0)
    rep = loop_lib.run(small_cfg, SlowPipe(), lc, device="cpu",
                       hooks={"on_straggler": lambda s, dt, e: seen.append(s)})
    assert rep.final_step == 10
    assert 8 in seen and 8 in rep.straggler_steps


def test_loop_seed_gives_the_init_and_no_gpu_without_a_card(small_cfg):
    """``LoopConfig.seed`` seeds the init's generator: two runs agree, a
    third with another seed does not; the default device is the GPU."""
    pipe = TokenPipeline(vocab=small_cfg.vocab, seq_len=16, batch=2)
    runs = [loop_lib.run(small_cfg, pipe, loop_lib.LoopConfig(total_steps=2, seed=s),
                         device="cpu").losses for s in (5, 5, 6)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            loop_lib.run(small_cfg, pipe, loop_lib.LoopConfig(total_steps=1))
        with pytest.raises(RuntimeError, match="no GPU"):
            pipe.batch_at(0)
        with pytest.raises(RuntimeError, match="no GPU"):
            loop_lib.elastic_restore("unused", small_cfg, topt.AdamW())


def test_train_lm_tool_resumes_on_the_cpu(tmp_path, capsys):
    """``tools/train_lm.py`` (``examples/train_lm.py``'s twin) trains on the
    CPU, checkpoints, and a second call with more steps resumes."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "train_lm.py"
    spec = importlib.util.spec_from_file_location("train_lm_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = ["--layers", "1", "--d-model", "64", "--seq", "16", "--batch", "2",
            "--device", "cpu", "--ckpt", str(tmp_path)]
    first = tool.main(["--steps", "3"] + args)
    assert first.resumed_from is None and len(first.losses) == 3
    again = tool.main(["--steps", "5"] + args)
    assert again.resumed_from == 3 and len(again.losses) == 2
    assert "resumed from 3" in capsys.readouterr().out
