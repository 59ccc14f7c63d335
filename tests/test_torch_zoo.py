"""The port's plaintext model zoo against the reference's, on the CPU at the
smoke width (d_model 64, 4 heads of 16, at most 4 layers, float32):

- all ten ``-smoke`` architectures, the reference's ``init`` carried across
  by ``params_from_jax``, the same numpy tokens (and stub frontend
  embeddings): ``apply`` on the prompt and one more token, ``prefill`` of
  the prompt (last logits and the cache), one ``decode_step`` from the
  reference's cache (logits and cache) and an 8-step
  ``greedy_decode_loop`` from the port's own; float32 logits within
  ``ATOL``/``RTOL``, bfloat16 cache leaves within one bfloat16 ulp (or
  ``ATOL`` near 0), the SSM states within ``ATOL``/``RTOL``, greedy tokens
  equal;
- ``init`` builds the reference's tree (keys, shapes, dtypes) for every
  family;
- the mirrors of ``tests/test_nn.py`` (flash vs naive attention, softcap,
  MoE at full capacity equals the dense mixture, capacity drops, mamba1
  chunked vs one chunk, mamba2 decode vs the full scan) and of
  ``tests/test_archs_smoke.py``'s decode-vs-full-forward tests, each on
  the port and against the reference from the same inputs;
- one test per trap of the translation: jax's gelu is the tanh form,
  ``lax.top_k`` breaks ties to the lower index, the log-depth scan at
  chunks that are not powers of two, and a cache write past ``max_len``
  raising where the reference's ``dynamic_update_slice`` clamps.

Each architecture's reference run (its init and every output) is one
jitted program (XLA backend level 0), compiled and run once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import encdec as jencdec, lm as jlm
from repro.nn import attention as jattn, moe as jmoe, ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as tencdec, lm as tlm
from repro_torch.nn import attention as tattn, common as tcommon, moe as tmoe, \
    ssm as tssm

B, S, STEPS = 2, 32, 8          # the reference smoke tests' batch and length
MAX_LEN = S + STEPS
NEXT = 7                        # the token decoded after the prompt
# float32 through at most 4 layers; the port's matmuls, softmaxes and the
# SSM's log-depth scan sum in other orders than XLA's (errors seen: <= 3e-5)
ATOL, RTOL = 1e-4, 1e-4
NAMES = jconfigs.all_names()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref(fn, *args):
    """``fn(*args)`` as one jitted program at XLA backend level 0 (the
    compile dominates at the smoke width), as numpy."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": "0"})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _within_one_bf16_ulp(got: torch.Tensor, want, what=""):
    """Each element within one bfloat16 ulp (of the larger magnitude), or
    within ATOL: a value near 0 carries its float32 error (about 1e-6)
    into the rounding."""
    want = torch.from_numpy(np.asarray(want, np.float32))
    got = got.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs())
                                            .clamp_min(2.0 ** -126))) - 7)
    assert bool(((got - want).abs() <= torch.clamp_min(ulp, ATOL)).all()), what


def _same_tree(got, want, what):
    """Port tree against the reference's (numpy): bfloat16 leaves within
    one ulp, others within ATOL/RTOL."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), what
    for k in g:
        assert tuple(g[k].shape) == w[k].shape, (what, k)
        if g[k].dtype == torch.bfloat16:
            _within_one_bf16_ulp(g[k], w[k], f"{what}{k}")
        else:
            _close(g[k], w[k], what=f"{what}{k}")


class _Arch:
    """One smoke architecture in both packages: the reference's outputs
    (one jitted program) and the port's, from the same weights and inputs."""

    def __init__(self, name: str):
        self.jcfg = jconfigs.get(name + "-smoke")
        self.tcfg = tconfigs.get(name + "-smoke")
        cfg, rng = self.jcfg, np.random.default_rng(0)
        self.encdec = cfg.family == "encdec"
        if self.encdec:
            self.src = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            self.tgt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        else:
            n_fe = cfg.n_frontend_tokens if cfg.frontend != "none" else 0
            self.fe = (rng.standard_normal((B, n_fe, cfg.d_model)).astype(np.float32)
                       if n_fe else None)
            self.tokens = rng.integers(0, cfg.vocab, (B, S - n_fe)).astype(np.int32)
        self.nxt = np.full((B, 1), NEXT, np.int32)
        self.ref = self._run_ref(jax.random.PRNGKey(0))
        self.jparams = self.ref["params"]
        self.tparams = tlm.params_from_jax(self.jparams, "cpu")
        self.port = self._run_port()

    def _run_ref(self, key):
        """The reference's init and every serving output, one program."""
        cfg, nxt = self.jcfg, self.nxt
        if self.encdec:
            def ref(key, src, tgt):
                params = jencdec.init(key, cfg)
                cache = jencdec.prefill(params, src, cfg, B, MAX_LEN)
                dec = jencdec.decode_step(params, tgt[:, :1], cache, 0, cfg)
                greedy, _ = jserve.greedy_decode_loop(params, cfg, cache, tgt[:, :1],
                                                      0, STEPS)
                return dict(params=params, apply=jencdec.apply(params, src, tgt, cfg),
                            cache=cache, decode=dec[0], decode_cache=dec[1],
                            greedy=greedy)
            return _ref(ref, key, self.src, self.tgt)

        def ref(key, tokens, fe):
            params = jlm.init(key, cfg)
            lg, cache = jlm.prefill(params, tokens, cfg, MAX_LEN, frontend_embeds=fe)
            dec = jlm.decode_step(params, nxt, cache, S, cfg)
            greedy, _ = jserve.greedy_decode_loop(params, cfg, cache, nxt, S, STEPS)
            ext = jnp.concatenate([tokens, nxt], axis=1)
            return dict(params=params,
                        apply=jlm.apply(params, ext, cfg, frontend_embeds=fe),
                        prefill=lg, cache=cache, decode=dec[0], decode_cache=dec[1],
                        greedy=greedy)
        return _ref(ref, key, self.tokens, self.fe)

    def _run_port(self):
        cfg, params = self.tcfg, self.tparams
        if self.encdec:
            src, tgt = _t(self.src), _t(self.tgt).long()
            cache = tserve.make_prefill_step(cfg, MAX_LEN)(params, src)
            first = tgt[:, :1]
            out = dict(apply=tencdec.apply(params, src, tgt, cfg), cache=_clone(cache))
            pos0 = 0
        else:
            tokens = _t(self.tokens).long()
            fe = None if self.fe is None else _t(self.fe)
            lg, cache = tserve.make_prefill_step(cfg, MAX_LEN)(params, tokens, fe)
            first = _t(self.nxt).long()
            ext = torch.cat([tokens, first], dim=1)
            out = dict(apply=tlm.apply(params, ext, cfg, frontend_embeds=fe),
                       prefill=lg, cache=_clone(cache))
            pos0 = S
        step = tserve.make_decode_step(cfg)
        # from the reference's cache: the bfloat16 leaves the port's prefill
        # rounds one ulp apart would move the logits by up to 3e-4
        dec, dec_cache = step(params, first, tlm.params_from_jax(self.ref["cache"], "cpu"),
                              pos0)
        own, _ = step(params, first, _clone(cache), pos0)
        greedy, _ = tserve.greedy_decode_loop(params, cfg, cache, first, pos0, STEPS)
        out.update(decode=dec, decode_cache=dec_cache, own_decode=own, greedy=greedy)
        return out


@pytest.fixture(scope="module")
def zoo():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _Arch(name)
        return built[name]
    return get


def test_registry_names_match():
    assert tconfigs.all_names() == NAMES
    assert len(NAMES) == 10


@pytest.mark.parametrize("name", NAMES)
def test_init_builds_the_reference_layout(name, zoo):
    """``init`` (``encdec.init`` for enc-dec) from a torch.Generator: the
    reference's keys, shapes and dtypes for every family (stacked layers,
    MoE experts, SSM leaves, the hybrid's shared attention)."""
    arch = zoo(name)
    model = tencdec if arch.encdec else tlm
    got = model.init(arch.tcfg, torch.Generator().manual_seed(0))
    g, w = dict(_leaves(got)), dict(_leaves(arch.jparams))
    assert g.keys() == w.keys()
    for k in g:
        assert (tuple(g[k].shape), str(g[k].dtype).split(".")[-1]) == \
            (w[k].shape, w[k].dtype.name), k


@pytest.mark.parametrize("name", NAMES)
def test_apply_matches_reference(name, zoo):
    arch = zoo(name)
    _close(arch.port["apply"], arch.ref["apply"])
    assert arch.port["apply"].shape[:2] == (B, S if arch.encdec else S + 1)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name, zoo):
    """Last-position logits, and every cache leaf: K/V (bfloat16) within one
    ulp, SSM states (float32) within the tolerance."""
    arch = zoo(name)
    if not arch.encdec:
        _close(arch.port["prefill"], arch.ref["prefill"])
    _same_tree(arch.port["cache"], arch.ref["cache"], "cache")


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name, zoo):
    """One decode step from the reference's prefill cache: logits, and the
    cache with the new token's K/V (or SSM state) written."""
    arch = zoo(name)
    _close(arch.port["decode"], arch.ref["decode"])
    _same_tree(arch.port["decode_cache"], arch.ref["decode_cache"], "decode cache")


@pytest.mark.parametrize("name", NAMES)
def test_greedy_decode_loop_tokens_equal(name, zoo):
    arch = zoo(name)
    assert arch.port["greedy"].shape == (B, STEPS)
    np.testing.assert_array_equal(arch.port["greedy"].numpy(), arch.ref["greedy"])


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if jconfigs.get(n).family != "moe"])
def test_decode_matches_full_forward(name, zoo):
    """``tests/test_archs_smoke.py``'s serving consistency (there: qwen and
    falcon-mamba) on the port, for every family without capacity dropping:
    prefill + decode logits equal ``apply`` on the extended sequence within
    that test's tolerance (the cache stores K/V in bfloat16)."""
    arch = zoo(name)
    full = arch.port["apply"][:, 0] if arch.encdec else arch.port["apply"][:, -1]
    _close(arch.port["own_decode"][:, 0], full.numpy(), atol=0.03, rtol=0.05)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_nn.py: on the port, and against the reference
# ---------------------------------------------------------------------------

def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _naive_attention(q, k, v, window=None):
    b, s, h, dh = q.shape
    n_kv = k.shape[2]
    qh = q.reshape(b, s, n_kv, h // n_kv, dh)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qh, k) * dh ** -0.5
    qpos = torch.arange(s)[:, None]
    kpos = torch.arange(s)[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    p = torch.softmax(torch.where(mask, sc, -2e38), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, h, dh)


@pytest.mark.parametrize("h,kv,window", [(4, 4, None), (8, 2, None), (4, 2, 24)])
def test_flash_attention_matches_naive(h, kv, window):
    b, s, dh = 2, 64, 16
    q, k, v = _normal(0, (b, s, h, dh)), _normal(1, (b, s, kv, dh)), _normal(2, (b, s, kv, dh))
    got = tattn.flash_attention(_t(q), _t(k), _t(v), q_offset=0, chunk_q=16,
                                chunk_k=16, window=window)
    _close(got, _naive_attention(_t(q), _t(k), _t(v), window).numpy(),
           atol=1e-5, rtol=1e-4)
    want = _ref(lambda q, k, v: jattn.flash_attention(
        q, k, v, q_offset=0, chunk_q=16, chunk_k=16, window=window), q, k, v)
    _close(got, want, atol=1e-5, rtol=1e-4)


def test_flash_attention_softcap():
    b, s, h, dh = 1, 32, 2, 8
    q, k, v = _normal(3, (b, s, h, dh), 4), _normal(4, (b, s, h, dh), 4), _normal(5, (b, s, h, dh))
    run = functools.partial(tattn.flash_attention, _t(q), _t(k), _t(v), q_offset=0,
                            chunk_q=8, chunk_k=8)
    capped = run(cap=5.0)
    assert not torch.allclose(capped, run())
    want = _ref(lambda q, k, v: jattn.flash_attention(
        q, k, v, q_offset=0, chunk_q=8, chunk_k=8, cap=5.0), q, k, v)
    _close(capped, want, atol=1e-5, rtol=1e-4)


def _port_init(init, *args, seed=0, **kw):
    """(numpy tree for the reference, the port's tree): the port's init,
    so the mirrors below pay no reference init compile."""
    p = init(torch.Generator().manual_seed(seed), *args, **kw)
    return jax.tree_util.tree_map(lambda t: t.numpy(), p), p


def _moe_setup(b, s, d, f, e, gated, x_seed):
    return (*_port_init(tmoe.moe_init, d, f, e, gated=gated),
            _normal(x_seed, (b, s, d)))


def test_moe_reduces_to_dense_at_full_capacity():
    """top_k = E with room for every token == the router-weighted sum of
    every expert's FFN."""
    b, s, d, f, e = 2, 8, 16, 32, 4
    jp, p, x = _moe_setup(b, s, d, f, e, True, 1)
    out = tmoe.moe(p, _t(x), n_experts=e, top_k=e, capacity_factor=4.0)
    w = torch.softmax(tcommon.dense(p["router"], _t(x)), dim=-1)
    want = 0
    for i in range(e):
        up = _t(x) @ p["w_up"][i]
        hid = F.silu(_t(x) @ p["w_gate"][i]) * up
        want = want + w[..., i:i + 1] * (hid @ p["w_down"][i])
    _close(out, want.numpy(), atol=1e-4, rtol=1e-3)
    _close(out, _ref(lambda p, x: jmoe.moe(p, x, n_experts=e, top_k=e,
                                           capacity_factor=4.0), jp, x))


def test_moe_capacity_drops_tokens():
    b, s, d, f, e = 1, 32, 8, 16, 4
    jp, p, x = _moe_setup(b, s, d, f, e, False, 2)
    tight = tmoe.moe(p, _t(x), n_experts=e, top_k=2, capacity_factor=0.25)
    loose = tmoe.moe(p, _t(x), n_experts=e, top_k=2, capacity_factor=8.0)
    assert not torch.allclose(tight, loose)
    assert bool(torch.isfinite(tight).all())
    _close(tight, _ref(lambda p, x: jmoe.moe(p, x, n_experts=e, top_k=2,
                                             capacity_factor=0.25), jp, x))


def test_moe_aux_loss_matches_reference():
    jp, p, x = _moe_setup(2, 16, 8, 16, 4, True, 3)
    got = tmoe.moe_aux_loss(p, _t(x), n_experts=4)
    _close(got, _ref(lambda p, x: jmoe.moe_aux_loss(p, x, n_experts=4), jp, x),
           atol=1e-6, rtol=1e-6)


def test_mamba1_chunked_scan_matches_naive():
    b, s, d, n = 2, 32, 8, 4
    jp, p = _port_init(tssm.mamba1_init, d, n, expand=2)
    x = _normal(1, (b, s, d), 0.5)
    full = tssm.mamba1(p, _t(x), n_state=n, chunk=8)
    _close(full, tssm.mamba1(p, _t(x), n_state=n, chunk=32).numpy(),
           atol=1e-4, rtol=1e-3)
    _close(full, _ref(lambda p, x: jssm.mamba1(p, x, n_state=n, chunk=8), jp, x))


def test_mamba2_decode_consistency():
    b, s, d, n, hd = 1, 16, 8, 4, 4
    jp, p = _port_init(tssm.mamba2_init, d, n, head_dim=hd, expand=2)
    x = _normal(1, (b, s, d), 0.5)
    full, state = tssm.mamba2(p, _t(x), n_state=n, head_dim=hd, chunk=4,
                              return_state=True)
    st = tssm.mamba2_init_state(b, 2 * d, n, head_dim=hd, device="cpu")
    outs = []
    for t in range(s):
        y, st = tssm.mamba2_decode(p, _t(x)[:, t:t + 1], st, n_state=n, head_dim=hd)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full.numpy(), atol=1e-3, rtol=1e-2)
    _close(st["h"], state["h"].numpy(), atol=1e-3, rtol=1e-2)
    want_full, want_state = _ref(lambda p, x: jssm.mamba2(
        p, x, n_state=n, head_dim=hd, chunk=4, return_state=True), jp, x)
    _close(full, want_full)
    _close(state["h"], want_state["h"])


# ---------------------------------------------------------------------------
# Traps of the translation
# ---------------------------------------------------------------------------

def test_gelu_is_jax_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's
    "gelu" is that form, not torch's default erf form."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = tcommon.activation("gelu")(_t(x))
    _close(got, np.asarray(jax.nn.gelu(x)), atol=1e-6, rtol=1e-6)
    assert float((got - F.gelu(_t(x))).abs().max()) > 1e-4


def test_top_k_ties_go_to_the_lower_index():
    """``jax.lax.top_k`` keeps the lower index among equal values; the MoE
    router's top-k does too (``torch.topk`` promises no order)."""
    _, idx = tmoe.topk(torch.tensor([1.0, 2.0, 2.0, 0.0]), 2)
    assert idx.tolist() == [1, 2]
    assert jax.lax.top_k(jnp.asarray([1.0, 2.0, 2.0, 0.0]), 2)[1].tolist() == [1, 2]
    ties = np.random.default_rng(0).integers(0, 3, (64, 8)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(ties, 2)
    got_v, got_i = tmoe.topk(_t(ties), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("n", [1, 3, 5, 12, 13, 24])
def test_scan_at_chunks_not_a_power_of_two(n):
    """The log-depth scan against the step-by-step recurrence at lengths
    that are not powers of two, with a broadcast decay (mamba2's form)."""
    a = _t(np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 3, 1, 1)).astype(np.float32))
    b = _t(_normal(n + 100, (2, n, 3, 4, 5)))
    h, want = torch.zeros(2, 3, 4, 5), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(tssm._scan(a, b), torch.stack(want, dim=1).numpy(), atol=1e-5, rtol=1e-5)


def test_mamba1_at_a_chunk_not_a_power_of_two():
    """Chunks of 12 (S = 36; ``_pick_chunk``'s exact divisor) against the
    reference's ``associative_scan`` at the same chunking."""
    b, s, d, n = 2, 36, 8, 4
    assert tssm._pick_chunk(s, 16) == 12
    jp, p = _port_init(tssm.mamba1_init, d, n, expand=2, seed=1)
    x = _normal(7, (b, s, d), 0.5)
    got, st = tssm.mamba1(p, _t(x), n_state=n, chunk=16, return_state=True)
    want, want_st = _ref(lambda p, x: jssm.mamba1(p, x, n_state=n, chunk=16,
                                                  return_state=True), jp, x)
    _close(got, want)
    _close(st["h"], want_st["h"])


def test_cache_write_past_max_len_raises():
    """The port refuses a decode position outside the cache; the reference's
    ``dynamic_update_slice`` clamps it (7 into 4 slots writes slot 3)."""
    clamped = jax.lax.dynamic_update_slice_in_dim(jnp.zeros(4), jnp.ones(1), 7, axis=0)
    assert np.asarray(clamped).tolist() == [0, 0, 0, 1]
    cfg = tconfigs.get("qwen1.5-0.5b-smoke")
    params = tlm.init(cfg, torch.Generator().manual_seed(0))
    cache = tlm.init_cache(cfg, 1, 4, "cpu")
    token = torch.zeros((1, 1), dtype=torch.long)
    tlm.decode_step(params, token, cache, 3, cfg)
    for pos in (4, 7, -1):
        with pytest.raises(IndexError, match="outside the cache"):
            tlm.decode_step(params, token, cache, pos, cfg)
    with pytest.raises(ValueError, match="prefill of 5 positions"):
        tlm.prefill(params, torch.zeros((1, 5), dtype=torch.long), cfg, 4)
    ecfg = tconfigs.get("seamless-m4t-medium-smoke")
    eparams = tencdec.init(ecfg, torch.Generator().manual_seed(0))
    ecache = tencdec.init_cache(ecfg, 1, 4, 3, "cpu")
    with pytest.raises(IndexError, match="outside the cache"):
        tencdec.decode_step(eparams, token, ecache, 4, ecfg)


def test_make_inference_engine_binds_the_plan_and_serves():
    """``launch.serve.make_inference_engine``: the plan traced at
    ``example_batch`` with ``hb``'s (k, m) bound, and one request served
    within the exact plan's reveal tolerance of the plaintext forward."""
    from repro_torch import api
    from repro_torch.configs import RESNET_SMOKE
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import resnet

    params = resnet.init(RESNET_SMOKE, 0, device="cpu")
    plan = resnet.trace(params, RESNET_SMOKE, 1)
    hb = HBConfig(tuple(HBLayer() for _ in plan.group_elements), (1,) * plan.n_groups)
    engine = tserve.make_inference_engine(params, RESNET_SMOKE, hb, example_batch=1,
                                          session=api.Session(key=0, device="cpu"))
    assert engine.plan.digest() == plan.with_hb(
        HBConfig(hb.layers, plan.group_elements)).digest()
    x = torch.randn((1, 3, RESNET_SMOKE.in_hw, RESNET_SMOKE.in_hw),
                    generator=torch.Generator().manual_seed(1))
    got = engine.submit("alice", x).result().reveal()
    want = resnet.apply(params, x, RESNET_SMOKE)
    assert float((got - want).abs().max()) <= 5e-2 + 1e-2 * float(want.abs().max())
