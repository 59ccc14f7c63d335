"""The port's GMW engine against the reference: triples, relu and relu_many
shares bit-identical, measured rounds and bytes equal to
``schedule.simulate``, and the three BENCH_relu.json counts reproduced."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import beaver as jbeaver, comm as jcomm, fixed as jfixed, \
    gmw as jgmw, ring as jring, shares as jshares
from repro_torch.core import beaver as tbeaver, comm as tcomm, fixed as tfixed, \
    gmw as tgmw, prng, ring as tring, schedule, shares as tshares

# 512 elements: the size of RESNET_SMOKE's per-stream stem ReLU at 8x8, so
# a serial run shares the reference's compiled ops with test_torch_resnet
N = 512


def _shares(seed: int, n: int):
    x = np.random.default_rng(seed).uniform(-3.5, 3.5, n).astype(np.float32)
    js = jshares.share(jax.random.PRNGKey(seed), jfixed.encode_np(x))
    ts = tshares.share(prng.PRNGKey(seed, "cpu"), tfixed.encode_np(x, device="cpu"))
    return x, js, ts


def _same(jr, t):
    np.testing.assert_array_equal(tring.to_uint64_np(t), jring.to_uint64_np(jr))


def _bins(t):
    levels = t.bin_levels
    return [t.bin_init] + (list(levels) if isinstance(levels, tuple) else [levels])


def _same_triples(jt, tt):
    jbins, tbins = _bins(jt), _bins(tt)
    assert len(jbins) == len(tbins)
    for jb, tb in zip(jbins, tbins):
        for f in ("a", "b", "c"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)).view(np.int32))
    for ja, ta in ((jt.b2a, tt.b2a), (jt.mult, tt.mult)):
        for f in ("a", "b", "c"):
            _same(getattr(ja, f), getattr(ta, f))


def _spy_pack_ring(monkeypatch) -> list:
    """Record whether each ``pack_ring`` call of the GMW engine takes the
    A2B mask (the fused route: one launch for v ^ r on the card)."""
    calls, real = [], tgmw.kops.pack_ring

    def spy(x, k, m, mask=None):
        calls.append(mask is not None)
        return real(x, k, m, mask=mask)

    monkeypatch.setattr(tgmw.kops, "pack_ring", spy)
    return calls


@pytest.mark.parametrize("k,m", [(64, 0), (21, 13), (14, 13)])
def test_relu_shares_bit_identical(k, m, monkeypatch):
    """Exact 64-bit, HummingBird (21, 13) and w = 1, the A2B masks folded
    into ``pack_ring``."""
    calls = _spy_pack_ring(monkeypatch)
    x, js, ts = _shares(1, N)
    jt = jbeaver.gen_relu_triples(jax.random.PRNGKey(2), N, k - m)
    tt = tbeaver.gen_relu_triples(prng.PRNGKey(2, "cpu"), N, k - m)
    _same_triples(jt, tt)
    jout = jgmw.relu(jax.random.PRNGKey(3), js, jt, jcomm.SimComm(), k=k, m=m)
    cm = tcomm.CountingComm()
    tout = tgmw.relu(prng.PRNGKey(3, "cpu"), ts, tt, cm, k=k, m=m)
    _same(jout, tout)
    assert calls == [True]
    sched = schedule.simulate([(N, k - m, (N, k, m))])
    assert (cm.n_swaps, cm.bytes_tx) == (sched.n_rounds, sched.bytes_tx)
    if k == 64:
        got = tfixed.decode_np(tshares.reconstruct(tout))
        np.testing.assert_allclose(got, np.maximum(x, 0), atol=2 ** -16)


def test_relu_many_merged_ragged_and_culled():
    """Identical siblings merge (bit-level triple repack), a ragged group
    keeps its own payload, a width-0 group is the identity."""
    specs = [(N, 21, 13), (N, 21, 13), (N // 2, 20, 14), (N, 13, 13)]
    jx, tx, jtr, ttr, jk, tk = [], [], [], [], [], []
    for i, (n, k, m) in enumerate(specs):
        _, js, ts = _shares(10 + i, n)
        jx.append(js)
        tx.append(ts)
        jtr.append(jbeaver.gen_relu_triples(jax.random.PRNGKey(20 + i), n, k - m)
                   if k > m else None)
        ttr.append(tbeaver.gen_relu_triples(prng.PRNGKey(20 + i, "cpu"), n, k - m)
                   if k > m else None)
        jk.append(jax.random.PRNGKey(30 + i))
        tk.append(prng.PRNGKey(30 + i, "cpu"))
    kms = [(k, m) for _, k, m in specs]
    jouts = jgmw.relu_many(jk, jx, jtr, jcomm.SimComm(), kms)
    cc = tcomm.CoalescingComm()
    touts = tgmw.relu_many(tk, tx, ttr, cc, kms)
    for jo, to in zip(jouts, touts):
        _same(jo, to)
    sched = schedule.simulate([(n, k - m, (n, k, m)) for n, k, m in specs])
    assert (cc.n_rounds, cc.bytes_tx, tuple(cc.round_parts)) == \
        (sched.n_rounds, sched.bytes_tx, sched.round_parts)
    merged = tbeaver.concat_relu_triples(ttr[:2], [N, N], 8)
    jmerged = jbeaver.concat_relu_triples(jtr[:2], [N, N], 8)
    _same_triples(jmerged, merged)


@functools.lru_cache(maxsize=None)
def _stream_triples(i: int, n: int, w: int, cone: bool):
    return (jbeaver.gen_relu_triples(jax.random.PRNGKey(80 + i), n, w, cone=cone),
            tbeaver.gen_relu_triples(prng.PRNGKey(80 + i, "cpu"), n, w, cone=cone))


@pytest.mark.parametrize("cone", [False, True], ids=["dense", "cone"])
@pytest.mark.parametrize("w", [1, 8, 64])
@pytest.mark.parametrize("n_list", [[512, 512], [64, 4096, 32], [77, 77],
                                    [512, 77], [77, 512]],
                         ids=lambda ns: "-".join(map(str, ns)))
def test_concat_relu_triples_routes_bit_identical(n_list, w, cone, monkeypatch):
    """The merge takes the word route (torch.cat of the packed words, no
    unpack or pack) when every n_i is a multiple of 32, the bit route
    otherwise (a ragged last stream too: its tail bits are random and the
    reference's repack zeroes them); either way the merged bundle equals
    the reference's ``concat_relu_triples`` bit for bit."""
    jt, tt = zip(*(_stream_triples(i, n, w, cone and w > 1)
                   for i, n in enumerate(n_list)))
    repacks = []
    for name in ("unpack_bits", "pack_bits"):
        fn = getattr(tshares, name)
        monkeypatch.setattr(tshares, name,
                            lambda *a, fn=fn, name=name: repacks.append(name) or fn(*a))
    merged = tbeaver.concat_relu_triples(tt, n_list, w, cone=cone)
    _same_triples(jbeaver.concat_relu_triples(jt, n_list, w, cone=cone), merged)
    whole_words = all(n % 32 == 0 for n in n_list)
    assert bool(repacks) != whole_words, repacks
    if whole_words:
        for j, member in enumerate(_bins(merged)):
            for f in ("a", "b", "c"):
                assert torch.equal(getattr(member, f),
                                   torch.cat([getattr(_bins(t)[j], f) for t in tt],
                                             dim=-1))


@pytest.mark.parametrize("w", [8, 9, 33, 64])
def test_cone_triples_bit_identical(w):
    """Cone triples: ragged per-level tuples (w = 9 and 33 have an empty
    top level, which still draws a 2-row triple), same key splits; two
    streams merged level by level, as relu_many merges siblings."""
    jt = [jbeaver.gen_relu_triples(jax.random.PRNGKey(70 + i), N, w, cone=True)
          for i in range(2)]
    tt = [tbeaver.gen_relu_triples(prng.PRNGKey(70 + i, "cpu"), N, w, cone=True)
          for i in range(2)]
    for j, t in zip(jt, tt):
        _same_triples(j, t)
    _same_triples(jbeaver.concat_relu_triples(jt, [N, N], w, cone=True),
                  tbeaver.concat_relu_triples(tt, [N, N], w, cone=True))


@pytest.mark.parametrize("k,m", [(64, 0), (21, 13), (22, 13), (14, 13)])
def test_cone_relu_shares_bit_identical(k, m, monkeypatch):
    """The MSB-cone-pruned adder: shares bit-identical to the reference's
    cone path (w = 9 runs an empty level), counters equal
    ``simulate(cone=True)``; the A2B masks folded into ``pack_ring``."""
    calls = _spy_pack_ring(monkeypatch)
    x, js, ts = _shares(1, N)
    jt = jbeaver.gen_relu_triples(jax.random.PRNGKey(2), N, k - m, cone=True)
    tt = tbeaver.gen_relu_triples(prng.PRNGKey(2, "cpu"), N, k - m, cone=True)
    jout = jgmw.relu(jax.random.PRNGKey(3), js, jt, jcomm.SimComm(), k=k, m=m,
                     cone=True)
    cm = tcomm.CountingComm()
    tout = tgmw.relu(prng.PRNGKey(3, "cpu"), ts, tt, cm, k=k, m=m, cone=True)
    _same(jout, tout)
    assert calls == [True]
    sched = schedule.simulate([(N, k - m, (N, k, m))], cone=True)
    assert (cm.n_swaps, cm.bytes_tx) == (sched.n_rounds, sched.bytes_tx)


def test_cone_relu_many_counts_equal_schedule():
    """Cone relu_many over merged, ragged and culled groups: shares equal
    the reference's, fused rounds and bytes equal ``simulate(cone=True)``."""
    specs = [(N, 21, 13), (N, 21, 13), (N // 2, 20, 14), (N, 13, 13)]
    jx, tx, jk, tk = [], [], [], []
    for i, (n, k, m) in enumerate(specs):
        _, js, ts = _shares(10 + i, n)
        jx.append(js)
        tx.append(ts)
        jk.append(jax.random.PRNGKey(30 + i))
        tk.append(prng.PRNGKey(30 + i, "cpu"))
    jtr = [jbeaver.gen_relu_triples(jax.random.PRNGKey(20 + i), n, k - m, cone=True)
           for i, (n, k, m) in enumerate(specs)]
    ttr = [tbeaver.gen_relu_triples(prng.PRNGKey(20 + i, "cpu"), n, k - m, cone=True)
           for i, (n, k, m) in enumerate(specs)]
    kms = [(k, m) for _, k, m in specs]
    jouts = jgmw.relu_many(jk, jx, jtr, jcomm.SimComm(), kms, cone=True)
    cc = tcomm.CoalescingComm()
    touts = tgmw.relu_many(tk, tx, ttr, cc, kms, cone=True)
    for jo, to in zip(jouts, touts):
        _same(jo, to)
    sched = schedule.simulate([(n, k - m, (n, k, m)) for n, k, m in specs],
                              cone=True)
    assert (cc.n_rounds, cc.bytes_tx, tuple(cc.round_parts)) == \
        (sched.n_rounds, sched.bytes_tx, sched.round_parts)


def _bench_shares(n: int, k: int, m: int, seed: int):
    x = np.random.default_rng(seed).uniform(-3.5, 3.5, n).astype(np.float32)
    xs = tshares.share(prng.PRNGKey(50 + seed, "cpu"), tfixed.encode_np(x, device="cpu"))
    return xs, tbeaver.gen_relu_triples(prng.PRNGKey(60 + seed, "cpu"), n, k - m)


@pytest.mark.parametrize("name,k,m,rounds,nbytes", [
    ("exact_64", 64, 0, 10, 507904), ("reduced_8of64", 21, 13, 7, 96256)])
def test_bench_relu_counts(name, k, m, rounds, nbytes):
    """BENCH_relu.json ``configs``: 2048 elements, one ReLU."""
    xs, tr = _bench_shares(2048, k, m, 0)
    cm = tcomm.CountingComm()
    tgmw.relu(prng.PRNGKey(3, "cpu"), xs, tr, cm, k=k, m=m)
    assert (cm.n_swaps, cm.bytes_tx) == (rounds, nbytes)


def test_bench_multigroup_counts():
    """BENCH_relu.json ``multigroup``: four concurrent groups, 10 fused
    rounds and 696 576 B (31 rounds when run one by one)."""
    specs = [(2048, 64, 0), (2048, 21, 13), (1024, 21, 13), (1024, 20, 14)]
    xs, trs = zip(*(_bench_shares(n, k, m, i) for i, (n, k, m) in enumerate(specs)))
    cc = tcomm.CoalescingComm()
    tgmw.relu_many([prng.PRNGKey(40 + i, "cpu") for i in range(4)], list(xs), list(trs),
                   cc, [(k, m) for _, k, m in specs])
    assert (cc.n_rounds, cc.bytes_tx) == (10, 696576)
    assert sum(tgmw.n_rounds(k - m) for _, k, m in specs) == 31


def test_single_round_drivers_bit_identical():
    """and_open, a2b_prepare, beaver_mul, b2a_bit and drelu on their own."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint64).astype(np.uint32)
    jxs = jshares.xor_share_packed(jax.random.PRNGKey(4), jax.numpy.asarray(x))
    jys = jshares.xor_share_packed(jax.random.PRNGKey(5), jax.numpy.asarray(y))
    txs = tshares.xor_share_packed(prng.PRNGKey(4, "cpu"), torch.from_numpy(x.view(np.int32)))
    tys = tshares.xor_share_packed(prng.PRNGKey(5, "cpu"), torch.from_numpy(y.view(np.int32)))
    jz = jgmw.and_open(jxs, jys, jbeaver.gen_bin(jax.random.PRNGKey(6), (4, 8)),
                       jcomm.SimComm())
    tz = tgmw.and_open(txs, tys, tbeaver.gen_bin(prng.PRNGKey(6, "cpu"), (4, 8)),
                       tcomm.SimComm())
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz).view(np.int32))
    for j, t in zip(jgmw.a2b_prepare(jax.random.PRNGKey(7), jxs, jcomm.SimComm()),
                    tgmw.a2b_prepare(prng.PRNGKey(7, "cpu"), txs, tcomm.SimComm())):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).view(np.int32))
    _, ja, ta = _shares(8, N)
    _, jb, tb = _shares(9, N)
    _same(jgmw.beaver_mul(ja, jb, jbeaver.gen_arith(jax.random.PRNGKey(1), (N,)),
                          jcomm.SimComm()),
          tgmw.beaver_mul(ta, tb, tbeaver.gen_arith(prng.PRNGKey(1, "cpu"), (N,)),
                          tcomm.SimComm()))
    bits = rng.integers(0, 2, (2, N), dtype=np.uint32)
    _same(jgmw.b2a_bit(jax.numpy.asarray(bits),
                       jbeaver.gen_arith(jax.random.PRNGKey(2), (N,)), jcomm.SimComm()),
          tgmw.b2a_bit(torch.from_numpy(bits.astype(np.int32)),
                       tbeaver.gen_arith(prng.PRNGKey(2, "cpu"), (N,)), tcomm.SimComm()))
    jt = jbeaver.gen_relu_triples(jax.random.PRNGKey(3), N, 8)
    tt = tbeaver.gen_relu_triples(prng.PRNGKey(3, "cpu"), N, 8)
    _same(jgmw.drelu(jax.random.PRNGKey(4), ja, jt, jcomm.SimComm(), k=21, m=13),
          tgmw.drelu(prng.PRNGKey(4, "cpu"), ta, tt, tcomm.SimComm(), k=21, m=13))


def _same_pool(jpool, tpool):
    assert len(jpool) == len(tpool)
    for jb, tb in zip(jpool, tpool):
        assert (jb is None) == (tb is None)
        if tb is not None:
            _same_triples(jb, tb)


# a dense and a cone triple of the sizes above, a culled and an empty call
SPECS = [(N, 8), (N, 0), (0, 8), (N, 64)]


@pytest.mark.parametrize("cone", [False, True], ids=["dense", "cone"])
def test_gen_plan_triples_and_eager_ttp_bit_identical(cone):
    """``gen_plan_triples`` (one key split per spec, None for width-0 and
    empty specs) and ``EagerTTP(requests=2, streams=2)`` (call-major /
    stream-minor) give the reference's bundles bit for bit."""
    _same_pool(jbeaver.gen_plan_triples(jax.random.PRNGKey(11), SPECS, cone=cone),
               tbeaver.gen_plan_triples(prng.PRNGKey(11, "cpu"), SPECS, cone=cone))
    jttp = jbeaver.EagerTTP(jax.random.PRNGKey(12), SPECS[:2], cone=cone,
                            requests=2, streams=2)
    tttp = tbeaver.EagerTTP(prng.PRNGKey(12, "cpu"), SPECS[:2], cone=cone,
                            requests=2, streams=2)
    assert isinstance(tttp, tbeaver.TripleProvider)
    pops = [(n, w) for n, w in SPECS[:2] for _ in range(2)] * 2
    _same_pool([jttp.relu_triples(n, w, cone=cone) for n, w in pops],
               [tttp.relu_triples(n, w, cone=cone) for n, w in pops])
    with pytest.raises(RuntimeError, match="exhausted"):
        tttp.relu_triples(N, 8, cone=cone)


@pytest.mark.parametrize("cone", [False, True], ids=["dense", "cone"])
def test_streaming_ttp_bit_identical(cone):
    """``StreamingTTP`` draws each bundle from its own key stream, as the
    reference; culled and empty calls draw nothing; a rollback to a
    checkpoint draws the same bundle again."""
    jttp = jbeaver.StreamingTTP(jax.random.PRNGKey(13))
    tttp = tbeaver.StreamingTTP(prng.PRNGKey(13, "cpu"))
    _same_pool([jttp.relu_triples(n, w, cone=cone) for n, w in SPECS],
               [tttp.relu_triples(n, w, cone=cone) for n, w in SPECS])
    token = tttp.checkpoint()
    first = tttp.relu_triples(N, 8, cone=cone)
    tttp.rollback(token)
    again = tttp.relu_triples(N, 8, cone=cone)
    want = jttp.relu_triples(N, 8, cone=cone)
    _same_triples(want, first)
    _same_triples(want, again)


def test_metered_provider_meters_and_raises():
    """``MeteredProvider`` counts bundles and DReLU elements as the
    reference's does (culled and empty calls free), raises
    ``TripleBudgetExceeded`` past its budget without billing, and rolls
    back its counters with its base provider's position."""
    from repro_torch import errors
    calls = [(N, 8), (N, 0), (0, 8), (N // 2, 64)]
    jm = jbeaver.MeteredProvider(jbeaver.InlineTTP(), budget_elements=N + N // 2)
    tm = tbeaver.MeteredProvider(tbeaver.InlineTTP(), budget_elements=N + N // 2)
    for n, w in calls:
        assert jm.relu_triples(n, w) is None and tm.relu_triples(n, w) is None
    assert (tm.consumed_bundles, tm.consumed_elements, tm.remaining_elements) == \
        (jm.consumed_bundles, jm.consumed_elements, jm.remaining_elements) == \
        (2, N + N // 2, 0)
    with pytest.raises(errors.TripleBudgetExceeded):
        tm.relu_triples(1, 8)
    assert tm.consumed_elements == N + N // 2
    pool = tbeaver.TriplePool(
        tbeaver.gen_plan_triples(prng.PRNGKey(14, "cpu"), [(8, 4)] * 2))
    metered = tbeaver.MeteredProvider(pool)
    assert metered.remaining_elements is None
    token = metered.checkpoint()
    first = metered.relu_triples(8, 4)
    metered.rollback(token)
    assert metered.relu_triples(8, 4) is first
    assert (metered.consumed_bundles, metered.consumed_elements, pool.consumed) == \
        (1, 8, 1)


def test_triple_pool_order_and_exhaustion():
    from repro_torch import errors
    bundles = [tbeaver.gen_relu_triples(prng.PRNGKey(i, "cpu"), 8, 4) for i in range(2)]
    pool = tbeaver.TriplePool(bundles + [None])
    assert pool.relu_triples(8, 4) is bundles[0]
    token = pool.checkpoint()
    assert pool.relu_triples(8, 4) is bundles[1]
    pool.rollback(token)
    assert pool.relu_triples(8, 4) is bundles[1]
    assert pool.relu_triples(8, 0) is None
    with pytest.raises(errors.TriplePoolExhausted):
        pool.relu_triples(8, 4)
    assert tbeaver.InlineTTP().relu_triples(8, 4) is None


# ---------------------------------------------------------------------------
# Secret x secret products (the LM's Beaver opens)
# ---------------------------------------------------------------------------

def _ring_pair(seed: int, shape):
    """The same uniform ring values in both packages' layouts."""
    u = np.random.default_rng(seed).integers(0, 2 ** 64, shape, dtype=np.uint64)
    return jring.from_uint64_np(u), tring.from_uint64_np(u, "cpu")


@pytest.mark.parametrize("lead,m,k,n", [((), 5, 7, 3), ((3,), 8, 64, 8),
                                        ((2, 4), 8, 8, 16), ((1,), 2, 8200, 3)])
def test_matmul_ring_bit_identical(lead, m, k, n):
    """``ring_linalg.matmul_ring`` (the ``ring_matmul_ss`` plain version on
    the CPU) equals the reference's digit-plane einsum, K = 8200 past the
    reference's 8192 chunk included."""
    from repro.core import ring_linalg as jlinalg
    from repro_torch.core import ring_linalg as tlinalg

    jx, tx = _ring_pair(10, lead + (m, k))
    jy, ty = _ring_pair(11, lead + (k, n))
    _same(jlinalg.matmul_ring(jx, jy), tlinalg.matmul_ring(tx, ty))


def test_matmul_ring_rejects_unaligned_batch():
    from repro_torch.core import ring_linalg as tlinalg

    with pytest.raises(ValueError):
        tlinalg.matmul_ring(torch.zeros((2, 3, 4), dtype=torch.int64),
                            torch.zeros((3, 4, 5), dtype=torch.int64))


@pytest.mark.parametrize("x_shape,y_shape", [((4, 8, 16), (4, 16, 8)),
                                             ((1, 2, 4, 3), (1, 2, 3, 4))])
def test_gen_matmul_bit_identical(x_shape, y_shape):
    jt = jbeaver.gen_matmul(jax.random.PRNGKey(5), x_shape, y_shape)
    tt = tbeaver.gen_matmul(prng.PRNGKey(5, "cpu"), x_shape, y_shape)
    for f in ("a", "b", "c"):
        _same(getattr(jt, f), getattr(tt, f))


def test_beaver_matmul_and_products_many_bit_identical():
    """``beaver_matmul`` alone, then ``products_many`` with a mul and two
    matmuls of different shapes in ONE coalesced round: shares equal the
    reference's, counters equal ``simulate_open``."""
    jx, tx = _ring_pair(20, (2, 3, 4, 5))
    jy, ty = _ring_pair(21, (2, 3, 5, 6))
    jt = jbeaver.gen_matmul(jax.random.PRNGKey(7), (3, 4, 5), (3, 5, 6))
    tt = tbeaver.gen_matmul(prng.PRNGKey(7, "cpu"), (3, 4, 5), (3, 5, 6))
    _same(jgmw.beaver_matmul(jx, jy, jt, jcomm.SimComm()),
          tgmw.beaver_matmul(tx, ty, tt, tcomm.SimComm()))
    ju, tu = _ring_pair(22, (2, 7, 9))
    jv, tv = _ring_pair(23, (2, 7, 9))
    jm = jbeaver.gen_arith(jax.random.PRNGKey(8), (7, 9))
    tm = tbeaver.gen_arith(prng.PRNGKey(8, "cpu"), (7, 9))
    jw, tw = _ring_pair(24, (2, 9, 2))
    jt2 = jbeaver.gen_matmul(jax.random.PRNGKey(9), (7, 9), (9, 2))
    tt2 = tbeaver.gen_matmul(prng.PRNGKey(9, "cpu"), (7, 9), (9, 2))
    jcc = jcomm.CoalescingComm(jcomm.CountingComm())
    tcc = tcomm.CoalescingComm(tcomm.CountingComm())
    jr = jgmw.products_many([("matmul", jx, jy, jt), ("mul", ju, jv, jm),
                             ("matmul", ju, jw, jt2)], jcc)
    tr = tgmw.products_many([("matmul", tx, ty, tt), ("mul", tu, tv, tm),
                             ("matmul", tu, tw, tt2)], tcc)
    for a, b in zip(jr, tr):
        _same(a, b)
    want = schedule.simulate_open([3 * 4 * 5 + 3 * 5 * 6, 2 * 7 * 9, 7 * 9 + 9 * 2])
    assert tcc.n_rounds == jcc.n_rounds == want.n_rounds == 1
    assert tcc.bytes_tx == jcc.bytes_tx == want.bytes_tx
    assert tcc.round_parts == [3]


def test_mpc_tensor_structural_ops_and_products_bit_identical():
    """transpose, swapaxes, repeat, indexing, stack, concat, and the
    tensor-level ``mul``/``matmul``/``products_many`` (inline triples from
    the key, one truncation) equal the reference's."""
    from repro.core import mpc_tensor as jmt
    from repro_torch.core import mpc_tensor as tmt

    x = np.random.default_rng(30).uniform(-2, 2, (2, 3, 4, 5)).astype(np.float32)
    y = np.random.default_rng(31).uniform(-2, 2, (2, 3, 5, 4)).astype(np.float32)
    jX = jmt.MPCTensor.from_plain(jax.random.PRNGKey(1), x)
    jY = jmt.MPCTensor.from_plain(jax.random.PRNGKey(2), y)
    tX = tmt.MPCTensor.from_plain(prng.PRNGKey(1, "cpu"), torch.from_numpy(x))
    tY = tmt.MPCTensor.from_plain(prng.PRNGKey(2, "cpu"), torch.from_numpy(y))
    _same(jX.data, tX.data)
    pairs = [(jX.transpose(0, 2, 1, 3), tX.transpose(0, 2, 1, 3)),
             (jX.transpose((3, 1, 2, 0)), tX.transpose((3, 1, 2, 0))),
             (jX.swapaxes(-1, -2), tX.swapaxes(-1, -2)),
             (jX.repeat(2, axis=1), tX.repeat(2, axis=1)),
             (jX[..., :2], tX[..., :2]), (jX[1], tX[1]), (jX[:, 1:, 3], tX[:, 1:, 3]),
             (jmt.stack([jX, jX.swapaxes(0, 0)], axis=0),
              tmt.stack([tX, tX.swapaxes(0, 0)], axis=0)),
             (jmt.stack([jX, jX], axis=-1), tmt.stack([tX, tX], axis=-1)),
             (jmt.concat([jX, jX[..., :1]], axis=-1), tmt.concat([tX, tX[..., :1]], axis=-1))]
    for j, t in pairs:
        assert tuple(t.shape) == tuple(j.shape)
        _same(j.data, t.data)
    _same(jX.matmul(jY, jax.random.PRNGKey(3)).data,
          tX.matmul(tY, prng.PRNGKey(3, "cpu")).data)
    _same(jX.mul(jX, jax.random.PRNGKey(4)).data, tX.mul(tX, prng.PRNGKey(4, "cpu")).data)
    jcc, tcc = jcomm.CoalescingComm(), tcomm.CoalescingComm()
    jr = jmt.products_many(["mul", "matmul"], [jax.random.PRNGKey(5), jax.random.PRNGKey(6)],
                           [jX, jX], [jX, jY], comm=jcc)
    tr = tmt.products_many(["mul", "matmul"], [prng.PRNGKey(5, "cpu"), prng.PRNGKey(6, "cpu")],
                           [tX, tX], [tX, tY], comm=tcc)
    for j, t in zip(jr, tr):
        _same(j.data, t.data)
    assert tcc.n_rounds == jcc.n_rounds == 1 and tcc.bytes_tx == jcc.bytes_tx
    np.testing.assert_allclose(tr[1].reveal_np(), x @ y, atol=1e-3)
