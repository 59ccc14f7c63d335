"""The port's kernels: plain versions against the reference's
``kernels/ref.py``, its Pallas kernels in interpret mode and the jnp path
its main path runs (the CUDA kernels themselves: tests/test_torch_cuda.py).
All comparisons are bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring as jring, ring_linalg as jlinalg, shares as jshares
from repro.kernels import bitpack, gmw_round, ref as jref, ring_matmul as jring_matmul
from repro_torch.core import gmw as tgmw, ring as tring, shares as tshares
from repro_torch.kernels import ops, ref as tref

SEL = np.array([0xFFFFFFFF, 0], np.uint32)     # all-ones on party 0


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _i32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _sel_full(shape) -> np.ndarray:
    return np.broadcast_to(SEL.reshape((2,) + (1,) * (len(shape) - 1)), shape)


@pytest.mark.parametrize("shape", [(2, 8, 256), (2, 64, 33), (2, 3, 5, 7)])
def test_beaver_and_plain_vs_ref(shape):
    rng = np.random.default_rng(0)
    d, e, a, b, c = (_words(rng, *shape) for _ in range(5))
    want = jref.beaver_and(*(jnp.asarray(x) for x in (d, e, a, b, c)),
                           jnp.asarray(_sel_full(shape)))
    got = tref.beaver_and(*(_t(x) for x in (d, e, a, b, c)), _t(SEL))
    np.testing.assert_array_equal(got.numpy(), _i32(want))


def test_beaver_and_plain_vs_pallas_2d():
    """The Pallas kernel takes (planes, W) only: one party's rows."""
    rng = np.random.default_rng(1)
    d, e, a, b, c = (_words(rng, 2, 8, 256) for _ in range(5))
    got = tref.beaver_and(*(_t(x) for x in (d, e, a, b, c)), _t(SEL))
    for party in range(2):
        sel = np.full((8, 256), SEL[party], np.uint32)
        want = gmw_round.beaver_and_pallas(
            *(jnp.asarray(x[party]) for x in (d, e, a, b, c)), jnp.asarray(sel),
            interpret=True)
        np.testing.assert_array_equal(got[party].numpy(), _i32(want))


@pytest.mark.parametrize("rows,n_words", [(8, 256), (63, 33), (1, 5)])
def test_beaver_and_opening_plain_vs_ref(rows, n_words):
    """The opening form: this party's sent (d, e) and the peer's halves as
    views of a received round buffer (party stride 3 x (2, R, W)) are
    opened inside; equals the reference's beaver_and of d ^ d', e ^ e'."""
    rng = np.random.default_rng(11)
    sent = _words(rng, 2, 2, rows, n_words)
    buf = _words(rng, 2, 3, 2, rows, n_words)
    received, recv_t = buf[:, 1], _t(buf)[:, 1]
    assert recv_t.stride(0) == 3 * 2 * rows * n_words
    a, b, c = (_words(rng, 2, rows, n_words) for _ in range(3))
    want = jref.beaver_and(jnp.asarray(sent[:, 0] ^ received[:, 0]),
                           jnp.asarray(sent[:, 1] ^ received[:, 1]),
                           *(jnp.asarray(x) for x in (a, b, c)),
                           jnp.asarray(_sel_full(a.shape)))
    sent_t = _t(sent)
    args = (sent_t[:, 0], sent_t[:, 1], _t(a), _t(b), _t(c), _t(SEL),
            recv_t[:, 0], recv_t[:, 1])
    np.testing.assert_array_equal(tref.beaver_and_open(*args).numpy(), _i32(want))
    np.testing.assert_array_equal(ops.beaver_and(*args).numpy(), _i32(want))


@pytest.mark.parametrize("w,shift", [(8, 1), (8, 4), (64, 32), (6, 2), (64, 1)])
def test_ks_mask_plain_vs_ref_and_pallas(w, shift):
    rng = np.random.default_rng(2)
    g, p = _words(rng, 2, w, 128), _words(rng, 2, w, 128)
    a, b = _words(rng, 2, 2 * w, 128), _words(rng, 2, 2 * w, 128)
    d_t, e_t = tref.ks_mask(_t(g), _t(p), _t(a), _t(b), shift)
    for want in (jref.ks_mask(*map(jnp.asarray, (g, p, a, b)), shift),
                 gmw_round.ks_mask_pallas(*map(jnp.asarray, (g, p, a, b)), shift,
                                          interpret=True, block_words=128)):
        np.testing.assert_array_equal(d_t.numpy(), _i32(want[0]))
        np.testing.assert_array_equal(e_t.numpy(), _i32(want[1]))


@pytest.mark.parametrize("w", [8, 64])
def test_ks_combine_plain_vs_ref_and_pallas(w):
    rng = np.random.default_rng(3)
    d, e, a, b, c = (_words(rng, 2, 2 * w, 128) for _ in range(5))
    opened = _words(rng, 2, 2, 2 * w, 128)       # peer halves, as received
    g = _words(rng, 2, w, 128)
    op_t = _t(opened)
    g_t, p_t = tref.ks_combine(_t(d), op_t[:, 0], _t(e), op_t[:, 1], _t(a), _t(b),
                               _t(c), _t(SEL), _t(g))
    args = [jnp.asarray(x) for x in (d, opened[:, 0], e, opened[:, 1], a, b, c,
                                     _sel_full(d.shape), g)]
    for want in (jref.ks_combine(*args),
                 gmw_round.ks_combine_pallas(*args, interpret=True, block_words=128)):
        np.testing.assert_array_equal(g_t.numpy(), _i32(want[0]))
        np.testing.assert_array_equal(p_t.numpy(), _i32(want[1]))


@pytest.mark.parametrize("w,shift", [(2, 1), (8, 1), (8, 2), (8, 4)]
                         + [(64, 1 << s) for s in range(6)])
def test_ks_step_plain_vs_ref(w, shift):
    """The fused level step's plain version equals the reference's
    ``ks_combine`` of one level, then ``ks_mask`` of the next at ``shift``,
    then the stack of (d', e'), with the peer's halves as views of a
    received round buffer (party stride 3 x (2, 2w, W)); g is updated in
    place.  Also the adder's two ends: ``ks_mask`` as the stacked send
    buffer and ``ks_combine`` without p."""
    rng = np.random.default_rng(10)
    sent = _words(rng, 2, 2, 2 * w, 40)
    buf = _words(rng, 2, 3, 2, 2 * w, 40)          # three payloads received
    received, recv_t = buf[:, 1], _t(buf)[:, 1]
    assert recv_t.stride(0) == 3 * 2 * 2 * w * 40
    a, b, c, a2, b2 = (_words(rng, 2, 2 * w, 40) for _ in range(5))
    g = _words(rng, 2, w, 40)
    sel = _sel_full((2, 2 * w, 40))
    g_j, p_j = jref.ks_combine(*(jnp.asarray(x) for x in (
        sent[:, 0], received[:, 0], sent[:, 1], received[:, 1], a, b, c, sel, g)))
    d_j, e_j = jref.ks_mask(g_j, p_j, jnp.asarray(a2), jnp.asarray(b2), shift)
    g_t = _t(g.copy())
    g_out, send = tref.ks_step(_t(sent), recv_t[:, 0], recv_t[:, 1], _t(a), _t(b),
                               _t(c), _t(SEL), g_t, _t(a2), _t(b2), shift)
    assert g_out is g_t
    np.testing.assert_array_equal(g_out.numpy(), _i32(g_j))
    np.testing.assert_array_equal(send.numpy(), _i32(jnp.stack([d_j, e_j], axis=1)))
    send_m = ops.ks_mask(_t(g), _t(g), _t(a2), _t(b2), shift)
    d_m, e_m = jref.ks_mask(*(jnp.asarray(x) for x in (g, g, a2, b2)), shift)
    np.testing.assert_array_equal(send_m.numpy(), _i32(jnp.stack([d_m, e_m], axis=1)))
    g_only, none = ops.ks_combine(_t(sent)[:, 0], recv_t[:, 0], _t(sent)[:, 1],
                                  recv_t[:, 1], _t(a), _t(b), _t(c), _t(SEL), _t(g),
                                  need_p=False)
    assert none is None
    np.testing.assert_array_equal(g_only.numpy(), _i32(g_j))


def test_ks_level_plain_vs_ref_and_pallas():
    """In place on (P, planes, W) g and p at the strided rows 1, 3, ..., 15
    (a cone level's layout; the Pallas kernel takes rows in blocks of 8),
    per party against the (rows, W) Pallas kernel and its plain reference;
    z is the level's (P, 2n, W) AND output, and the rows outside the level
    stay as they were."""
    rng = np.random.default_rng(6)
    g, p, z = _words(rng, 2, 17, 256), _words(rng, 2, 17, 256), _words(rng, 2, 16, 256)
    g_t, p_t = tref.ks_level(_t(g.copy()), _t(p.copy()), _t(z), 1, 2)
    rows = list(range(1, 16, 2))
    for party in range(2):
        args = [jnp.asarray(x) for x in (g[party, rows], z[party, :8], z[party, 8:])]
        for want in (jref.ks_level(*args),
                     gmw_round.ks_level_pallas(*args, interpret=True)):
            g_want, p_want = _i32(g[party]).copy(), _i32(p[party]).copy()
            g_want[rows], p_want[rows] = _i32(want[0]), _i32(want[1])
            np.testing.assert_array_equal(g_t[party].numpy(), g_want)
            np.testing.assert_array_equal(p_t[party].numpy(), p_want)


def _cone_reference_round(route, sent, received, tri, g_map, p_map, init_pos,
                          level, nxt_pos, nxt_shift, nxt_tri):
    """One cone round of the reference (``src/repro/core/gmw.py:178-198``) on
    (P, W) per-position planes: open, Beaver-AND (``ref.beaver_and`` or
    ``beaver_and_pallas`` in interpret mode), combine (``ref.ks_level`` /
    ``ks_level_pallas``) and the next level's lhs / rhs stack, masked.
    Returns the next payload (P, 2, 2n', W), or None after the last."""
    n_p, rows, n_words = tri[0].shape
    d = jnp.asarray(sent[:, 0] ^ received[:, 0])
    e = jnp.asarray(sent[:, 1] ^ received[:, 1])
    a, b, c = (jnp.asarray(x) for x in tri)
    sel = jnp.asarray(_sel_full(tri[0].shape))
    if route == "pallas":
        flat = [x.reshape(n_p * rows, n_words) for x in (d, e, a, b, c, sel)]
        z = gmw_round.beaver_and_pallas(*flat, interpret=True,
                                        block=(n_p * rows, n_words))
        z = z.reshape(n_p, rows, n_words)
    else:
        z = jref.beaver_and(d, e, a, b, c, sel)
    if level is None:
        for j, i in enumerate(init_pos):
            g_map[i] = z[:, j]
    else:
        n = len(level)
        g_rows = jnp.stack([g_map[i] for i in level], axis=1)
        if route == "pallas":
            g_new, p_new = gmw_round.ks_level_pallas(
                g_rows.reshape(n_p * n, n_words), z[:, :n].reshape(n_p * n, n_words),
                z[:, n:].reshape(n_p * n, n_words), interpret=True,
                block=(n_p * n, n_words))
            g_new, p_new = (x.reshape(n_p, n, n_words) for x in (g_new, p_new))
        else:
            g_new, p_new = jref.ks_level(g_rows, z[:, :n], z[:, n:])
        for j, i in enumerate(level):
            g_map[i], p_map[i] = g_new[:, j], p_new[:, j]
    if nxt_pos is None:
        return None
    lhs = jnp.stack([p_map[i] for i in nxt_pos] * 2, axis=-2)
    rhs = jnp.stack([g_map[i - nxt_shift] for i in nxt_pos] +
                    [p_map[i - nxt_shift] for i in nxt_pos], axis=-2)
    return np.asarray(jnp.stack([lhs ^ jnp.asarray(nxt_tri[0]),
                                 rhs ^ jnp.asarray(nxt_tri[1])], axis=1))


@pytest.mark.parametrize("route", ["ref", "pallas"])
@pytest.mark.parametrize("w,n_words", [(2, 4), (3, 5), (5, 33), (8, 64),
                                       (21, 17), (64, 40)])
def test_cone_step_plain_vs_ref_and_pallas(w, n_words, route):
    """Every round of the cone adder, initial AND to the sign plane:
    ``ref.cone_step`` (what the wrappers run on the CPU) against the
    reference's per-position cone round, with its beaver_and and ks_level
    from ``kernels/ref.py`` or as the Pallas kernels in interpret mode.
    Each round's peer halves are views of a received round buffer (party
    stride 3 x the payload); the next round sends what cone_step wrote.
    g and p are updated in place; the sign plane is p0[w-1] ^ g[w-2]."""
    rng = np.random.default_rng(12 + w)
    init_pos, level_sets = tgmw.schedule_lib.cone_sets(w)
    levels = [(lvl, pos) for lvl, pos in enumerate(level_sets) if pos]
    assert [(lvl, pos[0], 2 << lvl, len(pos)) for lvl, pos in levels] == \
        list(tgmw._cone_levels(w))
    p0 = _words(rng, 2, w, n_words)
    g_map, p_map = {}, {i: jnp.asarray(p0[:, i]) for i in range(w)}
    g_t, p_t = _t(_words(rng, 2, w - 1, n_words)), _t(p0)
    sent = _words(rng, 2, 2, w - 1, n_words)
    tri = [_words(rng, 2, w - 1, n_words) for _ in range(3)]
    level = None
    for r in range(len(levels) + 1):
        rows = sent.shape[2]
        buf = _words(rng, 2, 3, 2, rows, n_words)
        received, recv_t = buf[:, 1], _t(buf)[:, 1]
        if r < len(levels):
            lvl, pos = levels[r]
            nxt_tri = [_words(rng, 2, 2 * len(pos), n_words) for _ in range(3)]
            nxt = (pos[0], 2 << lvl, 1 << lvl)
            nxt_args = (nxt, _t(nxt_tri[0]), _t(nxt_tri[1]))
        else:
            pos, nxt_tri, nxt, nxt_args = None, None, None, ()
        want = _cone_reference_round(route, sent, received, tri, g_map, p_map,
                                     init_pos, level and level_pos, pos,
                                     nxt and nxt[2], nxt_tri)
        got = tref.cone_step(_t(sent), recv_t[:, 0], recv_t[:, 1],
                             *(_t(x) for x in tri), _t(SEL), g_t, p_t,
                             level, *nxt_args)
        for i in range(w - 1):
            if i in g_map:
                np.testing.assert_array_equal(g_t[:, i].numpy(), _i32(g_map[i]))
        for i in range(w):
            np.testing.assert_array_equal(p_t[:, i].numpy(), _i32(p_map[i]))
        if want is None:
            np.testing.assert_array_equal(
                got.numpy(), _i32(p_map[w - 1] ^ g_map[w - 2]))
        else:
            np.testing.assert_array_equal(got.numpy(), _i32(want))
            sent, tri = got.numpy().view(np.uint32), nxt_tri
            level, level_pos = (pos[0], 2 << lvl), pos
    assert r == len(levels)


@pytest.mark.parametrize("w", [1, 8, 32])
def test_pack_unpack_plain_vs_ref_and_pallas(w):
    """(E,) values with w significant bits, E a multiple of 32 x 128."""
    rng = np.random.default_rng(7)
    v = _words(rng, 8192) & np.uint32((1 << w) - 1 if w < 32 else 0xFFFFFFFF)
    packed = tref.pack(_t(v), w)
    for want in (jref.pack(jnp.asarray(v), w),
                 bitpack.pack_pallas(jnp.asarray(v), w, block_words=128)):
        np.testing.assert_array_equal(packed.numpy(), _i32(want))
    got = tref.unpack(packed, v.size)
    np.testing.assert_array_equal(got.numpy(), _i32(v))
    words = jnp.asarray(packed.numpy().view(np.uint32))
    for want in (jref.unpack(words, w),
                 bitpack.unpack_pallas(words, w, block_words=128)):
        np.testing.assert_array_equal(got.numpy(), _i32(want))


@pytest.mark.parametrize("chunk", [1, 5 * 32 * 8, 1 << 26])
def test_pack_in_blocks_of_words_equals_ref(chunk, monkeypatch):
    """The plain pack made a block of words at a time (``PACK_CHUNK``
    elements of its (..., w, W, 32) bit lanes): the reference's words, a
    ragged last block and tail bits included."""
    monkeypatch.setattr(tref, "PACK_CHUNK", chunk)
    rng = np.random.default_rng(11)
    v = _words(rng, 2 * 1000).reshape(2, 1000) & np.uint32(0xFF)
    got = tref.pack(_t(v), 8)
    assert got.shape == (2, 8, 32) and got.dtype == torch.int32
    for row in range(2):                     # the tail padded with zero bits
        want = jref.pack(jnp.asarray(np.pad(v[row], (0, 24))), 8)
        np.testing.assert_array_equal(got[row].numpy(), _i32(want))


def test_shares_packing_routes_through_the_wrappers():
    """pack_bits / unpack_bits are the pack and unpack kernels with one bit
    per plane row; ragged E and a leading level axis, as triple merges
    pass them."""
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (3, 2, 5, 77), dtype=np.uint32)
    want = jshares.pack_bits(jnp.asarray(bits))
    got = tshares.pack_bits(torch.from_numpy(bits.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    np.testing.assert_array_equal(tshares.unpack_bits(got, 77).numpy(),
                                  np.asarray(jshares.unpack_bits(want, 77)))


def _ring_matmul_pallas(x: jring.Ring64, w_np: np.ndarray) -> np.ndarray:
    """The Pallas kernel in interpret mode on zero-padded digit planes
    (its blocks: 8 rows, 128 of K, 128 columns)."""
    m, k = x.shape
    n = w_np.shape[1]
    mp, kp, np_ = -(-m // 8) * 8, max(128, -(-k // 128) * 128), -(-n // 128) * 128
    dx = jnp.pad(jring.balanced_digits(x), ((0, 0), (0, mp - m), (0, kp - k)))
    dw = jnp.pad(jring.balanced_digits_i32(jnp.asarray(w_np)),
                 ((0, 0), (0, kp - k), (0, np_ - n)))
    lo, hi = jring_matmul.ring_matmul_pallas(dx, dw, block=(8, 128, 128),
                                            interpret=True)
    return jring.to_uint64_np(jring.Ring64(lo[:m, :n], hi[:m, :n]))


FOLD_PAST = tref.FOLD_K + 128        # past the kernel's int32 fold


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (5, 40, 12), (33, 300, 7),
                                   (1, 1, 1), (2, 33, 2), (17, 64, 33),
                                   (33, 70, 17), (3, 0, 5), (2, FOLD_PAST, 3)])
def test_ring_matmul_plain_vs_ref_jnp_and_oracle(m, k, n):
    """The plain version and the kernel's own digit arithmetic
    (``ring_matmul_digits``) against the reference's digit oracle, its jnp
    path, its Pallas kernel in interpret mode and Python ints: full-range
    w (-2^31, 2^31 - 1, 0, -1 among it), x with all-0x00, 0x80 and 0xFF
    bytes, ragged M and N, K = 0 and K past the 16384 fold."""
    rng = np.random.default_rng(4)
    x_np = rng.integers(0, 2 ** 64, (m, k), dtype=np.uint64)
    x_np[0, :4] = [0, 2 ** 63, 2 ** 64 - 1, 1][:k]
    x_np[-1, :3] = [0x8080808080808080, 2 ** 64 - 1, 0][:k]
    w_np = rng.integers(-2 ** 31, 2 ** 31, (k, n)).astype(np.int32)
    w_np.flat[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1][:k * n]
    x_t = tring.from_uint64_np(x_np, "cpu")
    got = tring.to_uint64_np(tref.ring_matmul(x_t, torch.from_numpy(w_np)))
    digits = tring.to_uint64_np(tref.ring_matmul_digits(x_t, torch.from_numpy(w_np)))
    np.testing.assert_array_equal(digits, got)
    jx = jring.from_uint64_np(x_np)
    lo, hi = jref.ring_matmul(jring.balanced_digits(jx),
                              jring.balanced_digits_i32(jnp.asarray(w_np)))
    np.testing.assert_array_equal(got, jring.to_uint64_np(jring.Ring64(lo, hi)))
    jnp_path = jlinalg._matmul_chunk(jx, jnp.asarray(w_np))
    np.testing.assert_array_equal(got, jring.to_uint64_np(jnp_path))
    oracle = (x_np.astype(object) @ w_np.astype(object)) % (1 << 64)
    np.testing.assert_array_equal(got, np.asarray(oracle, dtype=np.uint64).reshape(m, n))
    if k <= 512:
        np.testing.assert_array_equal(got, _ring_matmul_pallas(jx, w_np))
    else:
        np.testing.assert_array_equal(got, jring.to_uint64_np(
            jlinalg.matmul_pub(jx, jnp.asarray(w_np))))


def test_ring_matmul_digits_folds_before_int32_overflows():
    """Every x byte 0xFF and every w digit -128 (w = 0x7F7F7F80): one
    shift's sum over more than 16 448 of K leaves int32.  The fold at 16384
    keeps the result exact; without it the plain arithmetic raises, as the
    kernel's accumulators would wrap."""
    x_np = np.full((2, FOLD_PAST), 2 ** 64 - 1, np.uint64)
    w_np = np.full((FOLD_PAST, 3), 0x7F7F7F80, np.int32)
    x_t, w_t = tring.from_uint64_np(x_np, "cpu"), torch.from_numpy(w_np)
    oracle = (x_np.astype(object) @ w_np.astype(object)) % (1 << 64)
    np.testing.assert_array_equal(tring.to_uint64_np(tref.ring_matmul_digits(x_t, w_t)),
                                  oracle.astype(np.uint64))
    with pytest.raises(OverflowError):
        tref.ring_matmul_digits(x_t, w_t, fold=FOLD_PAST)


SPLIT_K = tref.SPLIT_K_SS
SPLIT_PAST = SPLIT_K + 64              # past the ss kernel's split


@pytest.mark.parametrize("b,m,k,n", [(1, 1, 1, 1), (32, 8, 64, 8), (32, 8, 16, 64),
                                     (3, 5, 33, 7), (2, 3, 0, 4), (1, 2, SPLIT_PAST, 3),
                                     (1, 2, SPLIT_K, 3), (1, 3, SPLIT_K + 1, 2),
                                     (1, 2, 2 * SPLIT_K + 1, 2)])
def test_ring_matmul_ss_plain_vs_digits_and_ref(b, m, k, n):
    """The secret x secret product's plain version and the kernel's own
    byte-plane arithmetic (``ring_matmul_ss_digits``: 36 u8 plane
    products, int32 shift sums over chunks of at most 4096 of K whose
    64-bit partials add in the ring) against the reference's
    ``matmul_ring`` and Python ints: all-0x00, 0x80 and 0xFF bytes among
    the values, K = 0, and the split's edges: K = 4096 (one chunk), 4097
    (a chunk of one k after it), 8193 (three chunks) and past 4096."""
    rng = np.random.default_rng(6)
    x_np = rng.integers(0, 2 ** 64, (b, m, k), dtype=np.uint64)
    y_np = rng.integers(0, 2 ** 64, (b, k, n), dtype=np.uint64)
    x_np.reshape(-1)[:3] = [0, 2 ** 64 - 1, 0x8080808080808080][:x_np.size]
    y_np.reshape(-1)[:3] = [2 ** 64 - 1, 0, 2 ** 63][:y_np.size]
    x_t, y_t = tring.from_uint64_np(x_np, "cpu"), tring.from_uint64_np(y_np, "cpu")
    got = tring.to_uint64_np(tref.ring_matmul_ss(x_t, y_t))
    np.testing.assert_array_equal(
        tring.to_uint64_np(tref.ring_matmul_ss_digits(x_t, y_t)), got)
    np.testing.assert_array_equal(tring.to_uint64_np(ops.ring_matmul_ss(x_t, y_t)), got)
    jx, jy = jring.from_uint64_np(x_np), jring.from_uint64_np(y_np)
    np.testing.assert_array_equal(got, jring.to_uint64_np(jlinalg.matmul_ring(jx, jy)))
    oracle = np.einsum("bmk,bkn->bmn", x_np.astype(object), y_np.astype(object)) % (1 << 64)
    np.testing.assert_array_equal(got, np.asarray(oracle, dtype=np.uint64).reshape(b, m, n))


def test_ring_matmul_ss_digits_folds_before_int32_overflows():
    """Every byte 0xFF on both sides: shift 7's sum grows by 8 * 255^2 per
    k, so one sum over more than 4128 of K leaves int32.  The split into
    chunks of 4096 keeps the result exact; without it the plain arithmetic
    raises, as the kernel's accumulators would overflow."""
    x_np = np.full((1, 2, SPLIT_PAST), 2 ** 64 - 1, np.uint64)
    y_np = np.full((1, SPLIT_PAST, 3), 2 ** 64 - 1, np.uint64)
    x_t, y_t = tring.from_uint64_np(x_np, "cpu"), tring.from_uint64_np(y_np, "cpu")
    oracle = (x_np[0].astype(object) @ y_np[0].astype(object)) % (1 << 64)
    np.testing.assert_array_equal(
        tring.to_uint64_np(tref.ring_matmul_ss_digits(x_t, y_t))[0],
        oracle.astype(np.uint64))
    with pytest.raises(OverflowError):
        tref.ring_matmul_ss_digits(x_t, y_t, chunk=SPLIT_PAST)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    ops.reset_launches()
    x = tring.from_uint64_np(rng.integers(0, 2 ** 64, (4, 9), dtype=np.uint64),
                             "cpu")
    w = torch.from_numpy(rng.integers(-99, 99, (9, 3)).astype(np.int32))
    assert torch.equal(ops.ring_matmul(x, w), tref.ring_matmul(x, w))
    g = _t(_words(rng, 2, 4, 3))
    a = _t(_words(rng, 2, 8, 3))
    assert torch.equal(ops.ks_mask(g, g, a, a, 2),
                       torch.stack(tref.ks_mask(g, g, a, a, 2), dim=1))
    sent, opened = _t(_words(rng, 2, 2, 8, 3)), _t(_words(rng, 2, 2, 8, 3))
    args = (sent, opened[:, 0], opened[:, 1], a, a, a, _t(SEL))
    want = tref.ks_step(*args, g.clone(), a, a, 2)
    assert all(torch.equal(u, v)
               for u, v in zip(ops.ks_step(*args, g.clone(), a, a, 2), want))
    halves = (sent[:, 0], sent[:, 1], a, a, a, _t(SEL), opened[:, 0], opened[:, 1])
    assert torch.equal(ops.beaver_and(*halves), tref.beaver_and_open(*halves))
    # w = 5: level 0 at rows 1, 3, then level 1's payload at row 3
    g4, p5 = _t(_words(rng, 2, 4, 3)), _t(_words(rng, 2, 5, 3))
    sent4, opened4 = _t(_words(rng, 2, 2, 4, 3)), _t(_words(rng, 2, 2, 4, 3))
    a4, a2 = _t(_words(rng, 2, 4, 3)), _t(_words(rng, 2, 2, 3))
    cone = (sent4, opened4[:, 0], opened4[:, 1], a4, a4, a4, _t(SEL))
    g_k, p_k, g_p, p_p = g4.clone(), p5.clone(), g4.clone(), p5.clone()
    got = ops.cone_step(*cone, g_k, p_k, (1, 2), (3, 4, 2), a2, a2)
    want = tref.cone_step(*cone, g_p, p_p, (1, 2), (3, 4, 2), a2, a2)
    assert torch.equal(got, want) and torch.equal(g_k, g_p) and torch.equal(p_k, p_p)
    x64 = tring.from_uint64_np(rng.integers(0, 2 ** 64, (2, 70), dtype=np.uint64),
                               "cpu")
    r = _t(_words(rng, 2, 8, 3))
    assert torch.equal(ops.pack_ring(x64, 21, 13, mask=r),
                       tref.pack_ring(x64, 21, 13) ^ r)
    assert ops.pack_ring.masked == 0
    assert ops.launch_counts() == {name: 0 for name in (
        "beaver_and", "ks_mask", "ks_combine", "ks_step", "ks_level",
        "cone_step", "ring_matmul", "ring_matmul_ss", "pack", "pack_ring", "unpack")}


def _meta(dtype, *shape):
    return torch.empty(shape, dtype=dtype, device="meta")


_I32, _I64 = torch.int32, torch.int64
_OFF_CPU_CALLS = {
    "beaver_and": (
        lambda: ops.beaver_and(*(_meta(_I32, 2, 1, 4) for _ in range(5)),
                               _meta(_I32, 2)),
        lambda: ops.beaver_and(*(_meta(_I32, 2, 1, 4) for _ in range(5)),
                               _meta(_I32, 2), _meta(_I32, 2, 1, 4),
                               _meta(_I32, 2, 1, 4))),
    "ks_mask": lambda: ops.ks_mask(_meta(_I32, 2, 1, 4), _meta(_I32, 2, 1, 4),
                                   _meta(_I32, 2, 2, 4), _meta(_I32, 2, 2, 4), 1),
    "ks_combine": lambda: ops.ks_combine(*(_meta(_I32, 2, 2, 4) for _ in range(7)),
                                         _meta(_I32, 2), _meta(_I32, 2, 1, 4)),
    "ks_step": lambda: ops.ks_step(_meta(_I32, 2, 2, 2, 4),
                                   *(_meta(_I32, 2, 2, 4) for _ in range(5)),
                                   _meta(_I32, 2), _meta(_I32, 2, 1, 4),
                                   _meta(_I32, 2, 2, 4), _meta(_I32, 2, 2, 4), 2),
    "ks_level": lambda: ops.ks_level(_meta(_I32, 2, 3, 4), _meta(_I32, 2, 3, 4),
                                     _meta(_I32, 2, 2, 4), 0, 1),
    "cone_step": (
        lambda: ops.cone_step(_meta(_I32, 2, 2, 2, 4),
                              *(_meta(_I32, 2, 2, 4) for _ in range(5)),
                              _meta(_I32, 2), _meta(_I32, 2, 2, 4),
                              _meta(_I32, 2, 3, 4)),
        lambda: ops.cone_step(_meta(_I32, 2, 2, 2, 4),
                              *(_meta(_I32, 2, 2, 4) for _ in range(5)),
                              _meta(_I32, 2), _meta(_I32, 2, 2, 4),
                              _meta(_I32, 2, 3, 4), None, (1, 2, 1),
                              _meta(_I32, 2, 2, 4), _meta(_I32, 2, 2, 4))),
    "ring_matmul": lambda: ops.ring_matmul(_meta(_I64, 2, 3), _meta(_I32, 3, 2)),
    "ring_matmul_ss": lambda: ops.ring_matmul_ss(_meta(_I64, 2, 2, 3),
                                                 _meta(_I64, 2, 3, 2)),
    "pack": lambda: ops.pack(_meta(_I32, 2, 64), 1),
    "pack_ring": (
        lambda: ops.pack_ring(_meta(_I64, 2, 64), 64, 0),
        lambda: ops.pack_ring(_meta(_I64, 2, 64), 64, 0,
                              mask=_meta(_I32, 2, 64, 2))),
    "unpack": lambda: ops.unpack(_meta(_I32, 2, 1, 2), 64),
}


@pytest.mark.parametrize("name", sorted(_OFF_CPU_CALLS))
def test_wrappers_have_no_fallback_off_the_cpu(name):
    """Only a CPU tensor takes the plain version: any other device reaches
    the kernel's checks, which raise where the kernel cannot run (every
    form of a wrapper: beaver_and's plain and opening forms, cone_step's
    initial and level rounds, pack_ring's plain and masked forms)."""
    assert name in ops.launch_counts()
    calls = _OFF_CPU_CALLS[name]
    ops.reset_launches()
    for call in calls if isinstance(calls, tuple) else (calls,):
        with pytest.raises(ValueError, match="the kernel runs on CUDA"):
            call()
    assert ops.launch_counts()[name] == 0 and ops.pack_ring.masked == 0
