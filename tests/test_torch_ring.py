"""The port's ring, fixed point, shares and comm against the reference
(mirrors tests/test_ring.py): op for op on random uint64 and on the edge
values 0, 1, 2^63 and 2^64 - 1, bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm, fixed as jfixed, ring as jring, shares as jshares
from repro_torch.core import comm as tcomm, fixed as tfixed, prng, ring as tring, \
    shares as tshares
from repro_torch.kernels import ops, ref as tref

EDGES = np.array([0, 1, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1, 2 ** 32, 2 ** 32 - 1],
                 np.uint64)


def _values(seed: int, n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2 ** 64, n, dtype=np.uint64)])


def _pair(vals):
    return jring.from_uint64_np(vals), tring.from_uint64_np(vals, "cpu")


def _same(jr, t):
    np.testing.assert_array_equal(tring.to_uint64_np(t), jring.to_uint64_np(jr))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(op):
    """The port's ring add, sub and mul are the int64 operators."""
    a_np, b_np = _values(0), np.roll(_values(1), 3)
    ja, ta = _pair(a_np)
    jb, tb = _pair(b_np)
    got = {"add": ta + tb, "sub": ta - tb, "mul": ta * tb}[op]
    _same(getattr(jring, op)(ja, jb), got)


def test_neg_and_public_int32_factor():
    ja, ta = _pair(_values(2))
    _same(jring.neg(ja), -ta)
    w = np.concatenate([np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31], np.int32),
                        np.random.default_rng(2).integers(-2 ** 31, 2 ** 31,
                                                          ja.shape[0] - 5)
                        .astype(np.int32)])
    _same(jring.from_int32(jnp.asarray(w)), tring.from_int32(torch.from_numpy(w)))
    _same(jring.mul_pub(ja, jnp.asarray(w)), ta * tring.from_int32(torch.from_numpy(w)))


@pytest.mark.parametrize("n", [0, 1, 16, 31, 32, 33, 48, 63])
def test_shifts(n):
    """Left shift is ``<<``; logical right shift is ``>>`` then a mask (the
    idiom of the reference's ``extract_bits``); arithmetic right shift is ``rshift_arith``."""
    ja, ta = _pair(_values(3))
    _same(jring.lshift(ja, n), ta << n)
    _same(jring.rshift_logical(ja, n), (ta >> n) & ((1 << (64 - n)) - 1))
    _same(jring.rshift_arith(ja, n), tring.rshift_arith(ta, n))


@pytest.mark.parametrize("k,m", [(64, 0), (21, 13), (32, 0), (64, 32), (20, 14),
                                 (1, 0), (64, 63), (45, 12), (22, 13)])
def test_extract(k, m):
    """The port extracts and packs bits m..k-1 in one step (``pack_ring``,
    whose plain version the CPU takes): equal to the reference's
    extraction (``extract_bits`` + ``bitplanes_u32`` up to w = 32,
    ``extract_planes`` above, so w = 33 crosses the branch) followed by
    ``shares.pack_bits``; E is ragged."""
    ja, ta = _pair(_values(4))
    w = k - m
    planes = (jring.bitplanes_u32(jring.extract_bits(ja, k, m), w) if w <= 32
              else jring.extract_planes(ja, k, m))
    want = np.asarray(jshares.pack_bits(planes)).view(np.int32)
    np.testing.assert_array_equal(ops.pack_ring(ta, k, m).numpy(), want)
    np.testing.assert_array_equal(tref.pack_ring(ta, k, m).numpy(), want)


@pytest.mark.parametrize("k,m", [(14, 13), (15, 13), (18, 13), (21, 13), (29, 13),
                                 (21, 0), (64, 32), (45, 12), (64, 0)])
def test_extract_masked(k, m):
    """``pack_ring``'s masked form (the A2B round's masked planes, in one
    launch on the card) at w = 1, 2, 5, 8, 16, 21, 32, 33 and 64: the
    reference's extraction and ``shares.pack_bits``, XORed with the same
    mask words; E is ragged.  A mask of another shape raises."""
    ja, ta = _pair(_values(5))
    w = k - m
    planes = (jring.bitplanes_u32(jring.extract_bits(ja, k, m), w) if w <= 32
              else jring.extract_planes(ja, k, m))
    packed = np.asarray(jshares.pack_bits(planes))
    mask = np.random.default_rng(w).integers(0, 2 ** 32, packed.shape,
                                             dtype=np.uint64).astype(np.uint32)
    want = (packed ^ mask).view(np.int32)
    mask_t = torch.from_numpy(mask.view(np.int32))
    np.testing.assert_array_equal(ops.pack_ring(ta, k, m, mask=mask_t).numpy(), want)
    np.testing.assert_array_equal(tref.pack_ring(ta, k, m, mask_t).numpy(), want)
    with pytest.raises(ValueError, match="mask must be"):
        ops.pack_ring(ta, k, m, mask=mask_t[..., :-1])


def test_limb_converters_and_uniform():
    vals = _values(6)
    ja = jring.from_uint64_np(vals)
    t = tring.from_limbs(np.asarray(ja.lo), np.asarray(ja.hi), "cpu")
    np.testing.assert_array_equal(tring.to_uint64_np(t), vals)
    lo, hi = tring.to_limbs(t)
    np.testing.assert_array_equal(lo, np.asarray(ja.lo))
    np.testing.assert_array_equal(hi, np.asarray(ja.hi))
    _same(jring.uniform(jax.random.PRNGKey(4), (3, 17)),
          tring.uniform(prng.PRNGKey(4, "cpu"), (3, 17)))


def test_fixed_point_codec():
    """encode and the float32 decode are bit-exact against the reference;
    decode_np (float64) agrees to 0 (same numpy arithmetic)."""
    x = np.concatenate([np.linspace(-100, 100, 333),
                        [0.5 / 65536, 1.5 / 65536, -2.5 / 65536, 30000.0]]
                       ).astype(np.float32)
    jenc = jfixed.encode(jnp.asarray(x))
    tenc = tfixed.encode(torch.from_numpy(x))
    _same(jenc, tenc)
    big = _values(7)                     # decode far outside the encode range
    jb, tb = _pair(big)
    np.testing.assert_array_equal(tfixed.decode(tb).numpy(),
                                  np.asarray(jfixed.decode(jb)))
    np.testing.assert_array_equal(tfixed.decode_np(tenc), jfixed.decode_np(jenc))
    _same(jfixed.encode_np(x), tfixed.encode_np(x, device="cpu"))


def test_shares_and_packing():
    vals = _values(8)
    jx, tx = _pair(vals)
    js = jshares.share(jax.random.PRNGKey(1), jx)
    ts = tshares.share(prng.PRNGKey(1, "cpu"), tx)
    _same(js, ts)
    np.testing.assert_array_equal(tring.to_uint64_np(tshares.reconstruct(ts)), vals)
    bits = np.random.default_rng(8).integers(0, 2, (2, 5, 100), dtype=np.uint32)
    jp = jshares.pack_bits(jnp.asarray(bits))
    tp = tshares.pack_bits(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))
    np.testing.assert_array_equal(tshares.unpack_bits(tp, 100).numpy(), bits)
    jw = jshares.xor_share_packed(jax.random.PRNGKey(2), jp)
    tw = tshares.xor_share_packed(prng.PRNGKey(2, "cpu"), tp)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))


class _Recording:
    """A SimComm that keeps every exchanged buffer."""

    def __init__(self, base):
        self.base, self.n_parties, self.sent = base, base.n_parties, []

    def swap(self, x):
        self.sent.append(x)
        return self.base.swap(x)

    def party_is(self, p, template):
        return self.base.party_is(p, template)

    def party_slice(self, full):
        return full


def test_coalescing_wire_layout_and_counters():
    """One round of a ring payload, a word payload and another ring payload:
    the flattened buffer equals the reference's word for word; bytes
    8 per ring element, 4 per word."""
    rng = np.random.default_rng(9)
    ring_vals = rng.integers(0, 2 ** 64, (2, 2, 5), dtype=np.uint64)
    words = rng.integers(0, 2 ** 32, (2, 3, 4), dtype=np.uint64).astype(np.uint32)
    jrec, trec = _Recording(jcomm.SimComm()), _Recording(tcomm.SimComm())
    jcc, tcc = jcomm.CoalescingComm(jrec), tcomm.CoalescingComm(trec)
    jr, tr = _pair(ring_vals)
    jr2, tr2 = _pair(ring_vals[:, :1, ::-1])
    jh = [jcc.enqueue(jr), jcc.enqueue(jnp.asarray(words)), jcc.enqueue(jr2)]
    th = [tcc.enqueue(tr), tcc.enqueue(torch.from_numpy(words.view(np.int32))),
          tcc.enqueue(tr2)]
    jout, tout = jcc.flush(), tcc.flush()
    np.testing.assert_array_equal(trec.sent[0].numpy(),
                                  np.asarray(jrec.sent[0]).view(np.int32))
    assert (tcc.n_rounds, tcc.round_bytes, tcc.round_parts) == \
        (jcc.n_rounds, jcc.round_bytes, jcc.round_parts)
    _same(jout[jh[0]], tout[th[0]])
    np.testing.assert_array_equal(tout[th[1]].numpy(),
                                  np.asarray(jout[jh[1]]).view(np.int32))
    _same(jout[jh[2]], tout[th[2]])
    assert tcomm.payload_bytes(tr) == jcomm.payload_bytes(jr) == 2 * 5 * 8
