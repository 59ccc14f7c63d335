"""Threefry-2x32 counter-based PRNG, bit-identical to ``jax.random``.

The reference draws every protocol mask, share and Beaver triple from
``jax.random`` with raw ``uint32[2]`` keys (jax's default threefry
implementation, partitionable mode).  Share-level bit identity with the
reference therefore needs the same generator.  This module follows
``jax/_src/prng.py``:

- ``PRNGKey``      = ``threefry_seed``: the 64-bit seed split in two words;
- ``split``        = ``_threefry_split_foldlike``: hash of a flat counter;
- ``fold_in``      = ``_threefry_fold_in``: hash of the counter (0, data);
- ``bits``         = ``_threefry_random_bits_partitionable``, 32-bit width:
                     the two hash outputs XORed;
- ``uniform``      = ``random.uniform`` (float32): 23 mantissa bits of
                     ``bits`` under the exponent of 1.0, minus 1;
- ``normal``       = ``random.normal`` (float32): sqrt(2) erfinv(u) of a
                     uniform u in (-1, 1) (torch's erfinv is not XLA's: equal
                     to within a few float32 ulps, not bit for bit);
- ``permutation``  = ``random.permutation(key, n)``: ``_shuffle``'s rounds
                     of split, 32-bit sort keys and a stable sort;
- ``randint``      = ``random.randint`` (int32): two bit sets from a split
                     key, combined mod the span with uint32 wrap-around.

A key is an int64 tensor of shape (..., 2) holding two 32-bit words.  All
arithmetic runs in int64 masked to 32 bits (torch has no ``uint32`` shifts
or adds), on the key's device.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import math

import torch

from ..device import Device, resolve as resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); every argument holds 32-bit words in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    # in place on the two fresh words (and one scratch tensor): a third of
    # the allocations, and on the CPU well over twice as fast
    t = torch.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a += b
            a &= MASK32
            torch.bitwise_left_shift(b, r, out=t)          # b = a ^ rotl(b, r)
            t &= MASK32
            b >>= 32 - r
            b |= t
            b ^= a
        a += ks[(i + 1) % 3]
        a &= MASK32
        b += ks[(i + 2) % 3] + (i + 1)
        b &= MASK32
    return a, b


def PRNGKey(seed: int, device: Device = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (hi, lo) words of the 64-bit seed, on
    ``device`` (default the GPU)."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} does not fit 64 bits")
    seed &= (1 << 64) - 1
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def _counters(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax's ``iota_2x32_shape``: high and low words of the flat index."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & MASK32).reshape(shape)


def _hash_counters(key: torch.Tensor, shape: Tuple[int, ...]):
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {tuple(key.shape)}")
    if key.device.type == "meta":       # shapes only: there is no value to hash
        words = torch.empty(shape, dtype=torch.int64, device="meta")
        return words, words
    c1, c2 = _counters(shape, key.device)
    return threefry2x32(key[0], key[1], c1, c2)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys of shape (*num, 2)."""
    b1, b2 = _hash_counters(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    data_t = torch.full((), int(data) & MASK32, dtype=torch.int64,
                        device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], zero, data_t)
    return torch.stack([b1, b2])


# a draw of more words than this, by device type, is hashed in chunks of
# the flat counter index (each word depends on its index alone, so the
# words are the same): on the card the hash's int64 temporaries then stay
# at 128 MB each, where a whole draw's would be as large as the draw
# (0.76 GB for 95 M words); on the host a chunk whose temporaries stay in
# cache hashes faster
BITS_CHUNK = {"cpu": 1 << 18, "cuda": 1 << 24}


def _bits(key: torch.Tensor, shape: Shape, dtype: torch.dtype) -> torch.Tensor:
    shape = _shape(shape)
    n = math.prod(shape)
    chunk = BITS_CHUNK.get(key.device.type, n)
    if n <= chunk:
        b1, b2 = _hash_counters(key, shape)
        return (b1 ^ b2).to(dtype)
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {tuple(key.shape)}")
    out = torch.empty(n, dtype=dtype, device=key.device)
    for start in range(0, n, chunk):
        flat = torch.arange(start, min(n, start + chunk), dtype=torch.int64,
                            device=key.device)
        b1, b2 = threefry2x32(key[0], key[1], flat >> 32, flat & MASK32)
        out[start:start + flat.numel()] = b1 ^ b2
    return out.reshape(shape)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2^32)."""
    return _bits(key, shape, torch.int64)


def bits_words(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``bits`` as int32 bit patterns: the packed-word dtype of the port."""
    return _bits(key, shape, torch.int32)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit: ``(bits >> 9) | 0x3F800000`` read as a float in [1, 2), minus 1,
    scaled and shifted, and clamped below at ``minval``.  XLA fuses the
    scale and the shift into one fma; in float64 the float32 product is
    exact, so one rounding to float32 after the add gives the fma's
    result (a double rounding could differ at a float32 tie, about one
    draw in 2^29)."""
    b = bits(key, shape)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): sqrt(2) erfinv(u), u
    uniform in [nextafter(-1, 0), 1).  The uniform draw is bit-exact; the
    erfinv is torch's, within a few ulps of XLA's."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a shuffled ``arange(n)`` (int64),
    one round of ``split`` + 32-bit sort keys + a stable sort for n <= 1625,
    more above (jax's ``_shuffle`` round count)."""
    n = int(n)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.argsort(bits(sub, (n,)), stable=True)]
    return x


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``, bit for
    bit, as int64 values in ``[minval, maxval)``: ``split(key)``, 32 bits
    from each half, then ``(hi % span) * (2^32 % span) + lo % span`` mod
    the span, every product and sum wrapping at 32 bits as jax's uint32
    does (so the draw is jax's, bias included).  ``maxval <= minval``
    gives ``minval``; bounds outside int32 raise, as jax's do."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise OverflowError(f"randint bounds {minval}, {maxval} outside int32")
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    offset = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    out = (minval + offset % span) & MASK32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)
