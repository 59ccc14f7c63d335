"""The public RoPE tables of the private LM, equal bit for bit to the
reference's.

The reference builds them with XLA's float32 ``pow``, ``cos`` and ``sin``
(``models/lm.py`` ``_rope_mpc``), and encodes them at 16 fractional bits,
so one float32 ulp can flip an encoded LSB and the shares part ways.
torch's float32 transcendentals are not XLA's, and CUDA's are neither, so
the tables are built here on the CPU, whatever the device, in float64
torch ops that reproduce XLA's float32 results, then moved:

- ``freqs``: ``theta ** (-i / half)``; the exponent in float32, the power
  in float64 rounded once to float32 (equal to XLA's at every tested
  (theta, half));
- ``cos``/``sin``: XLA's CPU backend calls the C library's ``cosf`` /
  ``sinf``, whose algorithm (the double-precision one of glibc 2.28 on)
  ``sincos_f32`` repeats op for op: a fast reduction by pi/2 below 120, a
  reduction against 192 bits of 4/pi above, then a degree-4 cosine or
  degree-7 sine polynomial in float64, rounded once to float32.  Each
  float64 op is its own IEEE operation, so the result is the same on any
  device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import Device

# 4/pi to 192 bits, 8 new bits per entry (the C library's table)
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")     # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")           # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")        # 2 pi * 2^-64
_COS = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
        float.fromhex("0x1.55553e1068f19p-5"), float.fromhex("-0x1.6c087e89a359dp-10"),
        float.fromhex("0x1.99343027bf8c3p-16"))
_SIN = (float.fromhex("-0x1.555545995a603p-3"), float.fromhex("0x1.1107605230bc4p-7"),
        float.fromhex("-0x1.994eb3774cf24p-13"))
# abstop12 thresholds: pi/4, 120 and 2^-12 as float32 bit patterns >> 20
_TOP_PIO4, _TOP_120, _TOP_TINY = 0x3f490fdb >> 20, 0x42f00000 >> 20, 0x39800000 >> 20


def sincos_f32(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """float32 ``cos(y)`` (``cos``) or ``sin(y)`` as the C library's
    ``cosf``/``sinf`` compute them, for finite y; on y's device."""
    y = y.to(torch.float32)
    u = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    top = (u >> 20) & 0x7FF
    x = y.to(torch.float64)
    small, big = top < _TOP_PIO4, top >= _TOP_120
    # |y| < 120: n = round(y * 2/pi), as (int32(r) + 2^23) >> 24
    r = torch.where(big, torch.zeros_like(x), x) * _HPI_INV
    n_fast = (r.to(torch.int32).to(torch.int64) + 0x800000) >> 24
    x_fast = x - n_fast.to(torch.float64) * _HPI
    # |y| >= 120: the mantissa times 96 bits of 4/pi, from the exponent on
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    idx = (u >> 26) & 15
    xi = ((u & 0xFFFFFF) | 0x800000) << ((u >> 23) & 7)
    res0 = (xi * table[idx]) & 0xFFFFFFFF
    res1 = xi * table[idx + 4]
    res2 = xi * table[idx + 8]
    res0 = ((res2 >> 32) & 0xFFFFFFFF) | (res0 << 32)
    res0 = res0 + res1                          # mod 2^64, as uint64
    n_big = ((res0 + (1 << 61)) >> 62) & 3
    x_big = (res0 - (n_big << 62)).to(torch.float64) * _PI63
    sign = u >> 31
    quadrant = torch.where(big, n_big + sign, n_fast)   # signs and table
    poly_n = torch.where(big, n_big, n_fast)            # sine or cosine
    xr = torch.where(big, x_big, x_fast)
    flip = ((quadrant & 3) == 1) | ((quadrant & 3) == 2)
    xs = torch.where(flip, -xr, xr)
    neg_cos = (quadrant & 2) != 0                       # the second table
    xs = torch.where(small, x, xs)
    x2 = xs * xs
    poly_n = torch.where(small, torch.zeros_like(poly_n), poly_n) + int(cos)
    neg_cos = neg_cos & ~small
    # sine: x + x^3 s1 + x^7 (s2 + x^2 s3)
    x3 = xs * x2
    s1 = _SIN[1] + x2 * _SIN[2]
    x7 = x3 * x2
    sv = xs + x3 * _SIN[0]
    sv = sv + x7 * s1
    # cosine: (c0 + x^2 c1) + x^4 c2 + x^6 (c3 + x^2 c4), negated in table 2
    c = [torch.where(neg_cos, -v, v) for v in
         (torch.full_like(x, v) for v in _COS)]
    x4 = x2 * x2
    c2 = c[3] + x2 * c[4]
    c1 = c[0] + x2 * c[1]
    x6 = x4 * x2
    cv = c1 + x4 * c[2]
    cv = cv + x6 * c2
    out = torch.where((poly_n & 1) == 0, sv, cv)
    tiny = top < _TOP_TINY
    out = torch.where(tiny, torch.ones_like(x) if cos else x, out)
    return out.to(torch.float32)


def rope_tables(s: int, dh: int, theta: float,
                device: Device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (S, 1, dh/2), float32: the reference's
    ``_rope_mpc`` tables, built on the CPU and moved to ``device``."""
    half = dh // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    theta32 = float(torch.tensor(theta, dtype=torch.float32))   # weakly typed
    freqs = (theta32 ** expo.to(torch.float64)).to(torch.float32)
    angles = torch.arange(s, dtype=torch.float32)[:, None] * freqs   # (S, half)
    return (sincos_f32(angles, True)[:, None, :].to(device),
            sincos_f32(angles, False)[:, None, :].to(device))
