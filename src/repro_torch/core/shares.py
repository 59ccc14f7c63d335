"""Secret sharing: arithmetic shares on Z/2^64 and packed binary shares.

Arithmetic shares: int64 ring tensors with a leading party dimension,
<x>_0 + <x>_1 = x (mod 2^64).

Binary shares are bit-sliced as in the reference: a w-bit shared value over
E elements is (party, w, W) packed words, W = ceil(E/32), bit t of word j of
plane i holding bit i of element 32j + t.  Words are int32 bit patterns (the
reference's uint32; CUDA kernels read the same memory as ``uint32_t``).
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from . import prng, ring


# ---------------------------------------------------------------------------
# Arithmetic shares
# ---------------------------------------------------------------------------

def share(key: torch.Tensor, x: torch.Tensor, n_parties: int = 2) -> torch.Tensor:
    """Split plaintext ring values into additive shares, party dim leading."""
    masks = [ring.uniform(k, x.shape) for k in prng.split(key, n_parties - 1)]
    first = x
    for m in masks:
        first = first - m
    return torch.stack([first] + masks, dim=0)


def reconstruct(xs: torch.Tensor) -> torch.Tensor:
    """Sum shares over the leading party dimension (mod 2^64)."""
    acc = xs[0]
    for p in range(1, xs.shape[0]):
        acc = acc + xs[p]
    return acc


# ---------------------------------------------------------------------------
# Bit packing (the ``pack`` and ``unpack`` kernels, one bit per plane row)
# ---------------------------------------------------------------------------

def packed_words(n_elements: int) -> int:
    return (n_elements + 31) // 32


def pack_bits(planes: torch.Tensor) -> torch.Tensor:
    """(..., w, E) {0, 1} -> (..., w, W) int32 packed words (E padded)."""
    lead, e = tuple(planes.shape[:-1]), planes.shape[-1]
    rows = planes.reshape(math.prod(lead), e).to(torch.int32).contiguous()
    return kops.pack(rows, 1).reshape(lead + (packed_words(e),))


def unpack_bits(words: torch.Tensor, n_elements: int) -> torch.Tensor:
    """(..., W) packed words -> (..., E) {0, 1} int32."""
    lead = tuple(words.shape[:-1])
    planes = words.reshape(math.prod(lead), 1, words.shape[-1]).contiguous()
    return kops.unpack(planes, n_elements).reshape(lead + (n_elements,))


def xor_share_packed(key: torch.Tensor, words: torch.Tensor,
                     n_parties: int = 2) -> torch.Tensor:
    """XOR-share packed words; adds a leading party dimension."""
    masks = [prng.bits_words(k, words.shape)
             for k in prng.split(key, n_parties - 1)]
    first = words
    for m in masks:
        first = first ^ m
    return torch.stack([first] + masks, dim=0)


def xor_reconstruct(ws: torch.Tensor) -> torch.Tensor:
    """XOR the binary shares over the leading party dimension."""
    out = ws[0]
    for p in range(1, ws.shape[0]):
        out = out ^ ws[p]
    return out
