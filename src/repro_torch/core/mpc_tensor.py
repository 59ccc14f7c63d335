"""MPCTensor: the user-facing secret-shared tensor (twin of the reference's
``core/mpc_tensor.py``).

Carries int64 ring shares with a leading party dimension plus the
fixed-point scale.  Linear ops with public weights and structural ops
(transpose, repeat, indexing, stack, concat) are local (no
communication); secret-by-secret products open one Beaver round
(``products_many``); ReLU runs the GMW protocol with an optional
HummingBird reduced-ring config.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import Device, resolve as resolve_device
from . import beaver, comm as comm_lib, fixed, gmw, prng, ring, ring_linalg, shares
from .hummingbird import HBLayer


def encode_weights(w_f, frac_bits: int = fixed.DEFAULT_FRAC_BITS,
                   device: Device = None) -> torch.Tensor:
    """Public float weights -> fixed-point int32 (|w * 2^f| < 2^31), on
    ``device`` (default the GPU)."""
    w = torch.as_tensor(w_f, dtype=torch.float32, device=resolve_device(device))
    return torch.round(w * (2.0 ** frac_bits)).to(torch.int32)


def _encode_host_scalar(c_f, frac_bits: int) -> Optional[int]:
    """A public constant given as a host number (Python or numpy scalar),
    encoded on the host exactly as ``encode_weights`` encodes it (float32
    product, round half to even, int32); None for a tensor.  A host number
    never becomes a device tensor by a copy from host memory, which a
    captured CUDA graph does not allow."""
    if isinstance(c_f, torch.Tensor) or np.ndim(c_f) != 0:
        return None
    enc = np.round(np.float32(c_f) * np.float32(2.0 ** frac_bits))
    return int(enc.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class MPCTensor:
    data: torch.Tensor            # int64 ring shares, party dim leading
    frac_bits: int = fixed.DEFAULT_FRAC_BITS

    # -- construction / reveal ------------------------------------------------
    @staticmethod
    def from_plain(key: torch.Tensor, x_f: torch.Tensor, n_parties: int = 2,
                   frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> "MPCTensor":
        return MPCTensor(shares.share(key, fixed.encode(x_f, frac_bits), n_parties),
                         frac_bits)

    def reveal(self) -> torch.Tensor:
        return fixed.decode(shares.reconstruct(self.data), self.frac_bits)

    def reveal_np(self) -> np.ndarray:
        return fixed.decode_np(shares.reconstruct(self.data), self.frac_bits)

    @property
    def shape(self):
        return tuple(self.data.shape[1:])          # without the party dim

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- local linear ops ------------------------------------------------------
    def __add__(self, other: "MPCTensor") -> "MPCTensor":
        assert self.frac_bits == other.frac_bits
        return MPCTensor(self.data + other.data, self.frac_bits)

    def __sub__(self, other: "MPCTensor") -> "MPCTensor":
        assert self.frac_bits == other.frac_bits
        return MPCTensor(self.data - other.data, self.frac_bits)

    def add_public(self, b_f, comm=None) -> "MPCTensor":
        """Add a public constant: only party 0 adds it to its share."""
        comm = comm or comm_lib.SimComm()
        v = _encode_host_scalar(b_f, self.frac_bits)
        if v is not None:
            enc = torch.full(self.shape, v, dtype=torch.int64, device=self.device)
        else:
            b = torch.as_tensor(b_f, dtype=torch.float32, device=self.device)
            enc = fixed.encode(torch.broadcast_to(b, self.shape), self.frac_bits)
        p0 = comm.party_is(0, self.data)
        return MPCTensor(self.data + torch.where(p0, enc, torch.zeros_like(enc)),
                         self.frac_bits)

    def truncate(self, n: Optional[int] = None) -> "MPCTensor":
        """Fixed-point rescale: arithmetic shift of each signed share
        (SecureML-style local truncation, +-1 LSB error, rare wrap)."""
        n = self.frac_bits if n is None else n
        return MPCTensor(ring.rshift_arith(self.data, n), self.frac_bits)

    def mul_public(self, c_f) -> "MPCTensor":
        v = _encode_host_scalar(c_f, self.frac_bits)
        if v is not None:
            prod = self.data * v
        else:
            w = encode_weights(c_f, self.frac_bits, self.device)
            prod = self.data * ring.from_int32(torch.broadcast_to(w, self.shape))
        return MPCTensor(prod, self.frac_bits).truncate()

    def matmul_public(self, w_f) -> "MPCTensor":
        """x @ W with public float weights [K, N]; local + truncation."""
        w = encode_weights(w_f, self.frac_bits, self.device)
        return MPCTensor(ring_linalg.matmul_pub(self.data, w),
                         self.frac_bits).truncate()

    def conv2d_public(self, w_f, stride: int = 1,
                      padding: int = 0) -> "MPCTensor":
        """NCHW conv with public float weights [Cout, Cin, kh, kw]."""
        w = encode_weights(w_f, self.frac_bits, self.device)
        return MPCTensor(ring_linalg.conv2d_pub(self.data, w, stride, padding),
                         self.frac_bits).truncate()

    def avg_pool(self, window: int) -> "MPCTensor":
        """Non-overlapping average pooling on [..., C, H, W]."""
        h, w = self.shape[-2], self.shape[-1]
        oh, ow = h // window, w // window
        a = self.data[..., : oh * window, : ow * window]
        a = a.reshape(a.shape[:-2] + (oh, window, ow, window))
        return MPCTensor(a.sum(dim=(-3, -1)),
                         self.frac_bits).mul_public(1.0 / (window * window))

    def global_avg_pool(self) -> "MPCTensor":
        """[..., C, H, W] -> [..., C] mean over spatial dims."""
        h, w = self.shape[-2], self.shape[-1]
        return MPCTensor(self.data.sum(dim=(-2, -1)),
                         self.frac_bits).mul_public(1.0 / (h * w))

    def reshape(self, *shape) -> "MPCTensor":
        return MPCTensor(self.data.reshape((self.data.shape[0],) + tuple(shape)),
                         self.frac_bits)

    def transpose(self, *perm) -> "MPCTensor":
        """Permute the logical axes (the party dim stays leading)."""
        if len(perm) == 1 and isinstance(perm[0], (tuple, list)):
            perm = tuple(perm[0])
        nd = len(self.shape)
        return MPCTensor(self.data.permute((0,) + tuple(a % nd + 1 for a in perm)),
                         self.frac_bits)

    def swapaxes(self, a1: int, a2: int) -> "MPCTensor":
        nd = len(self.shape)
        perm = list(range(nd))
        perm[a1 % nd], perm[a2 % nd] = perm[a2 % nd], perm[a1 % nd]
        return self.transpose(*perm)

    def repeat(self, reps: int, axis: int) -> "MPCTensor":
        """``jnp.repeat`` along a logical axis (public structural op)."""
        return MPCTensor(torch.repeat_interleave(self.data, reps,
                                                 dim=axis % len(self.shape) + 1),
                         self.frac_bits)

    def __getitem__(self, idx) -> "MPCTensor":
        """Index/slice the logical axes (party dim untouched)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return MPCTensor(self.data[(slice(None),) + idx], self.frac_bits)

    # -- secret * secret products ---------------------------------------------
    def mul(self, other: "MPCTensor", key: torch.Tensor, comm=None,
            triple: Optional[beaver.ArithTriple] = None) -> "MPCTensor":
        """Elementwise secret*secret product (one Beaver open round)."""
        return products_many(["mul"], [key], [self], [other], comm=comm,
                             triples_list=[triple])[0]

    def matmul(self, other: "MPCTensor", key: torch.Tensor, comm=None,
               triple: Optional[beaver.ArithTriple] = None) -> "MPCTensor":
        """Secret@secret matmul (one matrix-Beaver open round)."""
        return products_many(["matmul"], [key], [self], [other], comm=comm,
                             triples_list=[triple])[0]

    # -- the nonlinear op ------------------------------------------------------
    def relu(self, key: torch.Tensor, comm=None, hb: HBLayer = HBLayer(),
             triples: Optional[beaver.ReluTriples] = None,
             cone: bool = False) -> "MPCTensor":
        """GMW ReLU; ``hb`` selects the HummingBird reduced ring (k, m).  A
        width-0 ``hb`` (k == m) is the paper's culling mode: the identity at
        zero communication."""
        return relu_many([key], [self], comm=comm, hbs=[hb],
                         triples_list=[triples], cone=cone)[0]


def relu_many(keys, tensors: Sequence[MPCTensor], comm=None,
              hbs: Optional[Sequence[HBLayer]] = None,
              triples_list: Optional[Sequence] = None,
              cone: bool = False, auto_batch: bool = True) -> list:
    """Round-shared GMW ReLU over sibling MPCTensors (see
    ``gmw.relu_many``).  ``keys[i]`` is consumed exactly as the reference:
    when no triples are given, it splits into a triple key and a protocol
    key.  Identity (width-0) layers and empty tensors pass through."""
    comm = comm or comm_lib.SimComm()
    n_t = len(tensors)
    hbs = list(hbs) if hbs is not None else [HBLayer()] * n_t
    triples_list = list(triples_list) if triples_list is not None else [None] * n_t
    keys = list(keys)
    if not (len(keys) == n_t == len(hbs) == len(triples_list)):
        raise ValueError(
            f"relu_many: mismatched lengths keys={len(keys)} "
            f"tensors={n_t} hbs={len(hbs)} triples={len(triples_list)}")
    out: list = [None] * n_t
    flats, run_keys, tris, kms, order = [], [], [], [], []
    for i, (t, hb, key, tri) in enumerate(zip(tensors, hbs, keys, triples_list)):
        if hb.is_identity:
            out[i] = t
            continue
        n = math.prod(t.shape)
        if tri is None:
            kt, key = prng.split(key)
            tri = beaver.gen_relu_triples(kt, n, hb.width,
                                          n_parties=t.data.shape[0], cone=cone)
        flats.append(t.data.reshape((t.data.shape[0], n)))
        run_keys.append(key)
        tris.append(tri)
        kms.append((hb.k, hb.m))
        order.append(i)
    rets = gmw.relu_many(run_keys, flats, tris, comm, kms, cone=cone,
                         auto_batch=auto_batch)
    for j, i in enumerate(order):
        t = tensors[i]
        out[i] = MPCTensor(rets[j].reshape((t.data.shape[0],) + t.shape),
                           t.frac_bits)
    return out


def stack(tensors: Sequence[MPCTensor], axis: int = 0) -> MPCTensor:
    """Stack sibling MPCTensors along a new *logical* axis."""
    fb = tensors[0].frac_bits
    assert all(t.frac_bits == fb for t in tensors)
    ax = axis % (len(tensors[0].shape) + 1) + 1
    return MPCTensor(torch.stack([t.data for t in tensors], dim=ax), fb)


def concat(tensors: Sequence[MPCTensor], axis: int = 0) -> MPCTensor:
    """Concatenate sibling MPCTensors along an existing *logical* axis."""
    fb = tensors[0].frac_bits
    assert all(t.frac_bits == fb for t in tensors)
    ax = axis % len(tensors[0].shape) + 1
    return MPCTensor(torch.cat([t.data for t in tensors], dim=ax), fb)


def products_many(kinds: Sequence[str], keys, xs: Sequence[MPCTensor],
                  ys: Sequence[MPCTensor], comm=None,
                  triples_list: Optional[Sequence] = None) -> list:
    """Round-shared secret*secret products over sibling MPCTensor pairs
    (``gmw.products_many``: every pair's single open in ONE round).
    ``kinds[i]`` is "mul" (elementwise, equal shapes) or "matmul" (batched,
    contraction on the trailing pair).  ``keys[i]`` derives the pair's
    triple when ``triples_list`` leaves it None (``beaver.gen_matmul`` or
    ``gen_arith`` on the key itself, as the reference).  Each product of
    two ``frac_bits`` operands is truncated back once."""
    comm = comm or comm_lib.SimComm()
    n_t = len(xs)
    triples_list = list(triples_list) if triples_list is not None else [None] * n_t
    keys = list(keys)
    if not (len(kinds) == n_t == len(ys) == len(keys) == len(triples_list)):
        raise ValueError(
            f"products_many: mismatched lengths kinds={len(kinds)} xs={n_t} "
            f"ys={len(ys)} keys={len(keys)} triples={len(triples_list)}")
    specs = []
    for kind, key, x, y, tri in zip(kinds, keys, xs, ys, triples_list):
        assert x.frac_bits == y.frac_bits
        if tri is None:
            n_parties = x.data.shape[0]
            if kind == "matmul":
                tri = beaver.gen_matmul(key, x.shape, y.shape, n_parties=n_parties)
            elif kind == "mul":
                assert x.shape == y.shape, (x.shape, y.shape)
                tri = beaver.gen_arith(key, x.shape, n_parties=n_parties)
            else:
                raise ValueError(f"unknown product kind {kind!r}")
        specs.append((kind, x.data, y.data, tri))
    rets = gmw.products_many(specs, comm)
    return [MPCTensor(r, x.frac_bits).truncate() for r, x in zip(rets, xs)]


MPCTensor.relu_many = staticmethod(relu_many)
MPCTensor.products_many = staticmethod(products_many)
MPCTensor.stack = staticmethod(stack)
