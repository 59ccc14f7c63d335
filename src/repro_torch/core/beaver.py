"""Trusted-third-party Beaver triples and the triple providers.

Triples are generated deterministically from a PRNG key, bit-identical to
the reference's ``core/beaver.py`` for the same key (``core.prng`` is
jax's threefry).  Shares carry the leading party dimension.  Arithmetic
members are int64 ring tensors, binary members int32 packed words.
"""
from __future__ import annotations

import dataclasses
from typing import (Iterable, List, Optional, Protocol, Sequence, Tuple, Union,
                    runtime_checkable)

import torch

from .. import errors
# the typed triple errors, re-exported here as the reference's beaver does
from ..errors import TripleBudgetExceeded, TriplePoolExhausted  # noqa: F401
from . import prng, ring, ring_linalg, shares
from .schedule import cone_sets, n_levels


@dataclasses.dataclass(frozen=True)
class ArithTriple:
    """Additive shares of (a, b, c = a*b) on Z/2^64, party dim leading."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BinTriple:
    """XOR shares of packed-word (a, b, c = a & b), party dim leading."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor

    def __getitem__(self, idx) -> "BinTriple":
        """Index every member (the dense per-level stack's leading L axis)."""
        return BinTriple(self.a[idx], self.b[idx], self.c[idx])


def gen_arith(key: torch.Tensor, shape, n_parties: int = 2) -> ArithTriple:
    ka, kb, ksa, ksb, ksc = prng.split(key, 5)
    a = ring.uniform(ka, shape)
    b = ring.uniform(kb, shape)
    return ArithTriple(shares.share(ksa, a, n_parties),
                       shares.share(ksb, b, n_parties),
                       shares.share(ksc, a * b, n_parties))


def gen_matmul(key: torch.Tensor, x_shape, y_shape,
               n_parties: int = 2) -> ArithTriple:
    """Matrix Beaver triple (A, B, C = A @ B mod 2^64) for a secret-by-secret
    matmul of operand shapes ``x_shape @ y_shape`` (batch dims aligned,
    contraction on the trailing pair); C through the ``ring_matmul_ss``
    kernel.  Same key split and draws as the reference's ``gen_matmul``."""
    ka, kb, ksa, ksb, ksc = prng.split(key, 5)
    a = ring.uniform(ka, tuple(x_shape))
    b = ring.uniform(kb, tuple(y_shape))
    return ArithTriple(shares.share(ksa, a, n_parties),
                       shares.share(ksb, b, n_parties),
                       shares.share(ksc, ring_linalg.matmul_ring(a, b), n_parties))


def gen_bin(key: torch.Tensor, shape, n_parties: int = 2) -> BinTriple:
    ka, kb, ksa, ksb, ksc = prng.split(key, 5)
    a = prng.bits_words(ka, shape)
    b = prng.bits_words(kb, shape)
    return BinTriple(shares.xor_share_packed(ksa, a, n_parties),
                     shares.xor_share_packed(ksb, b, n_parties),
                     shares.xor_share_packed(ksc, a & b, n_parties))


@dataclasses.dataclass(frozen=True)
class ReluTriples:
    """Everything one approximate-ReLU evaluation consumes, pre-generated.

    For E elements and a w-bit reduced ring (W = ceil(E/32) packed words,
    L = ceil(log2(w)) Kogge-Stone levels):
      - bin_init:   (P, w, W) AND triple for the initial generate plane
      - bin_levels: (L, P, 2w, W) one batched AND triple per level
      - b2a:        (P, E) arithmetic triple for the sign-bit B2A
      - mult:       (P, E) arithmetic triple for the final x * DReLU(x)
    The cone adder's (``cone=True``, w > 1) are sized to its pruned
    circuit: bin_init is (P, len(init_pos), W) and bin_levels a tuple of
    one (P, 2 max(len(pos), 1), W) triple per level (ragged).
    """

    bin_init: BinTriple
    bin_levels: Union[BinTriple, Tuple[BinTriple, ...]]
    b2a: ArithTriple
    mult: ArithTriple


def gen_relu_triples(key: torch.Tensor, n_elements: int, w: int,
                     n_parties: int = 2, cone: bool = False) -> ReluTriples:
    """One ReLU's triples, for the dense adder or (``cone=True``) the
    MSB-cone-pruned one; an empty cone level still draws a 2-row triple,
    as the reference."""
    W = shares.packed_words(n_elements)
    L = n_levels(w)
    k1, k2, k3, k4 = prng.split(key, 4)
    level_keys = prng.split(k2, max(L, 1))
    if cone and w > 1:
        init_pos, level_sets = cone_sets(w)
        bin_init = gen_bin(k1, (len(init_pos), W), n_parties)
        bin_levels = tuple(gen_bin(k, (2 * max(len(pos), 1), W), n_parties)
                           for k, pos in zip(level_keys, level_sets))
    else:
        bin_init = gen_bin(k1, (w, W), n_parties)
        # (L, P, 2w, W), each level written in as it is drawn: a stack of
        # the drawn levels would hold them twice (55 GB at an exact
        # 512-token PWL group)
        bin_levels = None
        for i, k in enumerate(level_keys):
            t = gen_bin(k, (2 * w, W), n_parties)
            if bin_levels is None:
                bin_levels = BinTriple(*(t.a.new_empty((len(level_keys),) + t.a.shape)
                                         for _ in range(3)))
            for f in ("a", "b", "c"):
                getattr(bin_levels, f)[i].copy_(getattr(t, f))
            del t
    return ReluTriples(bin_init, bin_levels,
                       gen_arith(k3, (n_elements,), n_parties),
                       gen_arith(k4, (n_elements,), n_parties))


def _cat_bin_words(members: Sequence[BinTriple],
                   n_list: Sequence[int]) -> BinTriple:
    """Merge packed triples by concatenating their words on the last axis:
    bit-identical to ``_cat_bin_bits`` when every n_i is a multiple of 32
    (no tail bits, word boundaries do not shift)."""
    return BinTriple(*(torch.cat([getattr(t, f) for t in members], dim=-1)
                       for f in ("a", "b", "c")))


def _cat_bin_bits(members: Sequence[BinTriple],
                  n_list: Sequence[int]) -> BinTriple:
    """Merge packed triples at the bit level, as the reference: unpack each
    stream's words to its n_i bits, concatenate, pack (tail bits zero)."""
    def cat(field: str) -> torch.Tensor:
        bits = [shares.unpack_bits(getattr(t, field), n)
                for t, n in zip(members, n_list)]
        return shares.pack_bits(torch.cat(bits, dim=-1))
    return BinTriple(cat("a"), cat("b"), cat("c"))


def _concat(bundles: Sequence[ReluTriples], n_list: Sequence[int], w: int,
            cone: bool, cat_bin) -> ReluTriples:
    """Merge bundles with ``cat_bin`` for every packed binary member; the
    cone's ragged per-level tuples merge level by level."""
    def cat_arith(members: Sequence[ArithTriple]) -> ArithTriple:
        return ArithTriple(*(torch.cat([getattr(t, f) for t in members], dim=-1)
                             for f in ("a", "b", "c")))

    if cone and w > 1:
        bin_levels = tuple(cat_bin([b.bin_levels[lvl] for b in bundles], n_list)
                           for lvl in range(len(bundles[0].bin_levels)))
    else:
        bin_levels = cat_bin([b.bin_levels for b in bundles], n_list)
    return ReluTriples(cat_bin([b.bin_init for b in bundles], n_list), bin_levels,
                       cat_arith([b.b2a for b in bundles]),
                       cat_arith([b.mult for b in bundles]))


def concat_relu_triples(bundles: Sequence[ReluTriples], n_list: Sequence[int],
                        w: int, cone: bool = False) -> ReluTriples:
    """Merge per-stream ReluTriples (same ring width w) into one bundle for
    the element-wise concatenation of the streams, bit-identical to the
    reference's ``concat_relu_triples``.  Arithmetic members concatenate on
    the element axis.  Packed binary members (``bin_init``, the dense
    ``bin_levels`` stack, each of the cone's per-level triples) concatenate
    their words when every n_i is a multiple of 32; otherwise word
    boundaries shift, and the last stream's tail holds random bits that the
    reference's repack zeroes, so they are repacked at the bit level
    (``_cat_bin_bits``: unpack, concatenate, pack)."""
    if len(bundles) != len(n_list):
        raise ValueError(f"concat_relu_triples: {len(bundles)} bundles vs "
                         f"{len(n_list)} element counts")
    whole_words = all(n % 32 == 0 for n in n_list)
    return _concat(bundles, n_list, w, cone,
                   _cat_bin_words if whole_words else _cat_bin_bits)


# ---------------------------------------------------------------------------
# Triple providers: who supplies the ReluTriples each protocol call consumes
# ---------------------------------------------------------------------------

def gen_plan_triples(key: torch.Tensor, specs: Sequence[Tuple[int, int]],
                     cone: bool = False) -> List[Optional[ReluTriples]]:
    """One ReluTriples bundle per (n_elements, width) spec, in order, each
    from its own split of ``key``; culled (width 0) and empty specs map to
    None.  The offline TTP's bulk generator behind ``Plan.triple_specs()``."""
    keys = prng.split(key, max(len(specs), 1))
    return [None if w == 0 or n == 0 else gen_relu_triples(k, n, w, cone=cone)
            for k, (n, w) in zip(keys, specs)]


def map_bundle(fn, bundle: ReluTriples, *others: ReluTriples) -> ReluTriples:
    """A bundle of ``bundle``'s structure with ``fn(leaf, *other_leaves)``
    at every member field (``others``: bundles, or spec trees, of the same
    structure)."""
    def tri(t, *o):
        return type(t)(*(fn(getattr(t, f), *(getattr(x, f) for x in o))
                         for f in ("a", "b", "c")))

    if isinstance(bundle.bin_levels, tuple):         # cone: ragged per level
        levels = tuple(tri(t, *(o.bin_levels[i] for o in others))
                       for i, t in enumerate(bundle.bin_levels))
    else:                                            # dense: (L, P, 2w, W)
        levels = tri(bundle.bin_levels, *(o.bin_levels for o in others))
    return ReluTriples(tri(bundle.bin_init, *(o.bin_init for o in others)), levels,
                       tri(bundle.b2a, *(o.b2a for o in others)),
                       tri(bundle.mult, *(o.mult for o in others)))


def shard_relu_triples(bundle: ReluTriples, data_index: int,
                       n_shards: int) -> ReluTriples:
    """One data shard's element-axis slice of a ReluTriples bundle, bit for
    bit the reference's ``shard_relu_triples``.

    The inverse direction of ``concat_relu_triples``: the party dimension
    is untouched, arithmetic members (int64) slice the element axis, and
    packed binary members (int32 words) are split at the bit level, since
    word boundaries shift when the per-shard element count is not a
    multiple of 32 (unpack to the E element bits, slice, repack; the words
    themselves are sliced when both ends fall on a word boundary, which
    gives the same words).  Every member comes out contiguous, as the
    kernels take them.  Shard i of n runs the protocol on batch rows
    [i*B/n, (i+1)*B/n) with exactly these triples."""
    E = bundle.b2a.a.shape[-1]
    if E % n_shards:
        raise ValueError(f"shard_relu_triples: {E} elements not divisible by "
                         f"{n_shards} data shards")
    per = E // n_shards
    lo_el, hi_el = data_index * per, (data_index + 1) * per

    def sl(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.dtype == torch.int64:
            return leaf[..., lo_el:hi_el].contiguous()
        if lo_el % 32 == 0 and per % 32 == 0:
            return leaf[..., lo_el // 32:hi_el // 32].contiguous()
        return shares.pack_bits(shares.unpack_bits(leaf, E)[..., lo_el:hi_el])

    return map_bundle(sl, bundle)


def shard_pool(pool: Sequence[Optional[ReluTriples]],
               n_shards: int) -> List[Optional[ReluTriples]]:
    """Every bundle's per-data-shard slices stacked on a NEW leading axis:
    the pool's structure, each leaf with a leading ``n_shards`` dimension
    holding that shard's element slice (the reference's ``shard_pool``).
    ``PrivateModel.serve_step(mesh, data_axis=...)`` takes it as its
    ``triples``: each data shard keeps its own index of that dimension,
    and the party dimension sits where ``pool_party_specs`` says."""

    def stack(bundle):
        if bundle is None:
            return None
        slices = [shard_relu_triples(bundle, i, n_shards) for i in range(n_shards)]
        return map_bundle(lambda *xs: torch.stack(xs), *slices)

    return [stack(b) for b in pool]


def pool_party_specs(pool: Sequence[Optional[ReluTriples]],
                     party_axis: str = "party",
                     data_axis: Optional[str] = None) -> List[Optional[ReluTriples]]:
    """Each pool leaf's partition over the mesh: the reference's
    ``PartitionSpec`` entries, as a tuple per leaf (one mesh axis name or
    None per dimension), in a tree of the pool's structure.

    The party dimension's position is fixed by each member's structure,
    never guessed from its shape: leading for ``bin_init``, the arithmetic
    members and the cone's per-level triples; dim 1 (behind the stacked L
    axis) for the dense ``bin_levels``.  With ``data_axis`` the pool is
    ``shard_pool``'s layout: every leaf gained a leading data-shard
    dimension, so the data axis is dim 0 and the party positions shift one
    to the right."""
    off = 0 if data_axis is None else 1

    def at(party_dim: int):
        def spec(leaf):
            s = [None] * leaf.ndim
            s[party_dim + off] = party_axis
            if data_axis is not None:
                s[0] = data_axis
            return tuple(s)
        return lambda t: type(t)(*(spec(getattr(t, f)) for f in ("a", "b", "c")))

    def bundle_specs(bundle):
        if bundle is None:               # culled / empty call: no triples
            return None
        if isinstance(bundle.bin_levels, tuple):    # cone: ragged per level
            levels = tuple(at(0)(t) for t in bundle.bin_levels)
        else:                                       # dense: (L, P, 2w, W)
            levels = at(1)(bundle.bin_levels)
        return ReluTriples(at(0)(bundle.bin_init), levels,
                           at(0)(bundle.b2a), at(0)(bundle.mult))

    return [bundle_specs(b) for b in pool]


def slice_party_bundle(bundle: Optional[ReluTriples],
                       party: int) -> Optional[ReluTriples]:
    """One party's rows of a full 2-party ``ReluTriples`` bundle, at the
    party positions ``pool_party_specs`` gives; the slice keeps the
    dimension with size 1, the local layout of a per-process transport
    backend (``transport.SocketComm``) and of a size-2 party axis
    (``MeshComm``).  Generate the full bundle from a key both parties
    share, slice to your own index, and the two processes hold a
    consistent triple.
    """
    if bundle is None:
        return None

    def at(leaf: torch.Tensor, spec) -> torch.Tensor:
        d = spec.index("party")
        return leaf[(slice(None),) * d + (slice(party, party + 1),)]

    return map_bundle(at, bundle, pool_party_specs([bundle])[0])


def slice_party_pool(pool: Sequence[Optional[ReluTriples]],
                     party: int) -> List[Optional[ReluTriples]]:
    """Party-local slice of an offline pool (one bundle per ReLU call)."""
    return [slice_party_bundle(b, party) for b in pool]


class PartySlicedTTP:
    """One party's view of a *materialising* triple provider.

    Both parties construct the same base provider from a shared TTP key
    (e.g. ``StreamingTTP``); each wraps it with its own party index and
    keeps only its rows of every generated bundle, so the two processes'
    slices are consistent triples by construction.  The base must
    materialise bundles: an inline provider returning None would make
    each process derive "triples" from its local 1-row layout, which is
    not a valid 2-party sharing, so that is rejected loudly.
    """

    def __init__(self, base, party: int):
        self.base = base
        self.party = int(party)

    def relu_triples(self, n_elements: int, width: int,
                     cone: bool = False) -> Optional[ReluTriples]:
        if width == 0 or n_elements == 0:
            return None
        full = self.base.relu_triples(n_elements, width, cone=cone)
        if full is None:
            raise TypeError(
                "PartySlicedTTP needs a materialising base provider "
                "(StreamingTTP / TriplePool); an inline provider cannot "
                "supply one party's slice of a shared triple")
        return slice_party_bundle(full, self.party)

    def checkpoint(self):
        return self.base.checkpoint()

    def rollback(self, token) -> None:
        self.base.rollback(token)


@runtime_checkable
class TripleProvider(Protocol):
    """Where a Session's protocol calls get their Beaver triples.

    ``relu_triples`` is called once per ReLU call per stream, in call
    order; None means "derive the triples inline from the call's own PRNG
    key".  Width-0 and zero-element calls return None and consume nothing.
    ``checkpoint() -> token`` / ``rollback(token)`` restore the provider's
    stream position, so a retried batch draws the same triples."""

    def relu_triples(self, n_elements: int, width: int,
                     cone: bool = False) -> Optional[ReluTriples]:
        ...

    def checkpoint(self):
        ...

    def rollback(self, token) -> None:
        ...


class InlineTTP:
    """Default provider: triples are derived inline from each protocol
    call's PRNG key (returns None, as the reference's ``InlineTTP``)."""

    def relu_triples(self, n_elements: int, width: int,
                     cone: bool = False) -> None:
        return None

    def checkpoint(self) -> None:
        return None

    def rollback(self, token) -> None:
        pass


class StreamingTTP:
    """Per-call streaming TTP: each bundle is generated on demand from this
    provider's own PRNG stream (independent of the protocol keys), on the
    key's device.

    Example::

        session = api.Session(key=0, provider=StreamingTTP(prng.PRNGKey(7)))
    """

    def __init__(self, key: torch.Tensor):
        self._key = key

    def relu_triples(self, n_elements: int, width: int,
                     cone: bool = False) -> Optional[ReluTriples]:
        if width == 0 or n_elements == 0:
            return None
        self._key, k = prng.split(self._key)
        return gen_relu_triples(k, n_elements, width, cone=cone)

    def checkpoint(self) -> torch.Tensor:
        return self._key

    def rollback(self, token: torch.Tensor) -> None:
        self._key = token


class TriplePool:
    """Precomputed pool consumed in call order: one entry per ReLU call
    per stream, call-major / stream-minor, None for culled or empty calls
    (the layout ``gen_plan_triples`` and ``EagerTTP`` emit)."""

    def __init__(self, bundles: Iterable[Optional[ReluTriples]]):
        self._bundles: List[Optional[ReluTriples]] = list(bundles)
        self.consumed = 0

    def relu_triples(self, n_elements: int, width: int,
                     cone: bool = False) -> Optional[ReluTriples]:
        if self.consumed >= len(self._bundles):
            raise errors.TriplePoolExhausted(
                f"TriplePool exhausted after {self.consumed} ReLU calls — "
                "the pool must hold one bundle per ReLU call per stream")
        tri = self._bundles[self.consumed]
        self.consumed += 1
        return tri

    def checkpoint(self) -> int:
        return self.consumed

    def rollback(self, token: int) -> None:
        self.consumed = token

    def shard(self, data_index: int, n_shards: int) -> "TriplePool":
        """Data shard ``data_index``'s pool: every bundle not yet consumed,
        sliced on the element axis (``shard_relu_triples``).  This pool is
        left as it is, so one call per shard index gives ``n_shards`` pools
        that together cover exactly the unsharded replay."""
        return TriplePool([
            None if b is None else shard_relu_triples(b, data_index, n_shards)
            for b in self._bundles[self.consumed:]])

    def device_bytes(self) -> int:
        """Bytes the pool's tensors hold (the offline artifact's size)."""
        return sum(t.numel() * t.element_size() for b in self._bundles
                   if b is not None for t in relu_tensors(b))


class MeteredProvider:
    """Per-tenant triple metering: wraps any ``TripleProvider``, counts the
    bundles and DReLU elements each ReLU call requires, and optionally
    enforces an element budget (``errors.TripleBudgetExceeded``).  Width-0
    and zero-element calls consume nothing.

    Example::

        provider = MeteredProvider(InlineTTP(), budget_elements=10_000)
        provider.relu_triples(4096, 8)        # meters 4096 elements
    """

    def __init__(self, base: Optional[TripleProvider] = None,
                 budget_elements: Optional[int] = None):
        self.base = base if base is not None else InlineTTP()
        self.budget_elements = budget_elements
        self.consumed_elements = 0
        self.consumed_bundles = 0

    @property
    def remaining_elements(self) -> Optional[int]:
        if self.budget_elements is None:
            return None
        return max(0, self.budget_elements - self.consumed_elements)

    def relu_triples(self, n_elements: int, width: int,
                     cone: bool = False) -> Optional[ReluTriples]:
        if width == 0 or n_elements == 0:
            return self.base.relu_triples(n_elements, width, cone=cone)
        if (self.budget_elements is not None
                and self.consumed_elements + n_elements > self.budget_elements):
            raise errors.TripleBudgetExceeded(
                f"triple budget exhausted: {self.consumed_elements} of "
                f"{self.budget_elements} elements consumed, next call needs "
                f"{n_elements}")
        self.consumed_bundles += 1
        self.consumed_elements += n_elements
        return self.base.relu_triples(n_elements, width, cone=cone)

    def checkpoint(self):
        """The meter's counters and the base provider's position, so a
        rolled-back retry draws the same triples and bills once."""
        return (self.consumed_elements, self.consumed_bundles,
                self.base.checkpoint())

    def rollback(self, token) -> None:
        self.consumed_elements, self.consumed_bundles, base_token = token
        self.base.rollback(base_token)


class EagerTTP(TriplePool):
    """Eager offline TTP: generates, up front, the whole pool for
    ``requests`` sequential replays of a plan's triple specs, each replay
    serving ``streams`` sibling streams, laid out in the order the replays
    pop it (within a replay call-major / stream-minor, replays in turn).

    Example::

        ttp = EagerTTP(prng.PRNGKey(7), plan.triple_specs(), requests=16)
        session = api.Session(key=0, provider=ttp)
    """

    def __init__(self, key: torch.Tensor, specs: Sequence[Tuple[int, int]],
                 cone: bool = False, requests: int = 1, streams: int = 1):
        expanded = [s for s in specs for _ in range(streams)] * requests
        super().__init__(gen_plan_triples(key, expanded, cone=cone))


def relu_tensors(t: ReluTriples) -> List[torch.Tensor]:
    """Every tensor of a bundle: the packed binary members' (int32) first,
    then the arithmetic ones (int64)."""
    levels = t.bin_levels if isinstance(t.bin_levels, tuple) else (t.bin_levels,)
    return [getattr(m, f) for m in (t.bin_init, *levels, t.b2a, t.mult)
            for f in ("a", "b", "c")]
