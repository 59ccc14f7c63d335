"""GMW protocol: A2B, DReLU, B2A, exact ReLU (Eq. 2) and HummingBird's
reduced-ring approximate ReLU (Eq. 3), round-fused engine.

Twin of the reference's ``core/gmw.py`` on the generator loop.  Every
primitive is a round generator (``*_rounds``) that yields one wire payload
per communication round and is sent the peer's payload back:

  - A2B prep: each party XOR-shares its arithmetic share      (1 round)
  - adder: initial AND + ceil(log2 w) batched ANDs            (1+L rounds)
  - B2A of the sign bit: one Beaver mult on Z/2^64            (1 round)
  - final x * DReLU(x): one Beaver mult on Z/2^64             (1 round)

and the transformer's secret-by-secret products (``products_many``): one
Beaver open per elementwise product or matmul, its local combine through
the ``ring_matmul_ss`` kernel.

``drive`` runs one generator with one ``comm.swap`` per round;
``run_streams`` / ``relu_many`` advance sibling generators in lockstep and
coalesce each round into ONE exchange.  Round-local compute runs in the
CUDA kernels of ``kernels/ops.py``: ``pack_ring`` packs the reduced-ring
bits straight from the shares, XORed with the A2B masks, the dense
Kogge-Stone adder runs on ``beaver_and`` (its initial AND, opening the
exchanged (d, e) itself), ``ks_mask`` (its first level), ``ks_step`` (one
launch between two exchanges) and ``ks_combine`` (its last level), the
MSB-cone-pruned adder (``cone=True``) on ``cone_step`` (one launch between
two exchanges, the last one writing the sign plane), and ``unpack`` opens
the sign plane.  Shares are bit-identical to the reference for the same
keys, triples and inputs.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kops
from . import (beaver, comm as comm_lib, prng, ring_linalg, schedule as schedule_lib,
               shares)


# ---------------------------------------------------------------------------
# Round-generator drivers
# ---------------------------------------------------------------------------

def drive(gen, comm):
    """Run one round generator to completion: one ``comm.swap`` per round."""
    try:
        payload = gen.send(None)
        while True:
            payload = gen.send(comm.swap(payload))
    except StopIteration as e:
        return e.value


def run_streams(comm, streams: Sequence, on_round=None) -> List:
    """Advance N round generators in lockstep, coalescing each round into
    one exchange; streams that finish early drop out.  ``on_round(r)``
    fires after fused round r.  Returns each stream's result, in order."""
    cc = (comm if isinstance(comm, comm_lib.CoalescingComm)
          else comm_lib.CoalescingComm(comm))
    results: List = [None] * len(streams)
    live = {}
    for i, s in enumerate(streams):
        try:
            live[i] = (s, s.send(None))
        except StopIteration as e:   # zero-round stream
            results[i] = e.value
    r = 0
    while live:
        handles = {i: cc.enqueue(payload) for i, (_, payload) in live.items()}
        opened = cc.flush()
        nxt = {}
        for i, (s, _) in live.items():
            try:
                nxt[i] = (s, s.send(opened[handles[i]]))
            except StopIteration as e:
                results[i] = e.value
        live = nxt
        if on_round is not None:
            on_round(r)
        r += 1
    return results


def _sel_words(comm, template: torch.Tensor) -> torch.Tensor:
    """One word per party: all-ones on party 0, zero on the others (the
    Beaver open correction), as the kernels take it."""
    p0 = comm.party_is(0, template).reshape(-1)
    return torch.where(p0, -1, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# Secure AND on packed binary shares (one communication round)
# ---------------------------------------------------------------------------

def _masked_payload(x, y, a, b) -> torch.Tensor:
    """The (P, 2, ..., W) payload of a Beaver AND: x ^ a then y ^ b per
    party, written straight into the send buffer."""
    send = torch.empty((x.shape[0], 2) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    torch.bitwise_xor(x, a, out=send[:, 0])
    torch.bitwise_xor(y, b, out=send[:, 1])
    return send


def _and_open_rounds(x, y, triple: beaver.BinTriple, comm, sel=None):
    """Round generator for z = x & y on XOR-shared packed words; the
    opening form of ``beaver_and`` opens the exchanged (d, e) itself."""
    send = _masked_payload(x, y, triple.a, triple.b)
    opened = yield send                         # single exchange
    return kops.beaver_and(send[:, 0], send[:, 1], triple.a, triple.b, triple.c,
                           _sel_words(comm, x) if sel is None else sel,
                           opened[:, 0], opened[:, 1])


def and_open(x, y, triple: beaver.BinTriple, comm) -> torch.Tensor:
    """z = x & y on XOR-shared packed words. One swap (round) of (d, e)."""
    return drive(_and_open_rounds(x, y, triple, comm), comm)


# ---------------------------------------------------------------------------
# Kogge-Stone adder over packed bitplanes -> MSB (sign) of x + y mod 2^w
# ---------------------------------------------------------------------------

def _adder_msb_rounds(xw, yw, triples: beaver.ReluTriples, comm, w: int,
                      cone: bool):
    """Round generator for the MSB of (x + y mod 2^w).  Dense: the initial
    AND, then one exchange per level; level 0's (d, e) come from
    ``ks_mask``, every later level's from ``ks_step`` (the previous
    level's combine fused with this level's mask, g updated in place),
    each as the (P, 2, 2w, W) payload the generator yields; the last
    level's combine keeps only g (``ks_combine`` without p).  Cone: only
    the backward cone of the carry into bit w-1 (``schedule.cone_sets``),
    one ``cone_step`` after each exchange (``_cone_rounds``)."""
    p0 = xw ^ yw                      # initial propagate (local)
    if w == 1:
        return p0[..., 0, :]
    sel = _sel_words(comm, xw)
    if cone:
        return (yield from _cone_rounds(xw, yw, p0, triples, sel, w))
    g = yield from _and_open_rounds(xw, yw, triples.bin_init, comm, sel)
    n_lv = schedule_lib.n_levels(w)
    levels = triples.bin_levels
    # each level's send buffer is new (the exchange may still hold the last)
    send = kops.ks_mask(g, p0, levels.a[0], levels.b[0], 1)
    for lvl in range(n_lv):
        tri = levels[lvl]
        opened = yield send                                   # one round
        if lvl + 1 < n_lv:
            nxt = levels[lvl + 1]
            g, send = kops.ks_step(send, opened[:, 0], opened[:, 1], tri.a,
                                   tri.b, tri.c, sel, g, nxt.a, nxt.b,
                                   2 << lvl)
        else:
            g, _ = kops.ks_combine(send[:, 0], opened[:, 0], send[:, 1],
                                   opened[:, 1], tri.a, tri.b, tri.c, sel, g,
                                   need_p=False)
    # carry into bit (w-1) is the prefix-generate of bit (w-2)
    return p0[..., w - 1, :] ^ g[..., w - 2, :]


@functools.lru_cache(maxsize=None)
def _cone_levels(w: int):
    """The cone's static layout, once per w: per non-empty level, its
    number and the first, step and count of the positions it updates.
    Every level's positions step by 2^(level+1) (``schedule.cone_sets``),
    so each is a strided slice of the planes; the initial AND covers
    planes 0..w-2."""
    init_pos, level_sets = schedule_lib.cone_sets(w)
    assert init_pos == list(range(w - 1))
    levels = []
    for lvl, pos in enumerate(level_sets):
        if pos:
            step = 2 << lvl
            assert pos == list(range(pos[0], pos[-1] + 1, step))
            levels.append((lvl, pos[0], step, len(pos)))
    return tuple(levels)


def _cone_rounds(xw, yw, p0, triples: beaver.ReluTriples, sel, w: int):
    """The cone adder's rounds on dense planes: g (P, w-1, W) prefix
    generates and p0 (P, w, W) as the prefix propagates, both updated in
    place; the reference's per-position dicts become strided rows.  The
    initial AND's payload is built here; after every exchange one
    ``cone_step`` opens and ANDs the round, updates g and p, and writes the
    next non-empty level's payload, or, after the last, the sign plane it
    returns.  Levels whose cone slice is empty run no round; planes outside
    the cone are never read."""
    tri, level = triples.bin_init, None
    send = _masked_payload(xw[..., :w - 1, :], yw[..., :w - 1, :], tri.a, tri.b)
    g = torch.empty(tri.a.shape, dtype=tri.a.dtype, device=tri.a.device)
    for lvl, first, step, _ in _cone_levels(w):
        opened = yield send                                    # one round
        nxt = triples.bin_levels[lvl]
        send = kops.cone_step(send, opened[:, 0], opened[:, 1], tri.a, tri.b,
                              tri.c, sel, g, p0, level, (first, step, 1 << lvl),
                              nxt.a, nxt.b)
        tri, level = nxt, (first, step)
    opened = yield send                                        # the last round
    return kops.cone_step(send, opened[:, 0], opened[:, 1], tri.a, tri.b, tri.c,
                          sel, g, p0, level)


def adder_msb(xw, yw, triples: beaver.ReluTriples, comm, w: int,
              cone: bool = False) -> torch.Tensor:
    """XOR shares (P, W) of the MSB of (x + y mod 2^w) from (P, w, W)
    packed plane shares of the two addends."""
    return drive(_adder_msb_rounds(xw, yw, triples, comm, w, cone), comm)


# ---------------------------------------------------------------------------
# A2B prep: XOR-share each party's (reduced-ring) arithmetic share
# ---------------------------------------------------------------------------

def _a2b_mask(key, planes_shape: Sequence[int], comm) -> torch.Tensor:
    """Each party's A2B mask words for its (w, W) packed planes: every
    party derives the full (n_parties, w, W) masks from the shared key and
    keeps its own rows (``party_slice``)."""
    full = prng.bits_words(key, (comm.n_parties,) + tuple(planes_shape))
    return comm.party_slice(full)


def _a2b_share_rounds(masked: torch.Tensor, r: torch.Tensor, comm):
    """The A2B round, from each party's masked planes v ^ r and mask r."""
    other_mask = yield r
    p0 = comm.party_is(0, masked)
    x0_shares = torch.where(p0, masked, other_mask)   # shares of party 0's value
    x1_shares = torch.where(p0, other_mask, masked)   # shares of party 1's value
    return x0_shares, x1_shares


def a2b_prepare(key, v_packed: torch.Tensor, comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """From each party's packed planes (P, w, W) of its own arithmetic
    share, XOR shares of party 0's and party 1's values.  One round."""
    r = _a2b_mask(key, v_packed.shape[1:], comm)
    return drive(_a2b_share_rounds(v_packed ^ r, r, comm), comm)


# ---------------------------------------------------------------------------
# Beaver multiplication on Z/2^64 (one round)
# ---------------------------------------------------------------------------

def _beaver_mul_rounds(x: torch.Tensor, y: torch.Tensor,
                       triple: beaver.ArithTriple, comm):
    e = x - triple.a
    f = y - triple.b
    other = yield torch.stack([e, f], dim=1)         # single exchange
    e_open = e + other[:, 0]
    f_open = f + other[:, 1]
    z = triple.c + (e_open * triple.b + f_open * triple.a)
    p0 = comm.party_is(0, z)
    return torch.where(p0, z + e_open * f_open, z)


def beaver_mul(x: torch.Tensor, y: torch.Tensor, triple: beaver.ArithTriple,
               comm) -> torch.Tensor:
    return drive(_beaver_mul_rounds(x, y, triple, comm), comm)


def _beaver_matmul_rounds(x: torch.Tensor, y: torch.Tensor,
                          triple: beaver.ArithTriple, comm):
    """Round generator for Z = X @ Y on additive shares (batch dims aligned,
    contraction on the trailing pair).  Both parties open E = X - A and
    F = Y - B in ONE exchange, the flattened concatenation of both
    differences (size(X) + size(Y) ring elements a party, the wire layout
    of the reference), and combine locally,

        Z_p = C_p + E @ B_p + A_p @ F + [p == 0] E @ F
            = C_p + [E | A_p] @ [B_p + [p == 0] F ; F],

    the second form one ``ring_matmul_ss`` launch with K doubled (equal
    mod 2^64 to the reference's three products)."""
    parties = x.shape[0]
    e = x - triple.a
    f = y - triple.b
    ne = e[0].numel()
    other = yield torch.cat([e.reshape(parties, -1), f.reshape(parties, -1)], dim=1)
    e_open = e + other[:, :ne].reshape(e.shape)
    f_open = f + other[:, ne:].reshape(f.shape)
    p0 = comm.party_is(0, f_open)
    lhs = torch.cat([e_open, triple.a], dim=-1)
    rhs = torch.cat([triple.b + torch.where(p0, f_open, 0), f_open], dim=-2)
    return triple.c + ring_linalg.matmul_ring(lhs, rhs)


def beaver_matmul(x: torch.Tensor, y: torch.Tensor, triple: beaver.ArithTriple,
                  comm) -> torch.Tensor:
    """Z = X @ Y on additive shares; one communication round."""
    return drive(_beaver_matmul_rounds(x, y, triple, comm), comm)


def products_many(specs: Sequence[Tuple[str, torch.Tensor, torch.Tensor,
                                        beaver.ArithTriple]],
                  comm) -> List[torch.Tensor]:
    """Round-shared Beaver products over sibling streams: ``specs`` holds
    one ``(kind, x, y, triple)`` per stream, ``kind`` "mul" (elementwise)
    or "matmul"; every stream's single open is coalesced into ONE exchange.
    Returns the per-stream ring results in order."""
    gens = []
    for kind, x, y, tri in specs:
        if kind == "mul":
            gens.append(_beaver_mul_rounds(x, y, tri, comm))
        elif kind == "matmul":
            gens.append(_beaver_matmul_rounds(x, y, tri, comm))
        else:
            raise ValueError(f"products_many: unknown kind {kind!r}")
    return run_streams(comm, gens)


# ---------------------------------------------------------------------------
# B2A of a single packed bit plane -> arithmetic shares of the bit
# ---------------------------------------------------------------------------

def _b2a_bit_rounds(bits: torch.Tensor, triple: beaver.ArithTriple, comm):
    b = bits.to(torch.int64)
    zero = torch.zeros_like(b)
    p0 = comm.party_is(0, b)
    x = torch.where(p0, b, zero)
    y = torch.where(p0, zero, b)
    xy = yield from _beaver_mul_rounds(x, y, triple, comm)
    return b - (xy << 1)


def b2a_bit(bits: torch.Tensor, triple: beaver.ArithTriple, comm) -> torch.Tensor:
    """bits: (P, E) XOR shares in {0, 1} -> additive shares of the bit:
    b = b0 + b1 - 2*b0*b1, the cross term by one Beaver mult."""
    return drive(_b2a_bit_rounds(bits, triple, comm), comm)


# ---------------------------------------------------------------------------
# DReLU / ReLU (exact and reduced-ring)
# ---------------------------------------------------------------------------

def _drelu_rounds(key, x: torch.Tensor, triples: beaver.ReluTriples, comm,
                  k: int, m: int, cone: bool):
    w = k - m
    n = x.shape[-1]
    # the A2B masks r, then v ^ r packed straight from the shares in one
    # launch (P, w, W)
    r = _a2b_mask(key, tuple(x.shape[1:-1]) + (w, (n + 31) // 32),
                  comm).contiguous()
    masked = kops.pack_ring(x.contiguous(), k, m, mask=r)
    x0s, x1s = yield from _a2b_share_rounds(masked, r, comm)          # 1 round
    sign_packed = yield from _adder_msb_rounds(x0s, x1s, triples, comm, w, cone)
    sign_bits = shares.unpack_bits(sign_packed, n)                    # (P, E)
    s = yield from _b2a_bit_rounds(sign_bits, triples.b2a, comm)      # 1 round
    p0 = comm.party_is(0, s)
    return torch.where(p0, 1 - s, -s)


def drelu(key, x: torch.Tensor, triples: beaver.ReluTriples, comm,
          k: int = 64, m: int = 0, cone: bool = False) -> torch.Tensor:
    """Arithmetic shares of DReLU(x) evaluated on the reduced ring [k:m]
    (k = 64, m = 0 is the exact baseline).  x: ring shares (P, E)."""
    return drive(_drelu_rounds(key, x, triples, comm, k, m, cone), comm)


def relu_rounds(key, x: torch.Tensor, triples: beaver.ReluTriples, comm,
                k: int = 64, m: int = 0, cone: bool = False):
    """Round generator for one full ReLU (compose with ``run_streams``)."""
    d = yield from _drelu_rounds(key, x, triples, comm, k, m, cone)
    out = yield from _beaver_mul_rounds(x, d, triples.mult, comm)
    return out


def relu(key, x: torch.Tensor, triples: beaver.ReluTriples, comm,
         k: int = 64, m: int = 0, cone: bool = False) -> torch.Tensor:
    """ReLU(x) = x * DReLU(x[k:m]) (Eq. 3; Eq. 2 when k=64, m=0).  The
    final multiplication always uses the full-ring share x."""
    return drive(relu_rounds(key, x, triples, comm, k, m, cone), comm)


def relu_many(keys, xs: Sequence[torch.Tensor],
              triples_list: Sequence[Optional[beaver.ReluTriples]], comm,
              kms: Sequence[Tuple[int, int]], cone: bool = False,
              auto_batch: bool = True) -> List[torch.Tensor]:
    """Round-shared evaluation of N concurrent ReLU groups.

    Every protocol round across all groups is ONE coalesced exchange
    (rounds = max over groups).  Width-0 groups (k == m) and empty groups
    cost nothing.  With ``auto_batch`` sibling groups of identical
    (n_elements, k, m) merge into ONE stream on the element axis, their
    triples merged bit-exactly (``beaver.concat_relu_triples``) and the
    protocol randomness taken from the first member's key, exactly as the
    reference.  Returns per-group ring results in order.
    """
    if not (len(keys) == len(xs) == len(triples_list) == len(kms)):
        raise ValueError(
            f"relu_many: mismatched lengths keys={len(keys)} xs={len(xs)} "
            f"triples={len(triples_list)} kms={len(kms)}")
    cc = (comm if isinstance(comm, comm_lib.CoalescingComm)
          else comm_lib.CoalescingComm(comm))
    results: List[Optional[torch.Tensor]] = [None] * len(xs)
    groups: dict = {}
    for i, (key, x, tr, (k, m)) in enumerate(zip(keys, xs, triples_list, kms)):
        n = x.shape[-1]
        if k == m or n == 0:             # culled identity / empty batch
            results[i] = x
            continue
        bkey = (n, k, m) if auto_batch else i
        groups.setdefault(bkey, []).append((i, key, x, tr, k, m))
    stream_args, placements = [], []
    for members in groups.values():
        i0, key0, x0, tr0, k, m = members[0]
        if len(members) == 1:
            stream_args.append((key0, x0, tr0, k, m))
            placements.append([(i0, 0, x0.shape[-1])])
            continue
        n = x0.shape[-1]
        xcat = torch.cat([e[2] for e in members], dim=-1)
        tcat = beaver.concat_relu_triples([e[3] for e in members],
                                          [n] * len(members), k - m, cone=cone)
        stream_args.append((key0, xcat, tcat, k, m))
        placements.append([(e[0], j * n, n) for j, e in enumerate(members)])
    outs = run_streams(cc, [relu_rounds(key0, x0, tr0, cc, k=k, m=m, cone=cone)
                            for key0, x0, tr0, k, m in stream_args])
    for slices, out in zip(placements, outs):
        if len(slices) == 1:
            results[slices[0][0]] = out
        else:
            for i, off, n in slices:
                results[i] = out[..., off:off + n]
    return results


def n_rounds(w: int) -> int:
    """Communication rounds for one ReLU (0 for a culled layer)."""
    return schedule_lib.stream_rounds(w)
