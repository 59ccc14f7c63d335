"""MPC-friendly attention normalization: softmax -> ReLU + causal mean
(twin of the reference's ``nn/approx/attention.py``).

    softmax(s)_ij  ->  ReLU(s_ij) * causal(i, j) / (i + 1)

keeps the only secret-dependent nonlinearity a ReLU, evaluated on the
reduced ring with a per-site (k, m), while the causal mask and the
1/(i+1) row mean are one PUBLIC multiplier.  Scores are scaled by
dh^-1/2 before the ReLU.  Both evaluations make the same calls: scores =
Q @ K^T (one Beaver open), scale, ReLU via ``relu_fn``, mask-norm, then
A @ V (a second open).
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def causal_norm(s: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(S, S) public multiplier causal(i, j) / (i + 1)."""
    tri = torch.tril(torch.ones((s, s), dtype=dtype, device=device))
    return tri / torch.arange(1, s + 1, dtype=dtype, device=device)[:, None]


def relu_attention(q, k, v, group: int, relu_fn):
    """Plaintext ReLU attention through the relu_fn hook; q, k, v: (B, H,
    S, Dh), kv heads already repeated to H."""
    dh = q.shape[-1]
    s = q.shape[-2]
    scores = relu_fn.matmul(q, torch.swapaxes(k, -1, -2)) * (dh ** -0.5)
    w = relu_fn(scores, group) * causal_norm(s, scores.dtype, scores.device)
    return relu_fn.matmul(w, v)


def relu_attention_mpc(qs: Sequence, ks: Sequence, vs: Sequence, group: int,
                       relu_fn) -> List:
    """Secret-shared ReLU attention over sibling MPCTensor streams: two
    fused open rounds (QK^T and A@V, every stream coalesced) and one
    reduced-ring ReLU pass on the scores; scale and causal mean are local
    public multiplies."""
    dh = qs[0].shape[-1]
    scores = relu_fn.matmul(qs, [k.swapaxes(-1, -2) for k in ks])
    scores = [t.mul_public(dh ** -0.5) for t in scores]
    ws = relu_fn(scores, group)
    ws = [w.mul_public(causal_norm(w.shape[-2], device=w.device)) for w in ws]
    return relu_fn.matmul(ws, vs)
