"""Plain PyTorch forward of the private Qwen1.5-0.5B as ``config.json``
states it, in float32: static-scale norms, q/k/v projections with bias,
rotary embedding (rotate-half, float32 angles), ReLU attention with the
causal mean, the gated MLP with the piecewise-linear SiLU evaluated in
closed form, the lm_head.  It imports nothing of the program and takes
only the weights and hidden states the benchmark made."""
from __future__ import annotations

import math

import torch


def pwl(cfg):
    """(knots, coefficients, c0) of the MLP activation's lowering: secant
    slopes between knots on the uniform grid, ``right_slope`` past the
    last, f(lo) left of the first."""
    act = cfg["mpc_lowering"]["mlp_act"]
    f = {"silu": lambda x: x / (1.0 + math.exp(-x))}[act["fn"]]
    lo, step = act["pwl_lo"], act["pwl_step"]
    n = int(round((act["pwl_hi"] - lo) / step))
    ts = [lo + j * step for j in range(n + 1)]
    vals = [f(t) for t in ts]
    slopes = [(vals[j + 1] - vals[j]) / step for j in range(n)] + [act["right_slope"]]
    coeffs = [slopes[0]] + [slopes[j] - slopes[j - 1] for j in range(1, n + 1)]
    return ts, coeffs, vals[0]


def rope(x, theta: float):
    """x (B, H, T, dh) rotated by position, rotate-half form."""
    t, dh = x.shape[-2], x.shape[-1]
    half = dh // 2
    expo = -torch.arange(half, dtype=torch.float64) / half
    freqs = (float(theta) ** expo).to(torch.float32)
    angles = (torch.arange(t, dtype=torch.float32)[:, None] * freqs).to(torch.float64)
    cos = torch.cos(angles).to(torch.float32).to(x.device)
    sin = torch.sin(angles).to(torch.float32).to(x.device)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(cfg, weights, h: torch.Tensor) -> torch.Tensor:
    """Logits (B, T, vocab) of hidden states h (B, T, d)."""
    b, t, d = h.shape
    heads = cfg["num_attention_heads"]
    dh = d // heads
    ts, coeffs, c0 = pwl(cfg)
    causal = torch.tril(torch.ones(t, t, device=h.device))
    causal = causal / torch.arange(1, t + 1, dtype=torch.float32, device=h.device)[:, None]
    lay = weights["layers"]
    for l in range(cfg["num_hidden_layers"]):
        x = h * lay["ln1"]["scale"][l]
        q, k, v = (x @ lay["attn"][p]["w"][l] + lay["attn"][p]["b"][l]
                   for p in ("wq", "wk", "wv"))
        q, k, v = (y.view(b, t, heads, dh).transpose(1, 2) for y in (q, k, v))
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
        a = torch.relu((q @ k.transpose(-1, -2)) * dh ** -0.5) * causal
        o = (a @ v).transpose(1, 2).reshape(b, t, d)
        h = h + o @ lay["attn"]["wo"]["w"][l]
        x = h * lay["ln2"]["scale"][l]
        up, gate = x @ lay["mlp"]["w_up"][l], x @ lay["mlp"]["w_gate"][l]
        act = torch.full_like(gate, c0)
        for knot, a_j in zip(ts, coeffs):
            act += a_j * torch.relu(gate - knot)
        h = h + (act * up) @ lay["mlp"]["w_down"][l]
    return (h * weights["final_norm"]["scale"]) @ weights["lm_head"]["w"]
