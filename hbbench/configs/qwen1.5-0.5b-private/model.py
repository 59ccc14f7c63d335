"""The private Qwen1.5-0.5B (``config.json``): weights and hidden states
from the seed, made on the device; the program bound to them; the cell's
work.  Weights in the port's tree layout (``layers`` stacked on a leading
layer axis, projections [in, out])."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from hbbench.lib import rng


def dims(cfg: Dict):
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], d, heads, d // heads,
            cfg["intermediate_size"], cfg["vocab_size"])


def seq_len(cfg: Dict) -> int:
    return int(cfg["seq_len"])


def knots(cfg: Dict) -> int:
    act = cfg["mpc_lowering"]["mlp_act"]
    return int(round((act["pwl_hi"] - act["pwl_lo"]) / act["pwl_step"])) + 1


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The params tree from the seed: one normal draw per leaf kind over
    every layer (a few large calls)."""
    L, d, _, _, f, v = dims(cfg)
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("grouped KV heads are not laid out here")

    def draw(tag, shape, scale, shift=0.0):
        return shift + scale * rng.normal(rng.key(seed, "qwen", tag), shape, device)

    attn = {p: {"w": draw(p, (L, d, d), d ** -0.5)} for p in ("wq", "wk", "wv", "wo")}
    for p in ("wq", "wk", "wv"):
        attn[p]["b"] = draw(p + ".b", (L, d), 0.02)
    layers = {"ln1": {"scale": draw("ln1", (L, d), 0.1, 1.0)}, "attn": attn,
              "ln2": {"scale": draw("ln2", (L, d), 0.1, 1.0)},
              "mlp": {"w_up": draw("w_up", (L, d, f), d ** -0.5),
                      "w_gate": draw("w_gate", (L, d, f), d ** -0.5),
                      "w_down": draw("w_down", (L, f, d), f ** -0.5)}}
    return {"layers": layers, "final_norm": {"scale": draw("final", (d,), 0.1, 1.0)},
            "lm_head": {"w": draw("lm_head", (d, v), d ** -0.5)}}


def make_inputs(cfg: Dict, seed: int, index: int, clients: int, device) -> List[torch.Tensor]:
    """Call ``index``'s hidden states, one (1, T, d) per client."""
    _, d, _, _, _, _ = dims(cfg)
    return [0.5 * rng.normal(rng.key(seed, "qwen.hidden", index, j),
                             (1, seq_len(cfg), d), device) for j in range(clients)]


def program(cfg: Dict, weights: Dict, plan: Dict, device):
    """The port's (params, config, Plan): the attention-score ReLU groups
    (even) and the MLP activation's PWL groups (odd) at the plan file's
    (k, m) per site."""
    from repro_torch import configs
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import lm

    L, d, h, _, f, v = dims(cfg)
    port_cfg = dataclasses.replace(
        configs.get("qwen1.5-0.5b"), n_layers=L, d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], d_ff=f, vocab=v, act=cfg["hidden_act"],
        qkv_bias=cfg["qkv_bias"], rope_theta=cfg["rope_theta"], dtype="float32")
    traced = lm.trace(weights, port_cfg, 1, seq_len(cfg))
    sites = plan["sites"]
    hb = HBConfig(tuple(HBLayer(**sites["attention" if g % 2 == 0 else "mlp_act"])
                        for g in range(traced.n_groups)), traced.group_elements)
    return weights, port_cfg, traced.with_hb(hb)


def relu_calls(cfg: Dict, plan: Dict, clients: int) -> List[Tuple[int, int]]:
    """(width, elements of all clients) of every ReLU call: per layer the
    scores (H x T x T), then the PWL's knot-shifted copies (J x T x d_ff)."""
    L, _, h, _, f, _ = dims(cfg)
    t, s = seq_len(cfg), plan["sites"]
    att = s["attention"]["k"] - s["attention"]["m"]
    act = s["mlp_act"]["k"] - s["mlp_act"]["m"]
    return [(att, clients * h * t * t), (act, clients * knots(cfg) * t * f)] * L


def linear_shapes(cfg: Dict, clients: int):
    """Every ring product of a call, per client: the public projections at
    M = 2 parties x T; per layer the two secret products (QK^T, A@V), each
    once for its triple's C = A @ B over the H heads and once for the
    Beaver combine, the parties' cells stacked: (2H, M, 2K, N)."""
    L, d, h, dh, f, v = dims(cfg)
    t = seq_len(cfg)
    m = 2 * t
    public = [((m, d, d), 4 * L), ((m, d, f), 2 * L), ((m, f, d), L), ((m, d, v), 1)]
    secret = [((h, t, dh, t), L), ((2 * h, t, 2 * dh, t), L),
              ((h, t, t, dh), L), ((2 * h, t, 2 * t, dh), L)]
    return ([("public", s, c * clients) for s, c in public]
            + [("secret", s, c * clients) for s, c in secret])
