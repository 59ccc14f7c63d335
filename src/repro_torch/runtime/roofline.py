"""Roofline terms of one card, the NVIDIA H100 (twin of the reference's
``runtime/roofline.py``, whose peaks are a TPU's).

  compute    = FLOPs per card / peak FLOP/s     (989.4 TFLOP/s dense bf16)
  memory     = HBM bytes per card / HBM rate    (3.35 TB/s, HBM3)
  collective = collective bytes per card / link (450 GB/s a direction, NVLink)

The peaks are the datasheet's for the H100 SXM5 80 GB, the card that
``nvidia-smi`` names "NVIDIA H100 80GB HBM3"; a card run below its 700 W
power limit reaches less.  The metrics come from ``runtime/op_analyzer``
(per card: the port runs one program per card).  ``model_flops`` counts
6·N·D for training and 2·N·D per scored or generated token for
inference (N = active params for MoE), as the reference.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ArchConfig, ShapeConfig

CARD = "NVIDIA H100 SXM5 80 GB (datasheet peaks; nvidia-smi: NVIDIA H100 80GB HBM3)"
PEAK_FLOPS = 989.4e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one new token per sequence in the batch
    return 2.0 * n * shape.global_batch


def _terms(metrics) -> Dict[str, float]:
    return {"compute_s": metrics.flops / PEAK_FLOPS,
            "memory_s": metrics.bytes / HBM_BW,
            "collective_s": metrics.collective_bytes / NVLINK_BW}


def roofline_terms(cfg: ArchConfig, shape: ShapeConfig, metrics,
                   n_chips: int) -> Dict:
    """The three terms, the dominant one, and the model-FLOP fraction at
    the dominant term's bound (``roofline_fraction``: only model FLOPs
    count as useful, so recompute lowers it)."""
    terms = _terms(metrics)
    mf = model_flops(cfg, shape)
    op_global = metrics.flops * n_chips
    bound = max(terms.values())
    model_time = mf / n_chips / PEAK_FLOPS
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": max(terms, key=terms.get),
        "model_flops_global": mf,
        "hlo_flops_global": op_global,
        "useful_flops_ratio": (mf / op_global) if op_global else None,
        "roofline_fraction": (model_time / bound) if bound else None,
        "hlo_compute_fraction": (terms["compute_s"] / bound) if bound else None,
        "step_time_bound_s": bound,
        "card": CARD,
    }


def mpc_roofline_terms(metrics, n_chips: int) -> Dict:
    """The terms of a private-inference call; its party exchanges priced at
    NVLink's rate (a deployment's network is slower: rescale to LAN/WAN)."""
    terms = _terms(metrics)
    bound = max(terms.values())
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": max(terms, key=terms.get),
        "roofline_fraction": (terms["compute_s"] / bound) if bound else None,
        "step_time_bound_s": bound,
        "card": CARD,
    }


def model_flop_fraction(model_flops_: float, wall_s: float) -> float:
    """Model FLOPs over what the card's peak could do in ``wall_s``."""
    return model_flops_ / (wall_s * PEAK_FLOPS)
