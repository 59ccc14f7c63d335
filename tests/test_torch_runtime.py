"""The port's runtime analysis against the reference's (its
``tests/test_runtime.py`` cases that are not about XLA, meshes or the
cost model): ``runtime/op_analyzer`` counts the FLOPs of the aten ops a
call dispatches, forward and backward, and ``runtime/roofline`` prices
them at the H100's datasheet peaks with the reference's keys."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import SHAPES as JSHAPES, get as jget
from repro.runtime import roofline as jroofline
from repro.runtime.hlo_analyzer import Metrics as JMetrics
from repro_torch import configs
from repro_torch.launch import train as ttrain
from repro_torch.runtime import op_analyzer, roofline
from repro_torch.runtime.op_analyzer import Metrics, analyze
from repro_torch.train import optimizer as topt

L, B, D = 6, 32, 64


def _loop(x, ws):
    h = x
    for i in range(ws.shape[0]):
        h = torch.tanh(h @ ws[i])
    return h.sum()


def test_analyzer_loop_flops_exact():
    """A loop of L ``tanh(h @ w)`` counts exactly 2·B·D²·L (the reference's
    scan-vs-unroll case: the port's loop is always unrolled); with the
    backward (``autograd.grad`` inside the call) exactly three times that."""
    x, ws = torch.randn(B, D), torch.randn(L, D, D)
    m = analyze(_loop, x, ws)
    assert m.flops == 2 * B * D * D * L
    assert m.op_counts["mm"] == L and m.collective_bytes == 0 and not m.collective_counts
    # bytes: each matmul's operands and output, plus the call's inputs and output
    per_mm = (B * D + D * D + B * D) * 4
    assert m.bytes == L * per_mm + (B * D + L * D * D) * 4 + 4
    xg, wg = x.clone().requires_grad_(True), ws.clone().requires_grad_(True)
    g = analyze(lambda a, b: torch.autograd.grad(_loop(a, b), [a, b]), xg, wg)
    assert g.flops == 3 * 2 * B * D * D * L


def test_analyzer_batched_and_conv_flops():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    assert analyze(torch.bmm, a, b).flops == 2 * 3 * 5 * 7 * 2
    assert analyze(torch.einsum, "bqd,bdk->bqk", a, b).flops == 2 * 3 * 5 * 7 * 2
    bias, m1, m2 = torch.randn(4), torch.randn(6, 8), torch.randn(8, 4)
    assert analyze(torch.addmm, bias, m1, m2).flops == 2 * 6 * 8 * 4
    x, w = torch.randn(2, 4, 9, 9), torch.randn(6, 2, 3, 3)
    out = (9 - 3 + 1) ** 2
    assert analyze(F.conv2d, x, w, groups=2).flops == 2 * 2 * 6 * out * 2 * 9
    xg = x.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    back = analyze(lambda: torch.autograd.grad(F.conv2d(xg, wg, groups=2).sum(),
                                               [xg, wg]))
    assert back.flops == 3 * 2 * 2 * 6 * out * 2 * 9
    copy = analyze(lambda t: t.to(torch.float64), torch.ones(10))
    assert copy.bytes == 2 * 80 + 40 + 80          # 2x the copy, input, output


def test_analyzer_train_step_counts_its_matmuls():
    """A smoke train step: the analyzer's FLOPs are the forward's matmul
    FLOPs three times over (remat "none"), and the forward's equal the
    dense model's count from its shapes."""
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=2,
                              remat="none", attn_chunk_q=16, attn_chunk_k=16)
    b, s = 2, 16
    params = ttrain.init_state(cfg, topt.SGD(), torch.Generator().manual_seed(0)).params
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": ttrain.shift_labels(tokens)}
    d, h, kv, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff, cfg.vocab)
    proj = d * dh * (h + 2 * kv) + h * dh * d + 3 * d * f
    attn = 2 * h * s * s * dh          # QK^T and PV, one chunk, per sequence
    fwd = 2 * b * s * (cfg.n_layers * proj + d * v) + 2 * b * cfg.n_layers * attn
    with torch.no_grad():
        assert analyze(ttrain.loss_fn, params, batch, cfg).flops == fwd
    leaves = [p.requires_grad_(True) for p in topt.tree_leaves(params)]
    assert leaves
    step = analyze(ttrain.value_and_grad, params, batch, cfg)
    assert step.flops == 3 * fwd


def test_metrics_scaled_and_add():
    m = Metrics(flops=2.0, bytes=4.0, collective_bytes=6.0,
                collective_counts={"all_reduce": 2})
    assert m.scaled(0.5).collective_counts == {"all_reduce": 1}
    m.add(Metrics(flops=1.0, collective_counts={"all_reduce": 1}))
    assert m.flops == 3.0 and m.collective_counts == {"all_reduce": 3}


def test_roofline_terms_shape():
    """The reference's test on the port's peaks: same keys, compute
    dominant (1e14 / 989.4e12 = 0.10 s > 1e11 / 3.35e12 = 0.030 s > 1e10 /
    450e9 = 0.022 s)."""
    m = Metrics(flops=1e14, bytes=1e11, collective_bytes=1e10)
    out = roofline.roofline_terms(configs.get("qwen1.5-0.5b"),
                                  configs.SHAPES["train_4k"], m, 256)
    assert set(out) >= {"compute_s", "memory_s", "collective_s", "dominant",
                        "useful_flops_ratio", "roofline_fraction"}
    assert out["dominant"] == "compute_s"
    want = jroofline.roofline_terms(jget("qwen1.5-0.5b"), JSHAPES["train_4k"],
                                    JMetrics(flops=1e14, bytes=1e11,
                                             collective_bytes=1e10), 256)
    assert set(want) <= set(out)
    assert out["model_flops_global"] == want["model_flops_global"]
    assert out["compute_s"] == pytest.approx(1e14 / 989.4e12, rel=1e-5)
    assert out["memory_s"] == pytest.approx(1e11 / 3.35e12, rel=1e-5)
    assert out["collective_s"] == pytest.approx(1e10 / 450e9, rel=1e-5)
    mpc = roofline.mpc_roofline_terms(m, 1)
    assert set(jroofline.mpc_roofline_terms(JMetrics(1e14, 1e11, 1e10), 1)) <= set(mpc)
    assert "H100" in roofline.CARD


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mixtral-8x22b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_model_flops_equal_reference(name):
    for shape in JSHAPES:
        assert roofline.model_flops(configs.get(name), configs.SHAPES[shape]) == \
            jroofline.model_flops(jget(name), JSHAPES[shape])
    # the chip's training step: 6·N·D = 7.61 TFLOP, 7.69 ms at the bf16 peak
    one = configs.ShapeConfig("step", 512, 4, "train")
    if name == "qwen1.5-0.5b":
        mf = roofline.model_flops(configs.get(name), one)
        assert mf == 6 * 619446272 * 2048
        assert mf / roofline.PEAK_FLOPS == pytest.approx(7.693e-3, rel=1e-3)
        assert roofline.model_flop_fraction(mf, 2 * mf / roofline.PEAK_FLOPS) == 0.5
