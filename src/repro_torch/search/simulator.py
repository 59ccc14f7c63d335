"""§4.1.1 MPC simulator: plaintext inference with a share-domain ReLU
(twin of the reference's ``search/simulator.py``).

Every layer but the ReLU runs the plaintext torch forward.  The ReLU
encodes to Z/2^64, draws a random share split (the port's jax-identical
threefry), drops bits per (k, m) and evaluates the sign on the reduced
ring: the same outcome as the GMW protocol, off-by-one and underflow
cases included, at no protocol cost, so the search can score many
configurations.  The integer part equals the reference's bit for bit for
the same float32 input and key.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import fixed, prng, ring
from ..core import schedule as schedule_lib
from ..core.hummingbird import HBConfig


@contextlib.contextmanager
def deterministic():
    """Run-to-run identical float forwards on the card: cuDNN's
    deterministic algorithms, no autotuning, TF32 off for convolutions and
    matmuls; the caller's settings come back on exit.  HummingBird-eco
    compares logits bit for bit, so an ulp of algorithm choice between two
    forwards would end its search at the wrong k."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved


def simulated_hb_relu(x: torch.Tensor, k: int, m: int,
                      key: torch.Tensor) -> torch.Tensor:
    """ReLU(x) with the sign estimated on the reduced ring <x>[k:m]; the
    share split is drawn on x's device."""
    if k == m:            # width 0: the culled layer degrades to identity
        return x
    if k >= 64 and m == 0:
        return F.relu(x)
    enc = fixed.encode(x)
    s0 = ring.uniform(key.to(x.device), tuple(x.shape))
    s1 = enc - s0
    w = k - m
    if w <= 32:
        # bits m..k-1 of each share (the arithmetic shift's fill lies above
        # bit w - 1, which the mask drops); their sum mod 2^w
        mask = (1 << w) - 1
        total = (((s0 >> m) & mask) + ((s1 >> m) & mask)) & mask
    else:
        low = (1 << (64 - m)) - 1 if m else -1       # the logical shift's mask
        total = ((s0 >> m) & low) + ((s1 >> m) & low)  # mod 2^64
    sign = (total >> (w - 1)) & 1
    return x * (1 - sign).to(x.dtype)


def make_group_relu(cfg: HBConfig, key: torch.Tensor) -> Callable:
    """relu_fn(x, group) for models whose apply() takes a pluggable ReLU:
    one key per group, shared by every ReLU call of that group."""
    keys = prng.split(key, max(cfg.n_groups, 1))

    def relu_fn(x, group):
        layer = cfg.layers[group]
        return simulated_hb_relu(x, layer.k, layer.m, keys[group])

    return relu_fn


def evaluate_accuracy(apply_fn, params, xs, ys, cfg: HBConfig, key,
                      batch: int = 256) -> float:
    """Top-1 accuracy of the simulated approximate model."""
    relu_fn = make_group_relu(cfg, key)
    n = xs.shape[0]
    correct = 0
    with torch.no_grad():
        for i in range(0, n, batch):
            logits = apply_fn(params, xs[i:i + batch], relu_fn=relu_fn)
            correct += int((torch.argmax(logits, -1) == ys[i:i + batch]).sum())
    return correct / n


def config_objective(cfg: HBConfig, calls: Sequence[Tuple[int, int]],
                     objective: str = "bytes",
                     bandwidth_bps: float = None, rtt_s: float = None,
                     streams: int = 1, cone: bool = False) -> float:
    """Schedule-predicted serving score of an HBConfig: total wire bytes
    (``"bytes"``), or the fused-round latency under the given network
    (``"latency"``), of one replay whose ReLU calls are ``calls``
    ((n_elements, group) in call order), ``streams`` sibling payloads
    auto-batched per call."""
    total = schedule_lib.Schedule.empty()
    for n, g in calls:
        layer = cfg.layers[g]
        total = total + schedule_lib.simulate(
            [(n, layer.width, (n, layer.k, layer.m))] * streams, cone=cone)
    if objective == "bytes":
        return float(total.bytes_tx)
    if objective == "latency":
        if bandwidth_bps is None or rtt_s is None:
            raise ValueError(
                "objective='latency' needs (bandwidth_bps, rtt_s)")
        return total.latency(bandwidth_bps, rtt_s)
    raise ValueError(f"unknown objective {objective!r} "
                     "(expected 'bytes' or 'latency')")


def max_activation_ints(apply_fn, params, xs, n_groups: int,
                        frac_bits: int = 16) -> List[int]:
    """Per-group max |round(x * 2^frac)| over the validation set: drives
    HummingBird-eco's zero-error k (Theorem 1).  The max is a Python float
    rounded by Python's ``round``, as the reference."""
    maxes = [0.0] * n_groups

    def relu_fn(x, g):
        maxes[g] = max(maxes[g], float(torch.max(torch.abs(x))))
        return F.relu(x)

    with torch.no_grad():
        apply_fn(params, xs, relu_fn=relu_fn)
    return [int(round(m * 2 ** frac_bits)) for m in maxes]
