"""End-to-end behaviour of the port alone, the four tests of
``tests/test_system.py``: the full HummingBird pipeline on one model
(train -> eco / budget search -> finetune -> MPC serve, and the cost
model's paper-level claims), a tiny LM training run whose loss falls, and
a microbatched train step equal to the plain one.  Everything runs on the
CPU through the port; nothing of the reference is imported.

Sizes are the reference test's (16x16 images, 320 of them), but the
budget search stops at k = 16 where the reference's goes to its default
28 (``tests/test_torch_search.py`` cuts its searches the same way): the
suite's time.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import RESNET_SMOKE, get
from repro_torch.core import costmodel, prng
from repro_torch.core.hummingbird import HBConfig
from repro_torch.core.mpc_tensor import MPCTensor
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as train_lib
from repro_torch.models import resnet
from repro_torch.search import finetune as ft, search_budget, search_eco
from repro_torch.search.simulator import evaluate_accuracy
from repro_torch.train import loop as loop_lib, optimizer as opt_lib

HW = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key(seed):
    return prng.PRNGKey(seed, "cpu")


@pytest.fixture(scope="module")
def trained_resnet():
    params = resnet.init(RESNET_SMOKE, 0, "cpu")
    xs = prng.normal(_key(1), (320, 3, HW, HW))
    ys = (xs[:, 0, :HW // 2, :HW // 2].mean((1, 2)) > 0).long()

    def afn(p, x, relu_fn=None):
        return resnet.apply(p, x, RESNET_SMOKE, relu_fn=relu_fn)

    groups = resnet.relu_group_elements(params, RESNET_SMOKE, in_hw=HW)
    params, _ = ft.finetune(afn, params, xs[:256], ys[:256], HBConfig.exact(groups),
                            _key(5), epochs=4, batch=64, lr=3e-3)
    return afn, params, xs[256:], ys[256:], groups


def test_full_hummingbird_pipeline(trained_resnet):
    """Search a config, then check that the real GMW protocol with it gives
    the plaintext model's classes on secret shares."""
    afn, params, xs, ys, groups = trained_resnet
    res = search_eco(afn, params, xs, ys, groups, _key(2))
    assert res.accuracy == res.baseline_accuracy  # eco: zero error

    x = MPCTensor.from_plain(_key(3), xs[:2])
    out = resnet.mpc_apply(params, x, RESNET_SMOKE, _key(4), hb=res.config)
    with torch.no_grad():
        plain = afn(params, xs[:2])
    np.testing.assert_array_equal(np.argmax(out.reveal_np(), -1),
                                  plain.argmax(-1).numpy())
    assert costmodel.reduction_factors(res.config)["bytes_reduction"] > 1.5


def test_budget_pipeline_with_finetune(trained_resnet):
    afn, params, xs, ys, groups = trained_resnet
    res = search_budget(afn, params, xs, ys, groups, _key(6), budget=8 / 64,
                        bit_choices=(6, 8), max_k=16)
    assert res.config.meets_budget(8 / 64)
    p2, losses = ft.finetune(afn, params, xs, ys, res.config, _key(7), epochs=1,
                             batch=32)
    assert np.isfinite(losses).all()
    post = evaluate_accuracy(afn, p2, xs, ys, res.config, _key(8))
    assert post >= res.accuracy - 0.15  # finetune never catastrophically hurts
    assert costmodel.reduction_factors(res.config)["bytes_reduction"] > 2.0


def test_lm_training_loss_decreases():
    cfg = dataclasses.replace(get("qwen1.5-0.5b-smoke"), n_layers=2)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=64, batch=8)
    lc = loop_lib.LoopConfig(total_steps=30, ckpt_dir=None)
    opt = opt_lib.AdamW(schedule=opt_lib.Schedule(peak_lr=3e-3, warmup_steps=5,
                                                  decay_steps=0))
    rep = loop_lib.run(cfg, pipe, lc, optimizer=opt, device="cpu")
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    assert last < first - 0.2, (first, last)


def test_microbatched_step_matches_plain():
    cfg = dataclasses.replace(get("qwen1.5-0.5b-smoke"), n_layers=2, remat="none")
    opt = opt_lib.SGD(schedule=opt_lib.Schedule(peak_lr=0.1, warmup_steps=0,
                                                decay_steps=0), momentum=0.0)
    state = train_lib.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=32, batch=8).batch_at(0, device="cpu")
    s1, m1 = train_lib.make_train_step(cfg, opt, n_microbatches=1)(state, batch)
    s2, m2 = train_lib.make_train_step(cfg, opt, n_microbatches=4)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for a, b in zip(opt_lib.tree_leaves(s1.params), opt_lib.tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-3)
