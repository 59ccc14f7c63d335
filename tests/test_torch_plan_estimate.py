"""The port's Plan analytics against the reference's (mirrors the
``estimate``/``gantt``/``from_hb`` cases of tests/test_comm_counters.py and
tests/test_schedule.py): the network presets, ``Plan.estimate`` float for
float, ``Plan.gantt`` character for character, ``PrivateModel.estimate``,
and ``Plan.from_hb``'s trace-free plan (same JSON and digest; no timeline).
"""
import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core.hummingbird import HBConfig as JHB, HBLayer as JL
from repro.models import resnet as jres
from repro_torch import api as tapi
from repro_torch.configs import RESNET_SMOKE as TSMOKE
from repro_torch.core.hummingbird import HBConfig as THB, HBLayer as TL
from repro_torch.models import resnet as tres

KMS = ((21, 13), (26, 0), (13, 13))      # reduced, w > 8, culled


def _plans(batch: int, cone: bool, kms=KMS):
    tparams = tres.init(TSMOKE, 0, "cpu")
    jplan = japi.trace_plan(
        lambda p, x, relu_fn=None: jres.apply(p, x, JSMOKE, relu_fn=relu_fn),
        _jparams(), (batch, 3, 8, 8), cone=cone, name="resnet-smoke")
    tplan = tres.trace(tparams, TSMOKE, batch, 8, cone=cone)
    jplan = jplan.with_hb(JHB(tuple(JL(k=k, m=m) for k, m in kms), jplan.group_elements))
    tplan = tplan.with_hb(THB(tuple(TL(k=k, m=m) for k, m in kms), tplan.group_elements))
    return jplan, tplan


def _jparams():
    """The reference's params as shapes only (its trace never computes)."""
    import jax
    return jax.eval_shape(lambda: jres.init(jax.random.PRNGKey(0), JSMOKE))


def test_network_presets_equal_the_reference():
    assert sorted(tapi.NETWORKS) == sorted(japi.NETWORKS)
    for name, preset in japi.NETWORKS.items():
        assert dataclasses.asdict(tapi.NETWORKS[name]) == dataclasses.asdict(preset)
    assert (tapi.LAN, tapi.WAN, tapi.HIGHBW) == tuple(
        tapi.NETWORKS[n] for n in ("lan", "wan", "highbw"))


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_estimate_and_gantt_equal_the_reference(batch, cone):
    jplan, tplan = _plans(batch, cone)
    assert tplan.to_json() == jplan.to_json()
    for streams in (1, 4):
        for auto_batch in (True, False):
            for net in ("lan", "wan", "highbw"):
                want = jplan.estimate(network=net, streams=streams,
                                      auto_batch=auto_batch)
                assert tplan.estimate(network=net, streams=streams,
                                      auto_batch=auto_batch) == want
                assert tplan.estimate(network=tapi.NETWORKS[net], streams=streams,
                                      auto_batch=auto_batch) == want
            assert tplan.estimate(1e9, 1e-3, streams=streams, compute_s=0.25) == \
                jplan.estimate(1e9, 1e-3, streams=streams, compute_s=0.25)
            assert tplan.gantt(streams=streams, auto_batch=auto_batch) == \
                jplan.gantt(streams=streams, auto_batch=auto_batch)
    assert "culled" in tplan.gantt()
    with pytest.raises(ValueError, match="estimate needs"):
        tplan.estimate()


def test_private_model_estimate_is_the_plans():
    _, tplan = _plans(1, False)
    model = tapi.compile(None, tres.init(TSMOKE, 0, "cpu"), TSMOKE, tplan,
                         tapi.Session(key=0, device="cpu"))
    for net in (tapi.LAN, tapi.WAN):
        assert model.estimate(network=net, streams=4) == \
            tplan.estimate(network=net, streams=4)
    model_nb = dataclasses.replace(model, auto_batch=False)
    assert model_nb.estimate(network=tapi.WAN, streams=4) == \
        tplan.estimate(network=tapi.WAN, streams=4, auto_batch=False)


def test_plan_gantt_marks_culled_calls():
    plan = tapi.Plan(
        calls=(tapi.ReluCall(96, 0, (96,)), tapi.ReluCall(32, 1, (32,))),
        hb=THB((TL(k=21, m=13), TL(k=13, m=13)), (96, 32)))
    jplan = japi.Plan(
        calls=(japi.ReluCall(96, 0, (96,)), japi.ReluCall(32, 1, (32,))),
        hb=JHB((JL(k=21, m=13), JL(k=13, m=13)), (96, 32)))
    text = plan.gantt()
    assert text == jplan.gantt()
    assert "call 0" in text and "call 1" in text and "culled" in text
    assert f"replay total: {plan.schedule().n_rounds} fused rounds" in text


def test_from_hb_is_trace_free():
    hb = THB((TL(k=21, m=13), TL(k=64, m=0)), (10, 20))
    bare = tapi.Plan.from_hb(hb, cone=True, name="bare")
    want = japi.Plan.from_hb(JHB((JL(k=21, m=13), JL(k=64, m=0)), (10, 20)),
                             cone=True, name="bare")
    assert bare.to_json() == want.to_json() and bare.digest() == want.digest()
    assert bare.calls == () and bare.hb == hb and bare.cone
    with pytest.raises(ValueError, match="traced plan"):
        bare.gantt()
    with pytest.raises(ValueError, match="traced plan"):
        bare.estimate(network=tapi.LAN)
    assert np.isclose(bare.hb.budget_fraction(), want.hb.budget_fraction())
