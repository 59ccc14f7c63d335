"""The port's checkpoint store against the reference's.

Mirrors the reference's ``tests/test_fault_tolerance.py`` cases of the
store (``checkpoint_roundtrip``, ``uncommitted_checkpoint_ignored``,
``async_checkpointer``; its training cases are in
``tests/test_torch_train.py``), and holds a training state (a dataclass
walked by its fields) with a bfloat16 leaf against the reference's store:
the same paths, dtypes and ``arrays.npz`` bytes, restored bit for bit.  The on-disk format differs in the manifest only (JSON, not
msgpack), so the reference's leaves and paths are compared too: the same
tree saved by both stores gives the same ``arrays.npz`` keys and arrays
and the same leaf paths, shapes and dtypes."""
import json

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import torch

from repro.checkpoint import store as jstore
from repro.launch import train as jtrain
from repro_torch.checkpoint import store
from repro_torch.launch import train as ttrain


def _tree():
    return {"b": {"c": torch.ones((5,), dtype=torch.int32)},
            "a": torch.arange(12.0).reshape(3, 4),
            "l": [np.arange(3, dtype=np.uint32), None, torch.tensor(7)]}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    store.save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert store.latest_step(str(tmp_path)) == 7
    out, manifest = store.restore(str(tmp_path), tree)
    assert torch.equal(out["a"], tree["a"]) and out["a"].device == tree["a"].device
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(out["l"][0], tree["l"][0])
    assert out["l"][1] is None and int(out["l"][2]) == 7
    assert list(out) == list(tree)                   # the caller's key order
    assert manifest["extra"]["note"] == "x"
    assert store.load_manifest(str(tmp_path)) == manifest

    # the reference's store, same tree: same leaves, paths, shapes, dtypes
    jtree = {"b": {"c": jnp.ones((5,), jnp.int32)},
             "a": jnp.arange(12.0).reshape(3, 4),
             "l": [jnp.arange(3, dtype=jnp.uint32), None, jnp.asarray(7)]}
    jstore.save(str(tmp_path / "ref"), 7, jtree, extra={"note": "x"})
    jdir, tdir = tmp_path / "ref" / "step_00000007", tmp_path / "step_00000007"
    jman = msgpack.unpackb((jdir / "manifest.msgpack").read_bytes())
    tman = json.loads((tdir / "manifest.json").read_text())
    for k in ("step", "paths", "shapes", "extra"):
        assert jman[k] == tman[k], k
    assert [np.dtype(d) for d in jman["dtypes"]][:3] == \
        [np.dtype(d) for d in tman["dtypes"]][:3]
    with np.load(jdir / "arrays.npz") as a, np.load(tdir / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in ("0", "1", "2"):
            np.testing.assert_array_equal(a[k], b[k])


def test_uncommitted_checkpoint_ignored(tmp_path):
    tree = {"a": torch.zeros(3)}
    store.save(str(tmp_path), 5, tree)
    # a torn write: directory without COMMITTED sentinel
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert store.latest_step(str(tmp_path)) == 5
    out, _ = store.restore(str(tmp_path), tree)
    assert torch.equal(out["a"], tree["a"])


def test_async_checkpointer(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save(3, {"w": torch.ones((64, 64))})
    ck.wait()
    assert store.latest_step(str(tmp_path)) == 3
    out, _ = store.restore(str(tmp_path), {"w": torch.zeros((64, 64))})
    assert torch.equal(out["w"], torch.ones((64, 64)))


def test_prune_keeps_the_last_three_committed(tmp_path):
    for step in range(1, 6):
        store.save(str(tmp_path), step, [torch.full((2,), float(step))])
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    out, _ = store.restore(str(tmp_path), [torch.zeros(2)], step=4)
    assert torch.equal(out[0], torch.full((2,), 4.0))


def _bf16_state():
    """A port TrainState and the reference's, the same values: a float32
    and a bfloat16 param (values exact in bfloat16), AdamW-like moments,
    the step."""
    w = np.linspace(-3.0, 3.0, 12, dtype=np.float32).reshape(3, 4)
    h = np.array([1.5, -0.0, 2.0 ** -130, 65280.0, np.inf, -7.25], np.float32)
    port = ttrain.TrainState(
        params={"w": torch.from_numpy(w), "h": torch.from_numpy(h).to(torch.bfloat16)},
        opt_state={"m": {"w": torch.from_numpy(w * 0.5), "h": torch.zeros(6)},
                   "v": {"w": torch.from_numpy(w * w), "h": torch.ones(6)}},
        step=torch.tensor(7, dtype=torch.int32))
    ref = jtrain.TrainState(
        params={"w": jnp.asarray(w), "h": jnp.asarray(h.astype(ml_dtypes.bfloat16))},
        opt_state={"m": {"w": jnp.asarray(w * 0.5), "h": jnp.zeros(6)},
                   "v": {"w": jnp.asarray(w * w), "h": jnp.ones(6)}},
        step=jnp.asarray(7, jnp.int32))
    return port, ref


def test_train_state_with_bfloat16_leaf_round_trips_as_the_reference(tmp_path):
    port, ref = _bf16_state()
    store.save(str(tmp_path / "port"), 3, port)
    jstore.save(str(tmp_path / "ref"), 3, ref)
    tdir, jdir = tmp_path / "port" / "step_00000003", tmp_path / "ref" / "step_00000003"
    tman = json.loads((tdir / "manifest.json").read_text())
    jman = msgpack.unpackb((jdir / "manifest.msgpack").read_bytes())
    assert tman["paths"] == jman["paths"] == [
        ".params/h", ".params/w", ".opt_state/m/h", ".opt_state/m/w",
        ".opt_state/v/h", ".opt_state/v/w", ".step"]
    assert tman["dtypes"] == jman["dtypes"] and tman["dtypes"][0] == "bfloat16"
    assert tman["shapes"] == jman["shapes"]
    with np.load(tdir / "arrays.npz") as a, np.load(jdir / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k

    template = ttrain.TrainState(
        params={"w": torch.zeros(3, 4), "h": torch.zeros(6, dtype=torch.bfloat16)},
        opt_state={"m": {"w": torch.zeros(3, 4), "h": torch.zeros(6)},
                   "v": {"w": torch.zeros(3, 4), "h": torch.zeros(6)}},
        step=torch.zeros((), dtype=torch.int32))
    for d in (tmp_path / "port", tmp_path / "ref"):     # the reference's too
        if d.name == "ref":                              # (JSON manifest beside)
            (d / "step_00000003" / "manifest.json").write_text(json.dumps(jman))
        out, manifest = store.restore(str(d), template)
        assert isinstance(out, ttrain.TrainState) and manifest["step"] == 3
        assert out.params["h"].dtype == torch.bfloat16
        assert torch.equal(out.params["h"].view(torch.int16),
                           port.params["h"].view(torch.int16))
        assert torch.equal(out.params["w"], port.params["w"])
        assert torch.equal(out.opt_state["v"]["w"], port.opt_state["v"]["w"])
        assert out.step.dtype == torch.int32 and int(out.step) == 7


def test_async_checkpointer_takes_a_train_state(tmp_path):
    port, _ = _bf16_state()
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save(9, port, {"loss": 1.5})
    ck.wait()
    out, manifest = store.restore(str(tmp_path), port)
    assert manifest["extra"] == {"loss": 1.5}
    assert torch.equal(out.params["h"].view(torch.int16),
                       port.params["h"].view(torch.int16))
    assert int(out.step) == 7
