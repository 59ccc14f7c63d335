"""Checkpointing: npz payloads + JSON manifest, atomic commit (twin of the
reference's ``checkpoint/store.py``).

Layout: <dir>/step_<N>/
  manifest.json      - leaf paths, shapes, dtypes, step metadata
  arrays.npz         - flattened leaves keyed by index
  COMMITTED          - sentinel written last (atomic rename of tmp dir)

The on-disk format differs from the reference's in the manifest only: the
reference packs it with msgpack (``manifest.msgpack``), this one writes the
same dict as JSON, so the package needs nothing beyond numpy and torch.
``arrays.npz`` holds the same leaves under the same keys.

A tree is walked as the reference's pytrees are: dict values in sorted key
order, lists and tuples in order, None an empty subtree, a dataclass (the
training loop's ``TrainState``) by its fields in declaration order, each
field's path segment ``.name`` as jax's ``GetAttrKey`` prints it.  A torch
tensor is saved as its numpy view and restored as a tensor on the
template leaf's device; a bfloat16 tensor, which numpy cannot hold, is
saved as its raw 2-byte words (``V2``, the bytes the reference's store
writes for its bfloat16 leaves) under the manifest dtype ``bfloat16``,
and restored bit for bit.  Any other leaf comes back as a numpy array.
The async writer copies every leaf to the host on the caller's thread and
serializes on a worker.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, path: Tuple = ()) -> Tuple[List[Any], List[str]]:
    """(leaves, '/'-joined paths) in the reference's pytree order."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif _is_dataclass(tree):
        items = [("." + f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return [tree], ["/".join(str(p) for p in path)]
    leaves, paths = [], []
    for k, v in items:
        lv, pv = _flatten(v, path + (k,))
        leaves += lv
        paths += pv
    return leaves, paths


def _unflatten(tree, leaves):
    """``tree``'s structure over the ``leaves`` iterator."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        filled = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _unflatten(getattr(tree, f.name),
                                                               leaves)
                                            for f in dataclasses.fields(tree)})
    return next(leaves)


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


_BF16 = np.dtype("V2")


def _host(x) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor as its raw 2-byte words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16 else str(a.dtype)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _manifest_path(d: Path) -> Path:
    return d / "manifest.json"


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None):
    """Synchronous atomic checkpoint write."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, paths = _flatten(tree)
    arrays = {str(i): _host(x) for i, x in enumerate(leaves)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [_dtype_name(a) for a in arrays.values()],
        "extra": extra or {},
        "time": time.time(),
    }
    _manifest_path(tmp).write_text(json.dumps(manifest))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _prune(ckpt_dir, keep=3)


def _prune(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if (p / "COMMITTED").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if (p / "COMMITTED").exists())
    return steps[-1] if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> Path:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return Path(ckpt_dir) / f"step_{step:08d}"


def load_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """The manifest dict of a committed checkpoint, without loading any
    arrays: lets a caller learn the leaf layout before building the
    ``tree_like`` template that ``restore`` requires."""
    return json.loads(_manifest_path(_step_dir(ckpt_dir, step)).read_text())


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``: a torch leaf of the
    template comes back as a tensor on that leaf's device, any other leaf
    as a numpy array.  Returns (tree, manifest)."""
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads(_manifest_path(d).read_text())
    leaves, _ = _flatten(tree_like)
    assert len(leaves) == len(manifest["paths"]), (
        f"checkpoint has {len(manifest['paths'])} leaves, "
        f"model expects {len(leaves)}")
    out = []
    with np.load(d / "arrays.npz") as data:
        for i, ref in enumerate(leaves):
            arr = data[str(i)]
            if isinstance(ref, torch.Tensor):
                out.append(_tensor(arr, ref.device))
            else:
                out.append(arr)
    return _unflatten(tree_like, iter(out)), manifest


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with the caller (one in flight)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        # copy to the host on the caller's thread (the device work that made
        # the tensors is ordered there), serialize + write on the worker
        leaves, _ = _flatten(tree)
        host_tree = _unflatten(tree, iter([_host(x) for x in leaves]))

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
