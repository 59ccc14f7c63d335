"""Job bundles: the offline artifact a deployed party process loads (twin
of the reference's ``transport/job.py``, same files, same layout).

A *job directory* is everything the two party hosts need to run the same
private inference without any shared memory:

    job.json     config name, params seed, protocol/infer keys, TTP seed
    plan.json    the traced ``api.Plan`` (handshake-checked by digest)
    party0.npz   party 0's input share rows + its slice of the triple pool
    party1.npz   party 1's rows/slices (same keys, other index)

Shares and triples are generated ONCE (by ``write_job``, on the machine
playing dealer / client) and split by party with
``beaver.slice_party_pool``: each process only ever sees its own rows.
The npz files hold the reference's leaves: ``x_lo``/``x_hi`` the input's
uint32 limbs, then ``t0000``... the pool's leaves in the reference's
pytree order (per bundle ``bin_init`` a, b, c; the levels; then ``b2a``
and ``mult``, each ring member as its lo leaf, then its hi leaf; culled
calls hold no leaf).  So a job directory written by either package loads
in the other to the same shares and triples.

Model *weights* are public in this threat model: both parties re-derive
them from ``params_seed`` with the loading package's own init.  This
package's ``models.resnet.init(cfg, seed)`` draws from a torch generator,
so the weights for one seed differ between the packages; to run one job
in both, carry the reference's weights across (``params_from_jax``).

``pool_treedef`` derives the pool's leaf order and shapes from
``plan.triple_specs()`` and ``plan.cone`` without drawing a triple (the
shapes ``beaver.gen_relu_triples`` gives, as empty meta tensors), so the
flat npz leaves round-trip for dense and cone layouts alike.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.plan import Plan
from ..configs import RESNET18, RESNET50, RESNET_SMOKE
from ..core import beaver, fixed, ring, shares
from ..core.mpc_tensor import MPCTensor
from ..core.schedule import cone_sets, n_levels
from ..device import Device, resolve as resolve_device

CONFIGS = {"smoke": RESNET_SMOKE, "resnet18": RESNET18,
           "resnet50": RESNET50}


def resolve_config(name: str):
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown job config {name!r}; expected one of "
                       f"{sorted(CONFIGS)}") from None


def _bundle_template(n: int, w: int, cone: bool) -> beaver.ReluTriples:
    """One party's ``gen_relu_triples(key, n, w, cone=cone)`` bundle as
    meta tensors of its shapes and dtypes: the dense adder's level stack
    holds max(L, 1) levels, the cone's one triple per level of its sets."""
    def bin_t(shape):
        t = torch.empty(shape, dtype=torch.int32, device="meta")
        return beaver.BinTriple(t, t, t)

    W = shares.packed_words(n)
    L = n_levels(w)
    if cone and w > 1:
        init_pos, level_sets = cone_sets(w)
        levels = tuple(bin_t((1, 2 * max(len(pos), 1), W))
                       for pos in level_sets[:max(L, 1)])
        init = bin_t((1, len(init_pos), W))
    else:
        levels = bin_t((max(L, 1), 1, 2 * w, W))
        init = bin_t((1, w, W))
    r = torch.empty((1, n), dtype=torch.int64, device="meta")
    arith = beaver.ArithTriple(r, r, r)
    return beaver.ReluTriples(init, levels, arith, arith)


def pool_treedef(plan: Plan) -> List[Optional[beaver.ReluTriples]]:
    """The party-sliced triple pool's structure for ``plan``: one entry per
    ReLU call, None for culled or empty calls, else a bundle of meta
    tensors with each leaf's shape and dtype (no triple is drawn)."""
    return [None if w == 0 or n == 0 else _bundle_template(n, w, plan.cone)
            for n, w in plan.triple_specs()]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _pool_leaves(pool) -> List[np.ndarray]:
    """The reference's flat leaves of a pool: int32 members as uint32
    words, int64 ring members as their lo then hi uint32 limbs."""
    leaves: List[np.ndarray] = []
    for bundle in pool:
        if bundle is None:
            continue
        for t in beaver.relu_tensors(bundle):
            if t.dtype == torch.int64:
                leaves.extend(ring.to_limbs(t))
            else:
                leaves.append(_u32(t))
    return leaves


def _pool_from_leaves(template, leaves: List[np.ndarray], device) -> List:
    """Inverse of ``_pool_leaves`` over ``pool_treedef``'s template."""
    it = iter(leaves)

    def take(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.int64:
            lo, hi = next(it), next(it)
            out = ring.from_limbs(lo, hi, device)
        else:
            out = torch.from_numpy(
                np.ascontiguousarray(next(it), np.uint32).view(np.int32)).to(device)
        if tuple(out.shape) != tuple(t.shape):
            raise ValueError(f"job pool leaf of shape {tuple(out.shape)}, "
                             f"the plan expects {tuple(t.shape)}")
        return out

    def triple(tr):
        return type(tr)(*(take(getattr(tr, f)) for f in ("a", "b", "c")))

    pool = []
    for b in template:
        if b is None:
            pool.append(None)
            continue
        init = triple(b.bin_init)                 # leaves in the stored order
        levels = (tuple(triple(t) for t in b.bin_levels)
                  if isinstance(b.bin_levels, tuple) else triple(b.bin_levels))
        pool.append(beaver.ReluTriples(init, levels, triple(b.b2a),
                                       triple(b.mult)))
    if next(it, None) is not None:
        raise ValueError("job pool holds more leaves than the plan's triples")
    return pool


def write_job(job_dir, *, plan: Plan, config: str, params_seed: int,
              infer_key: int, session_seed: int, ttp_seed: int = 0,
              x: Optional[MPCTensor] = None,
              pool: Optional[List] = None) -> pathlib.Path:
    """Materialise a job directory (see module docstring).

    ``x`` is the full 2-party secret-shared input and ``pool`` the full
    offline triple pool; both are split by party here.  Omit them for a
    serving-mode job (the engine leader shares inputs per request and
    triples stream from the shared ``ttp_seed``).
    """
    path = pathlib.Path(job_dir)
    path.mkdir(parents=True, exist_ok=True)
    plan.save(path / "plan.json")
    job = {"config": str(config), "params_seed": int(params_seed),
           "infer_key": int(infer_key), "session_seed": int(session_seed),
           "ttp_seed": int(ttp_seed)}
    resolve_config(job["config"])               # fail at write time, loudly
    if x is not None:
        job["frac_bits"] = int(x.frac_bits)
        job["input_shape"] = [int(s) for s in x.shape]
        for p in (0, 1):
            lo, hi = ring.to_limbs(x.data[p:p + 1])
            arrs = {"x_lo": lo, "x_hi": hi}
            if pool is not None:
                leaves = _pool_leaves(beaver.slice_party_pool(pool, p))
                arrs.update({f"t{i:04d}": leaf for i, leaf in enumerate(leaves)})
            np.savez(path / f"party{p}.npz", **arrs)
    (path / "job.json").write_text(json.dumps(job, indent=1))
    return path


def load_job(job_dir) -> Dict:
    """job.json + the plan (every party-agnostic piece)."""
    path = pathlib.Path(job_dir)
    job = json.loads((path / "job.json").read_text())
    job["plan"] = Plan.load(path / "plan.json")
    job["cfg"] = resolve_config(job["config"])
    return job


def load_party(job_dir, party: int, device: Device = None) -> Dict:
    """One party's view: job + its input share rows + its triple slice, on
    ``device`` (default the GPU)."""
    device = resolve_device(device)
    path = pathlib.Path(job_dir)
    job = load_job(path)
    npz_path = path / f"party{party}.npz"
    if npz_path.exists():
        with np.load(npz_path) as npz:
            job["X"] = MPCTensor(
                ring.from_limbs(npz["x_lo"], npz["x_hi"], device),
                int(job.get("frac_bits", fixed.DEFAULT_FRAC_BITS)))
            tkeys = sorted(k for k in npz.files if k.startswith("t"))
            if tkeys:
                job["pool"] = _pool_from_leaves(pool_treedef(job["plan"]),
                                                [npz[k] for k in tkeys], device)
    return job
