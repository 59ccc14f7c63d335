"""compile(): bind (model, Plan, Session) into a callable PrivateModel
(twin of the reference's ``api/compile.py``, generator round loop only).

The MPC forward of a model family is registered once
(``register_mpc_forward``) as ``forward(params, tensors, cfg, relu_fn,
comm) -> tensors`` over sibling ``MPCTensor`` streams.  ``PrivateModel``
replays the Plan: every ReLU call draws its keys from the Session's PRNG
stream and its triples from the Session's provider, and sibling streams
share protocol rounds through ``relu_many``.  Keys are consumed in exactly
the reference's order, so outputs are share-level bit-identical to it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from .. import errors
from ..core import prng
from ..core.mpc_tensor import MPCTensor, relu_many
from .plan import Plan
from .session import Session

_MPC_FORWARDS: Dict[type, Callable] = {}


def register_mpc_forward(cfg_type: type, forward: Callable) -> None:
    """Register the secret-shared forward for a model-config type:
    ``forward(params, tensors, cfg, relu_fn, comm)`` evaluates the model on
    sibling MPCTensor streams, calling ``relu_fn(tensors, group)`` at every
    ReLU point."""
    _MPC_FORWARDS[cfg_type] = forward


def resolve_mpc_forward(cfg) -> Callable:
    for klass in type(cfg).__mro__:
        if klass in _MPC_FORWARDS:
            return _MPC_FORWARDS[klass]
    from .. import models  # noqa: F401  (model modules register on import)
    for klass in type(cfg).__mro__:
        if klass in _MPC_FORWARDS:
            return _MPC_FORWARDS[klass]
    raise errors.UnregisteredModel(
        f"no MPC forward registered for {type(cfg).__name__}; call "
        "register_mpc_forward or pass mpc_forward= to compile")


def compile(apply_fn, params, cfg, plan: Plan,
            session: Optional[Session] = None, *,
            mpc_forward: Optional[Callable] = None,
            auto_batch: bool = True) -> "PrivateModel":
    """Bind a model to a Plan and a Session for private inference.

    ``apply_fn(params, x, relu_fn=...)`` is the plaintext forward (kept for
    reference evaluation; may be None).  ``cfg``'s type resolves the
    registered MPC forward unless ``mpc_forward`` is given.

    Example::

        model = compile(afn, params, RESNET18, plan, Session(key=0))
        X = model.encrypt(prng.PRNGKey(1, "cuda"), x)
        logits = model(X).reveal()
    """
    if mpc_forward is None:
        mpc_forward = resolve_mpc_forward(cfg)
    return PrivateModel(apply_fn=apply_fn, params=params, cfg=cfg, plan=plan,
                        session=session if session is not None else Session(),
                        mpc_forward=mpc_forward, auto_batch=auto_batch)


@dataclasses.dataclass
class PrivateModel:
    """A model compiled for private inference under a Plan + Session.

    ``__call__`` takes one MPCTensor or a sequence of sibling streams;
    streams share protocol rounds via ``relu_many``.
    """

    apply_fn: Optional[Callable]
    params: object
    cfg: object
    plan: Plan
    session: Session
    mpc_forward: Callable
    auto_batch: bool = True

    def encrypt(self, key: torch.Tensor, x_f) -> MPCTensor:
        """Secret-share a plaintext input on the session's device."""
        x = torch.as_tensor(x_f, dtype=torch.float32, device=self.session.device)
        return MPCTensor.from_plain(key, x)

    def plaintext(self, x_f, params=None):
        """Reference (non-private) forward, exact ReLU."""
        assert self.apply_fn is not None, "compiled without apply_fn"
        return self.apply_fn(params if params is not None else self.params, x_f)

    def schedule(self, streams: int = 1):
        """Predicted fused-round timeline of one ``__call__`` replay."""
        return self.plan.schedule(streams=streams, auto_batch=self.auto_batch)

    def __call__(self, xs: Union[MPCTensor, Sequence[MPCTensor]], *,
                 key: Optional[torch.Tensor] = None
                 ) -> Union[MPCTensor, List[MPCTensor]]:
        single = isinstance(xs, MPCTensor)
        tensors = [xs] if single else list(xs)
        if key is None:
            key = self.session.next_key()
        outs = self._run(tensors, key, self.session.comm,
                         self.session.provider, self.params)
        return outs[0] if single else outs

    def _run(self, tensors: List[MPCTensor], key, comm, provider, params):
        """Replay the plan over sibling streams with one shared key stream
        (``256 * streams`` keys split up front, as the reference) and one
        shared triple provider."""
        key_iter = iter(prng.split(key, 256 * max(1, len(tensors))))
        return self._run_streams(tensors, [key_iter] * len(tensors),
                                 [provider] * len(tensors), comm, params)

    def _run_streams(self, tensors: List[MPCTensor], key_iters: List,
                     providers: List, comm, params,
                     auto_batch: Optional[bool] = None):
        """Replay with per-stream key iterators and providers: at every ReLU
        call, stream i draws one key from ``key_iters[i]`` and one bundle
        from ``providers[i]``."""
        hb_layers = self.plan.hb.layers
        cone = self.plan.cone
        if auto_batch is None:
            auto_batch = self.auto_batch

        def _relu(hs: List[MPCTensor], g: int) -> List[MPCTensor]:
            hb = hb_layers[g]
            keys = [next(key_iters[i]) for i in range(len(hs))]
            tris = [providers[i].relu_triples(math.prod(h.shape), hb.width,
                                              cone=cone)
                    for i, h in enumerate(hs)]
            outs = list(hs)
            live = [i for i, h in enumerate(hs) if math.prod(h.shape)]
            if live:
                rets = relu_many([keys[i] for i in live], [hs[i] for i in live],
                                 comm=comm, hbs=[hb] * len(live),
                                 triples_list=[tris[i] for i in live],
                                 cone=cone, auto_batch=auto_batch)
                for j, i in enumerate(live):
                    outs[i] = rets[j]
            return outs

        return self.mpc_forward(params, tensors, self.cfg, _relu, comm)
