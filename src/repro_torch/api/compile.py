"""compile(): bind (model, Plan, Session) into a callable PrivateModel
(twin of the reference's ``api/compile.py``).

The MPC forward of a model family is registered once
(``register_mpc_forward``) as ``forward(params, tensors, cfg, relu_fn,
comm) -> tensors`` over sibling ``MPCTensor`` streams.  ``PrivateModel``
replays the Plan: every ReLU call draws its keys from the Session's PRNG
stream and its triples from the Session's provider, and sibling streams
share protocol rounds through ``relu_many``.  Keys are consumed in exactly
the reference's order, so outputs are share-level bit-identical to it.

Models with secret-by-secret products (the LM's attention and gating)
reach them through ``relu_fn.matmul`` / ``relu_fn.mul``: at every product
site each stream draws one key from its key stream, interleaved with the
ReLU calls' draws in call order, and derives its Beaver triple inline from
it; sibling streams' opens coalesce into one round (``products_many``).

Two round loops run the replay (``runtime/loop.py``): the generator loop,
and, by default wherever the comm allows, the captured replay: one call's
whole online phase captured once per stream signature as a CUDA graph,
then replayed with each call's inputs, keys and triples copied into its
input buffers.  Both give the same shares.  Plans with open sites stay on
the generator loop under both settings, as in the reference: their
product keys are drawn between the ReLU calls' draws, which the replay's
pre-drawn payload does not hold.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from .. import errors
from ..core import beaver, comm as comm_lib, prng
from ..core.mpc_tensor import MPCTensor, products_many, relu_many
from ..kernels import ops
from ..runtime import loop as loop_lib
from .plan import Plan
from .session import Session

_MPC_FORWARDS: Dict[type, Callable] = {}

# Captured whole-call replays, shared across PrivateModel instances: the
# key pins the forward, the plan content (digest), the stream signature,
# the structure and leaf shapes of (params, inputs, keys and triples) and
# the device, so two models compiled from one plan reuse one graph (a
# model with other weights of the same shapes too: the params are inputs).
_REPLAY_CACHE: Dict = {}

_TENSOR = "tensor"
_FIELDS: Dict[type, Tuple[str, ...]] = {}      # a dataclass type's field names


def _flatten(tree, leaves: List[torch.Tensor]):
    """The hashable structure of ``tree``, its tensors appended to
    ``leaves`` in order.  Dicts, lists, tuples and dataclasses are walked;
    any other value (None, a number) stays in the structure."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    kind = type(tree)
    names = _FIELDS.get(kind)
    if names is None:
        names = _FIELDS[kind] = (tuple(f.name for f in dataclasses.fields(kind))
                                 if dataclasses.is_dataclass(kind) else ())
    if names:
        return (kind, tuple((n, _flatten(getattr(tree, n), leaves)) for n in names))
    return ("const", tree)


def _unflatten(spec, leaves: Iterator[torch.Tensor]):
    """Inverse of ``_flatten``: the tree of ``spec`` over ``leaves``."""
    if spec == _TENSOR:
        return next(leaves)
    kind, body = spec
    if kind == "const":
        return body
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind in (list, tuple):
        return kind(_unflatten(v, leaves) for v in body)
    return kind(**{k: _unflatten(v, leaves) for k, v in body})


def _cloned(tree):
    """``tree`` with every tensor cloned."""
    leaves: List[torch.Tensor] = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


@dataclasses.dataclass
class _ReplayEntry:
    """One captured replay: the input buffers it reads (``statics``, in
    ``_flatten`` order of (params, input shares, per-call keys and
    triples)), ``run`` (replays it over them and returns cloned outputs),
    the private comm whose counters hold one call's round timeline, the
    capture's cost split and the kernel launches it captured (the
    wrappers' counters tick during the capture only; ``pack_ring_masked``
    counts the masked ``pack_ring`` launches among them)."""

    statics: List[torch.Tensor]
    run: Callable[[], object]
    comm: comm_lib.CoalescingComm
    trace_s: float
    compile_s: float
    launches: Dict[str, int]

    def __post_init__(self):
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(self.statics):
            groups.setdefault(t.dtype, []).append(i)
        self._groups = [(idx, [self.statics[i] for i in idx])
                        for idx in groups.values()]

    def load(self, leaves: Sequence[torch.Tensor]) -> None:
        """Refill the input buffers from ``leaves`` (same order, shapes and
        dtypes): one ``torch._foreach_copy_`` per dtype, a few multi-tensor
        launches on the card where one ``copy_`` per tensor would take
        hundreds."""
        for idx, dsts in self._groups:
            torch._foreach_copy_(dsts, [leaves[i] for i in idx])

    def __call__(self, leaves: Sequence[torch.Tensor]):
        self.load(leaves)
        return self.run()


def replay_cache_stats() -> List[Dict]:
    """Every captured replay built in this process: ``trace_s`` (the
    capture pass: the forward run once on the host with every launch
    recorded into the graph), ``compile_s`` (the graph's instantiation
    and upload: ``capture_end``, then one replay of the first call's
    inputs, checked against that call's eager result) and the fused round
    count one replay carries.  On the CPU nothing is captured and both
    times are 0."""
    return [{"trace_s": e.trace_s, "compile_s": e.compile_s,
             "n_rounds": e.comm.n_rounds} for e in _REPLAY_CACHE.values()]


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
    streams share protocol rounds via ``relu_many``.  ``serve_step()``
    gives the same replay as ``step(params, x, triples, key)``.
    """

    apply_fn: Optional[Callable]
    params: object
    cfg: object
    plan: Plan
    session: Session
    mpc_forward: Callable
    auto_batch: bool = True
    _step_cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)
    _layout_cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                            compare=False)

    def encrypt(self, key: torch.Tensor, x_f) -> MPCTensor:
        """Secret-share a plaintext input on the session's device."""
        x = torch.as_tensor(x_f, dtype=torch.float32, device=self.session.device)
        return MPCTensor.from_plain(key, x)

    def plaintext(self, x_f, params=None):
        """Reference (non-private) forward, exact ReLU."""
        assert self.apply_fn is not None, "compiled without apply_fn"
        return self.apply_fn(params if params is not None else self.params, x_f)

    def estimate(self, *args, **kwargs) -> float:
        """``plan.estimate`` under this model's auto-batching."""
        kwargs.setdefault("auto_batch", self.auto_batch)
        return self.plan.estimate(*args, **kwargs)

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

    def _draw(self, key_iters: List, providers: List, g: int,
              ns: Sequence[int]):
        """One ReLU call's keys and triples, drawn as the generator loop
        draws them: one key per stream, then one bundle per stream."""
        width = self.plan.hb.layers[g].width
        keys = tuple(next(key_iters[i]) for i in range(len(ns)))
        tris = tuple(providers[i].relu_triples(n, width, cone=self.plan.cone)
                     for i, n in enumerate(ns))
        return keys, tris

    def _forward(self, params, tensors, comm, auto_batch: bool, call_inputs,
                 open_keys=None):
        """The registered forward over sibling streams: every ReLU call
        runs ``relu_many`` on the keys and triples ``call_inputs(hs, g)``
        gives it; zero-element streams pass through.  With ``open_keys``
        (``open_keys(n)``: one key per stream) the forward's
        ``relu_fn.matmul`` / ``relu_fn.mul`` run ``products_many`` with
        triples derived inline from those keys."""
        hb_layers = self.plan.hb.layers
        cone = self.plan.cone

        def _relu(hs: List[MPCTensor], g: int) -> List[MPCTensor]:
            keys, tris = call_inputs(hs, g)
            outs = list(hs)
            live = [i for i, h in enumerate(hs) if math.prod(h.shape)]
            if live:
                rets = relu_many([keys[i] for i in live], [hs[i] for i in live],
                                 comm=comm, hbs=[hb_layers[g]] * len(live),
                                 triples_list=[tris[i] for i in live],
                                 cone=cone, auto_batch=auto_batch)
                for j, i in enumerate(live):
                    outs[i] = rets[j]
            return outs

        if open_keys is not None:
            def _products(kind, xs, ys):
                return products_many([kind] * len(xs), open_keys(len(xs)), xs, ys,
                                     comm=comm)

            _relu.matmul = lambda xs, ys: _products("matmul", xs, ys)
            _relu.mul = lambda xs, ys: _products("mul", xs, ys)
        return self.mpc_forward(params, list(tensors), self.cfg, _relu, comm)

    def _run_streams(self, tensors: List[MPCTensor], key_iters: List,
                     providers: List, comm, params,
                     auto_batch: Optional[bool] = None):
        """Replay with per-stream key iterators and providers: at every ReLU
        call, stream i draws one key from ``key_iters[i]`` and one bundle
        from ``providers[i]``, and at every product site one key from
        ``key_iters[i]``.  On ``HB_ROUND_LOOP=scan`` (the default), an
        eligible comm and a plan without open sites, the captured replay
        runs it."""
        if auto_batch is None:
            auto_batch = self.auto_batch
        if (loop_lib.round_loop_mode() == "scan"
                and loop_lib.compiled_eligible(comm) and not self.plan.opens):
            return self._run_streams_compiled(tensors, key_iters, providers,
                                              comm, params, auto_batch)
        return self._forward(
            params, tensors, comm, auto_batch,
            lambda hs, g: self._draw(key_iters, providers, g,
                                     [math.prod(h.shape) for h in hs]),
            lambda n: [next(key_iters[i]) for i in range(n)])

    # -- captured replay -------------------------------------------------------
    def _stream_sig(self, tensors: Sequence[MPCTensor], auto_batch: bool):
        return (auto_batch,) + tuple(
            (tuple(t.shape), t.frac_bits, t.data.dtype, str(t.data.device))
            for t in tensors)

    def _relu_layout(self, tensors: Sequence[MPCTensor], auto_batch: bool):
        """Per-ReLU-call (group, per-stream element counts) of one replay,
        in call order, as the signature's first call recorded it; None
        before that call.  The reference records it in an abstract pass;
        the kernel wrappers here take only CPU or CUDA tensors, so the
        first call runs the generator loop and records it, which also
        builds every kernel at every shape the capture meets."""
        return self._layout_cache.get(self._stream_sig(tensors, auto_batch))

    def _plan_digest(self) -> str:
        if "digest" not in self._layout_cache:
            self._layout_cache["digest"] = self.plan.digest()
        return self._layout_cache["digest"]

    def _capture(self, spec, leaves: List[torch.Tensor], auto_batch: bool,
                 first) -> _ReplayEntry:
        """A new replay of the forward over input buffers shaped as
        ``leaves`` (``spec``: their structure), loaded with this call's.
        On CUDA the forward runs once under stream capture into a CUDA
        graph, which is then instantiated and replayed once; on the CPU the
        replay is the same forward run eagerly over the buffers, once here
        and at every call.  Either way it runs on a private
        ``CoalescingComm``, whose counters must equal the generator loop's
        (``first``: that loop's outputs and comm for this call), and its
        outputs must equal that loop's.  Any failure raises."""
        statics = [torch.empty_like(t) for t in leaves]

        def replay(comm):
            params, tensors, payload = _unflatten(spec, iter(statics))
            calls = iter(payload)
            return self._forward(params, tensors, comm, auto_batch,
                                 lambda hs, g: next(calls))

        want, rec = first
        cuda = bool(statics) and statics[0].device.type == "cuda"
        cc = comm_lib.CoalescingComm()
        before, masked = ops.launch_counts(), ops.pack_ring.masked
        if cuda:
            graph = torch.cuda.CUDAGraph()
            out_leaves: List[torch.Tensor] = []
            with torch.cuda.graph(graph):
                t0 = time.perf_counter()
                out_spec = _flatten(replay(cc), out_leaves)
                t1 = time.perf_counter()

            def run():
                graph.replay()
                return _unflatten(out_spec, iter([t.clone() for t in out_leaves]))
        else:
            def run():
                return _cloned(replay(comm_lib.CoalescingComm()))
        entry = _ReplayEntry(statics=statics, run=run, comm=rec, trace_s=0.0,
                             compile_s=0.0, launches={})
        entry.load(leaves)
        if cuda:
            got = run()         # replays count nothing: the delta is the capture's
            torch.cuda.synchronize()
            entry.trace_s, entry.compile_s = t1 - t0, time.perf_counter() - t1
        else:
            got = _cloned(replay(cc))
        entry.launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
        entry.launches["pack_ring_masked"] = ops.pack_ring.masked - masked
        if (cc.n_rounds, cc.round_bytes, cc.round_parts) != \
                (rec.n_rounds, rec.round_bytes, rec.round_parts):
            raise RuntimeError("captured replay: its round timeline differs from "
                               "the generator loop's")
        got_leaves: List[torch.Tensor] = []
        want_leaves: List[torch.Tensor] = []
        if _flatten(got, got_leaves) != _flatten(want, want_leaves) or not all(
                torch.equal(a, b) for a, b in zip(got_leaves, want_leaves)):
            raise RuntimeError("captured replay: its first run differs from the "
                               "generator loop's outputs")
        return entry

    def _compiled_replay(self, sig, auto_batch: bool, params, tensors, payload,
                         first=None):
        """The captured replay for this call's structure, built on a miss,
        and this call's outputs: ``first``'s (the generator loop's outputs
        and comm, when this call already ran it) or the replay's.

        Keys and triples enter as inputs, copied into the replay's buffers
        at every call, never baked in; so do the params, so a model with
        other weights of the same shapes reuses the entry.  Everything that
        changes what is captured is in the cache key: the forward, the plan
        digest, the stream signature, the structure and leaf shapes and
        dtypes of (params, inputs, payload), the device."""
        leaves: List[torch.Tensor] = []
        spec = _flatten((params, tuple(tensors), tuple(payload)), leaves)
        device = tensors[0].data.device if tensors else self.session.device
        key = (self.mpc_forward, self._plan_digest(), sig, auto_batch, spec,
               tuple((t.shape, t.dtype) for t in leaves), str(device))
        entry = _REPLAY_CACHE.get(key)
        if entry is None:
            if first is None:
                # a params or payload structure not run yet: run it on the
                # generator loop first, as a signature's first call does
                rec, calls = comm_lib.CoalescingComm(), iter(payload)
                first = (self._forward(params, tensors, rec, auto_batch,
                                       lambda hs, g: next(calls)), rec)
            entry = _REPLAY_CACHE[key] = self._capture(spec, leaves, auto_batch,
                                                       first)
        return entry, (first[0] if first is not None else entry(leaves))

    def _run_streams_compiled(self, tensors: List[MPCTensor], key_iters,
                              providers, comm, params, auto_batch: bool):
        """``_run_streams`` on the captured replay.

        Same contract, same share-level outputs: stream i draws one key
        from ``key_iters[i]`` and one provider bundle per ReLU call in call
        order, all before the replay runs (so triple metering, pool
        positions and ``checkpoint``/``rollback`` behave as on the
        generator loop), then one replay runs the whole online phase.  A
        signature's first call runs the generator loop, drawing as it goes,
        to record the layout; the capture follows it.  The caller's
        ``CoalescingComm`` counters advance by the recorded timeline."""
        sig = self._stream_sig(tensors, auto_batch)
        layout = self._relu_layout(tensors, auto_batch)
        first = None
        if layout is None:
            record: List = []
            rec = comm_lib.CoalescingComm()

            def draw(hs, g):
                ns = tuple(math.prod(h.shape) for h in hs)
                record.append((g, ns, self._draw(key_iters, providers, g, ns)))
                return record[-1][2]

            first = (self._forward(params, tensors, rec, auto_batch, draw), rec)
            self._layout_cache[sig] = tuple((g, ns) for g, ns, _ in record)
            payload = [inputs for _, _, inputs in record]
        else:
            payload = [self._draw(key_iters, providers, g, ns) for g, ns in layout]
        entry, outs = self._compiled_replay(sig, auto_batch, params, tensors,
                                            payload, first)
        if isinstance(comm, comm_lib.CoalescingComm):
            comm.replay_counters(entry.comm.n_rounds, list(entry.comm.round_bytes),
                                 list(entry.comm.round_parts))
        return outs

    def _replay_entry(self, tensors: Sequence[MPCTensor],
                      auto_batch: Optional[bool] = None) -> Optional[_ReplayEntry]:
        if auto_batch is None:
            auto_batch = self.auto_batch
        sig = self._stream_sig(list(tensors), auto_batch)
        for key, entry in _REPLAY_CACHE.items():
            # hbcheck: disable=R003 -- sig holds shapes, dtypes and devices only
            if key[0] is self.mpc_forward and key[1] == self._plan_digest() \
                    and key[2] == sig:
                return entry
        return None

    def replay_stats(self, tensors: Sequence[MPCTensor],
                     auto_batch: Optional[bool] = None) -> Optional[Dict]:
        """The captured replay's cost split (see ``replay_cache_stats``),
        round count and captured kernel launches for this stream
        signature, if one has been built."""
        entry = self._replay_entry(tensors, auto_batch)
        if entry is None:
            return None
        return {"trace_s": entry.trace_s, "compile_s": entry.compile_s,
                "n_rounds": entry.comm.n_rounds, "launches": dict(entry.launches)}

    # -- serving step -----------------------------------------------------------
    def serve_step(self, mesh=None, *, party_axis: str = "party",
                   data_axis: Optional[str] = None) -> Callable:
        """step(params, x, triples, key) -> x_out: the replay of one input
        ``x``, the int64 (2, B, ...) share tensor, with ``triples`` (one
        bundle or None per ReLU call, see ``Plan.triple_specs``) as the
        pool.

        With ``mesh=None`` the replay runs on the session's comm with the
        party dimension materialised, from ``triples`` or, when None, the
        session's provider.

        With a mesh (``launch.mesh``) carrying ``party_axis``, the step is
        mesh-native, as the reference's is under ``shard_map``: every rank
        of the mesh calls it with the same global arguments, takes its own
        block (its party rows of ``x``, and of every pool leaf at the
        position ``beaver.pool_party_specs`` gives), runs the replay under
        ``CoalescingComm(MeshComm(...))``, so every fused protocol round is
        exactly ONE exchange, and returns its block of the output
        (``mesh.gather(out, step.spec)`` assembles the global tensor).
        The step keeps the last call's comm as ``step.comm``, whose
        counters must equal ``plan.schedule()`` round for round;
        ``step.census`` is its ``MeshComm``'s census of the exchanges it
        made, which must too, except on the captured replay of a party
        axis of size 1: the graph holds those flips, and the census stays
        empty.  The party axis has size 2
        (one rank per party) or 1 (``make_mpc_smoke_mesh``: both parties in
        this process, the exchanges local flips).  The mesh path needs an
        explicit triple pool: an inline provider would have to conjure
        cross-party randomness inside one party's rank.

        With ``data_axis``, the request batch is split over that mesh axis
        too: ``x``'s batch dimension is split, ``triples`` must be
        ``beaver.shard_pool(pool, mesh.shape[data_axis])`` (each leaf with
        a leading data-shard dimension holding that shard's bit-level
        element slice), and every data shard runs its own party-axis
        protocol on its batch rows: the same rounds, per-shard bytes, and
        a reveal equal to the unsharded replay's within the truncation's
        error.
        """
        if mesh is None:
            def step(params, x, triples, key):
                provider = (beaver.TriplePool(triples) if triples is not None
                            else self.session.provider)
                return self._run([MPCTensor(x)], key, self.session.comm, provider,
                                 params)[0].data

            return step
        if party_axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} carry no {party_axis!r} axis")
        if data_axis is not None and data_axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} carry no {data_axis!r} axis")
        return _MeshStep(self, mesh, party_axis, data_axis)

    def jit_step(self, mesh=None, *, party_axis: str = "party",
                 data_axis: Optional[str] = None) -> Callable:
        """``serve_step`` built once per (mesh, party_axis, data_axis).
        On the default ``scan`` round loop (``runtime/loop.py``) the inner
        replay of ``mesh=None`` and of a party axis of size 1 runs through
        the cached captured graph: providers draw outside it, and the
        online phase is one graph replay.  A party axis of size 2 runs the
        generator loop: its exchanges go through a process group, and a
        gloo exchange (host staging, a blocking wait) cannot sit in a CUDA
        graph."""
        cache_key = (mesh, party_axis, data_axis)
        if cache_key not in self._step_cache:
            self._step_cache[cache_key] = self.serve_step(
                mesh, party_axis=party_axis, data_axis=data_axis)
        return self._step_cache[cache_key]


class _MeshStep:
    """``PrivateModel.serve_step(mesh)``: one rank's mesh-native step (see
    there).  ``spec`` is the partition of the input and output share
    tensors: ``(party_axis, data_axis)``, or ``(party_axis,)``."""

    def __init__(self, model: PrivateModel, mesh, party_axis: str,
                 data_axis: Optional[str]):
        self.model = model
        self.mesh = mesh
        self.party_axis = party_axis
        self.data_axis = data_axis
        self.spec = (party_axis, data_axis) if data_axis else (party_axis,)
        self.comm: Optional[comm_lib.CoalescingComm] = None

    @property
    def census(self) -> List[comm_lib.Collective]:
        """The last call's exchanges handed to its ``MeshComm``, one entry
        each (none on a captured replay)."""
        return self.comm.base.census if self.comm is not None else []

    def _local_pool(self, triples) -> List:
        """This rank's block of every pool leaf (party rows at the
        structural party position; with a data axis, its own shard of the
        leading data-shard dimension, which is then dropped)."""
        mesh, data_axis = self.mesh, self.data_axis
        specs = beaver.pool_party_specs(triples, self.party_axis, data_axis=data_axis)

        def block(leaf, spec):
            leaf = mesh.local_block(leaf, spec)
            return leaf[0] if data_axis is not None else leaf

        return [None if b is None else beaver.map_bundle(block, b, sp)
                for b, sp in zip(triples, specs)]

    def __call__(self, params, x: torch.Tensor, triples, key) -> torch.Tensor:
        if triples is None:
            raise ValueError("mesh-native serve_step needs an offline triple pool "
                             "(beaver.gen_plan_triples(key, plan.triple_specs()))")
        mesh = self.mesh
        self.comm = comm_lib.CoalescingComm(comm_lib.MeshComm(
            self.party_axis, mesh.shape[self.party_axis], mesh=mesh))
        x_local = mesh.local_block(x, self.spec)
        return self.model._run([MPCTensor(x_local)], key, self.comm,
                               beaver.TriplePool(self._local_pool(triples)),
                               params)[0].data
