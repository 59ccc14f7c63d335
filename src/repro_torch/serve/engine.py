"""InferenceEngine: continuous cross-request batching over the fused round
timeline (twin of the reference's ``serve/engine.py``).

``PrivateModel.__call__`` serves one caller; under concurrent traffic every
request would pay its own full round count.  The engine serves traffic
instead: callers ``submit(tenant, x)`` into an admission queue and get a
future back; a schedule-driven ``BatchPolicy`` forms micro-batches from
the queue; each micro-batch executes every request as one sibling stream
of ONE plan replay, so all requests advance through the protocol in
lockstep and the batch pays **max-over-requests rounds** per ReLU call
(``core.schedule.simulate_merged`` is the exact prediction, checked
against the ``CoalescingComm`` counters).

The execution contract (held in ``tests/test_torch_serve.py``):

- **Bit-exactness**: with the default policy, batched execution of any
  request mix is bit-identical, share level, to serial per-request
  execution on the same shares and triples, and to the reference engine.
  Each request keeps its own protocol key stream (``Session.request_key
  (request_id)``, so admission order is irrelevant) and its own triples
  (from its tenant's metered provider); coalescing changes only the wire
  layout.  ``BatchPolicy(merge_identical=True)`` also merges identical
  (n_elements, k, m) streams into one protocol stream per round: each
  ReLU's revealed values are unchanged, but the output share splits
  differ, so it is opt-in.
- **Rounds**: a batch's measured fused rounds equal ``simulate_merged``'s
  prediction exactly, and equal max-over-requests rounds, not the sum.
- **Tenancy**: every tenant owns a ``beaver.MeteredProvider``; an element
  budget turns over-quota submissions into failed futures instead of
  half-run batches.

On the card a batch runs through ``PrivateModel._run_streams``: on
``HB_ROUND_LOOP=scan`` (the default) as one CUDA-graph replay per stream
signature, captured at the signature's first batch; plans with Beaver
opens (the LM) on the generator loop.  A batch's timed window ends with a
synchronize of the session's device, so ``wall`` (the straggler
watchdog's input) is the device's time, not the host's launch time.

Threads.  One re-entrant lock (``device_lock``) serialises every queue and
execution entry point and every device operation of the engine: the
encryption in ``submit``, and each batch's execution, which includes the
capture of a new stream signature's CUDA graph.  The ``Frontend`` reveals
outputs and copies them to the host under the same lock.  So no other
thread of the serving process touches the device while a graph is
captured, and the capture (``torch.cuda.graph``'s default global mode)
can neither be invalidated by another thread's allocation or sync nor
record that thread's work.  A caller that works on the device itself
while the pump runs takes ``device_lock`` too.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import errors
from ..api.compile import PrivateModel, compile as compile_model
from ..api.plan import LAN, NETWORKS, NetworkPreset, Plan, trace_plan
from ..api.session import Session
from ..core import beaver, comm as comm_lib, prng, schedule as schedule_lib
from ..core.mpc_tensor import MPCTensor
from ..runtime.watchdog import StragglerWatchdog


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """When does a micro-batch stop admitting and start running?

    Driven by ``core.schedule`` predictions: a batch admits the next queued
    request while the predicted fused-round latency *per request* of the
    merged set keeps improving, and closes when

    - the relative per-request latency gain of admitting the next request
      drops to ``min_gain`` or below,
    - ``max_batch`` requests are admitted, or
    - the head request has waited ``max_wait_s`` (checked by
      ``InferenceEngine.poll``; ``flush`` drains unconditionally).

    ``network`` prices the timeline (LAN default).  ``merge_identical``
    opts into cross-request ``relu_many`` auto-batching.  ``bucket``:
    ``"exact"`` (one plan per distinct request shape) or ``"pow2"`` (batch
    dim padded up to the next power of two with zero shares, outputs
    sliced back; the bit-exactness oracle is then serial execution of the
    padded request).
    """

    network: Union[NetworkPreset, str] = LAN
    max_batch: int = 8
    max_wait_s: float = float("inf")
    min_gain: float = 0.0
    merge_identical: bool = False
    bucket: str = "exact"

    @property
    def preset(self) -> NetworkPreset:
        return (NETWORKS[self.network] if isinstance(self.network, str)
                else self.network)

    def bucket_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = tuple(int(s) for s in shape)
        if self.bucket == "exact":
            return shape
        if self.bucket == "pow2":
            return (_next_pow2(shape[0]),) + shape[1:]
        raise ValueError(f"unknown bucket mode {self.bucket!r} "
                         "(expected 'exact' or 'pow2')")


@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted request: who asked, what they sent, when."""

    id: int
    tenant: str
    x: MPCTensor                       # possibly padded to the shape bucket
    key: torch.Tensor                  # protocol key = request_key(id)
    arrival_s: float
    shape: Tuple[int, ...]             # bucketed execution shape
    out_batch: int                     # caller's true batch (pre-padding)
    deadline_s: Optional[float] = None  # completion budget from arrival


class RequestFuture:
    """Handle for a submitted request.  ``result()`` drains the engine's
    queue if the request has not run yet, then returns the output
    MPCTensor (or raises the stored error, e.g. a tenant's
    ``TripleBudgetExceeded``)."""

    def __init__(self, engine: "InferenceEngine", request: Request):
        self._engine = engine
        self.request = request
        self._value: Optional[MPCTensor] = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self._event = threading.Event()
        self.report: Optional["BatchReport"] = None

    @property
    def done(self) -> bool:
        return self._done

    def result(self, timeout_s: Optional[float] = None) -> MPCTensor:
        """The output shares, draining the engine if needed.

        With ``timeout_s=None`` the engine is flushed once.  With a
        timeout it is *polled* (policy and ``max_wait_s`` respected) until
        the request resolves or the timeout expires, and an unresolved
        request raises ``errors.ResultTimeout``.  While the background pump
        runs, ``result`` only waits on it (``submit()`` alone makes
        progress)."""
        if not self._done:
            if self._engine.pump_running:
                if not self._event.wait(timeout_s):
                    raise errors.attach_request(
                        errors.ResultTimeout(
                            f"request {self.request.id} unresolved after "
                            f"{timeout_s}s (pump running, engine queue: "
                            f"{self._engine.pending} pending)"),
                        self.request.id, self.request.tenant)
            elif timeout_s is None:
                self._engine.flush()
            else:
                deadline = time.monotonic() + timeout_s
                while not self._done:
                    self._engine.poll()
                    if self._done:
                        break
                    if time.monotonic() >= deadline:
                        raise errors.attach_request(
                            errors.ResultTimeout(
                                f"request {self.request.id} unresolved "
                                f"after {timeout_s}s (engine queue: "
                                f"{self._engine.pending} pending)"),
                            self.request.id, self.request.tenant)
                    time.sleep(min(0.005, timeout_s / 10.0))
        if self._exc is not None:
            raise self._exc
        if not self._done:
            raise RuntimeError(
                f"request {self.request.id} did not execute: it is no "
                "longer queued but was never resolved (a batch it belonged "
                "to failed; see the engine's earlier error)")
        return self._value

    def _resolve(self, value: MPCTensor, report: "BatchReport") -> None:
        self._value, self.report, self._done = value, report, True
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        # stamp the originating request's identity, first failure wins (a
        # batch-wide exception is shared by every future it failed)
        if getattr(exc, "request_id", None) is None:
            errors.attach_request(exc, self.request.id, self.request.tenant)
        self._exc, self._done = exc, True
        self._event.set()


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """What one executed micro-batch did against what the schedule
    predicted.  ``wall_s`` is the batch's execution time, ended by a
    synchronize of the session's device."""

    request_ids: Tuple[int, ...]
    tenants: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    measured_rounds: int
    measured_bytes: int
    predicted_rounds: int             # simulate_merged over the group set
    predicted_bytes: int
    serial_rounds: int                # sum of per-request rounds (unfused)
    predicted_latency_s: float        # merged timeline under policy.network
    waits_s: Tuple[float, ...]        # per-request queue wait at execution
    retries: int = 0                  # batch re-executions on comm faults
    faults_recovered: int = 0         # transport rounds healed by re-send
    shed: int = 0                     # requests deadline-shed at admission
    wall_s: float = 0.0

    @property
    def n_requests(self) -> int:
        return len(self.request_ids)

    @property
    def rounds_saved_ratio(self) -> float:
        """Serial-to-fused round ratio: N identical requests approach N."""
        return self.serial_rounds / max(1, self.measured_rounds)

    @property
    def sim_latencies_s(self) -> Tuple[float, ...]:
        """Per-request simulated completion latency: queue wait plus the
        merged batch's schedule-predicted timeline."""
        return tuple(w + self.predicted_latency_s for w in self.waits_s)


class InferenceEngine:
    """Request-level private-inference serving over one compiled model.

    Example::

        engine = serve.InferenceEngine(afn, params, cfg, plan,
                                       api.Session(key=0),
                                       policy=serve.BatchPolicy(max_batch=4))
        f1 = engine.submit("alice", x1)        # numpy, CPU or CUDA tensor
        f2 = engine.submit("bob", x2)          # different shape: still one
        y1 = f1.result().reveal()              # micro-batch; drains the queue

    ``plan`` supplies the HummingBird (k, m) assignment and adder mode;
    plans for other request shapes are traced on demand into a cache keyed
    by ``(config, hb, bucketed shape)``.  ``tenant_budgets`` maps tenants
    to DReLU-element triple budgets; unknown tenants get
    ``default_budget`` (None = unmetered).  ``provider_factory`` hands
    each tenant its own triple source (default: inline triples).
    """

    def __init__(self, apply_fn, params, cfg, plan: Plan,
                 session: Optional[Session] = None, *,
                 policy: Optional[BatchPolicy] = None,
                 mpc_forward: Optional[Callable] = None,
                 provider_factory: Optional[Callable[[str], object]] = None,
                 tenant_budgets: Optional[Dict[str, int]] = None,
                 default_budget: Optional[int] = None,
                 report_history: int = 1024,
                 max_batch_retries: int = 2,
                 on_party_crash: Optional[Callable] = None,
                 on_straggler: Optional[Callable] = None,
                 straggler_factor: float = 3.0):
        self.policy = policy if policy is not None else BatchPolicy()
        self.session = session if session is not None else Session(key=0)
        self.model: PrivateModel = compile_model(
            apply_fn, params, cfg, plan, self.session,
            mpc_forward=mpc_forward,
            auto_batch=self.policy.merge_identical)
        self.plan = plan
        self.comm = (self.session.comm
                     if isinstance(self.session.comm, comm_lib.CoalescingComm)
                     else comm_lib.CoalescingComm(self.session.comm))
        self._provider_factory = provider_factory or (
            lambda tenant: beaver.InlineTTP())
        self._tenant_budgets = dict(tenant_budgets or {})
        self._default_budget = default_budget
        self._tenants: Dict[str, beaver.MeteredProvider] = {}
        self._plan_cache: Dict[Tuple, Plan] = {}
        if (plan.calls and plan.input_shape
                and self.policy.bucket_shape(plan.input_shape)
                == tuple(plan.input_shape)):
            # seed only when the traced shape IS its own bucket: under pow2
            # bucketing a plan traced at batch 3 must not stand in for the
            # padded batch-4 replay it would be cached under
            self._plan_cache[self._cache_key(plan.input_shape)] = plan
        self._queue: Deque[Request] = collections.deque()
        #: pending futures only: resolved ones are popped so a long-running
        #: engine never pins consumed requests' tensors
        self._futures: Dict[int, RequestFuture] = {}
        self._used_ids: set = set()
        self._next_id = 0
        #: a bounded window of recent batches (stats() percentiles read
        #: this; the counters below are lifetime totals)
        self.reports: Deque[BatchReport] = collections.deque(
            maxlen=report_history)
        self._totals = {"requests": 0, "batches": 0, "fused_rounds": 0,
                        "serial_rounds": 0, "retries": 0, "shed": 0,
                        "faults_recovered": 0}
        #: resilience: a retryable comm fault re-executes the whole batch
        #: (same request keys, providers rolled back, so the retried
        #: results are bit-identical and tenants are billed once); a
        #: PartyCrashed batch retries only if ``on_party_crash`` revives
        #: the transport
        self.max_batch_retries = max_batch_retries
        self.on_party_crash = on_party_crash
        #: transport hooks (the reference's ``transport/engine_link.py``,
        #: ROADMAP queue 1, item 7): ``on_batch_attempt(requests) -> xs``
        #: replaces each attempt's execution tensors and
        #: ``on_batch_outputs(requests, outs) -> outs`` recombines the
        #: outputs after the replay.  None = single-process execution.
        self.on_batch_attempt: Optional[Callable] = None
        self.on_batch_outputs: Optional[Callable] = None
        #: the engine lock, which is also the device lock (module
        #: docstring); re-entrant because poll -> _execute ->
        #: tenant_provider nest
        self._lock = threading.RLock()
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        self.last_pump_error: Optional[BaseException] = None
        #: slow-round detection: each executed batch's synchronized wall
        #: per fused round feeds the EWMA watchdog
        self.watchdog = StragglerWatchdog(factor=straggler_factor)
        self._on_straggler = on_straggler

    @property
    def device_lock(self) -> threading.RLock:
        """The lock under which every device operation of the serving
        process runs (module docstring, "Threads")."""
        return self._lock

    # -- plan cache ------------------------------------------------------------
    def _cache_key(self, shape: Sequence[int]) -> Tuple:
        return (type(self.model.cfg).__name__, getattr(self.model.cfg, "name", ""),
                self.plan.hb, self.plan.cone, self.policy.bucket_shape(shape))

    def plan_for_shape(self, shape: Sequence[int]) -> Plan:
        """The (cached) traced plan replayed for requests of ``shape``,
        keyed by ``(config, hb, bucketed shape)`` and traced on demand on
        the ``meta`` device (the model is never executed)."""
        key = self._cache_key(shape)
        with self._lock:           # RLock: callers already under it re-enter
            if key not in self._plan_cache:
                if self.model.apply_fn is None:
                    raise errors.ShapeMismatch(
                        f"request shape {tuple(shape)} has no traced plan "
                        "and the engine was built without apply_fn: submit "
                        f"only shape {self.plan.input_shape} or compile "
                        "with the plaintext forward")
                bucket = self.policy.bucket_shape(shape)
                self._plan_cache[key] = trace_plan(
                    self.model.apply_fn, self.model.params, bucket,
                    hb=self.plan.hb, cone=self.plan.cone,
                    name=f"{self.plan.name}@{'x'.join(map(str, bucket))}")
            return self._plan_cache[key]

    @property
    def plan_cache_size(self) -> int:
        with self._lock:
            return len(self._plan_cache)

    # -- tenancy ---------------------------------------------------------------
    def tenant_provider(self, tenant: str) -> beaver.MeteredProvider:
        with self._lock:
            if tenant not in self._tenants:
                self._tenants[tenant] = beaver.MeteredProvider(
                    self._provider_factory(tenant),
                    budget_elements=self._tenant_budgets.get(
                        tenant, self._default_budget))
            return self._tenants[tenant]

    def tenant_usage(self, tenant: str) -> Dict[str, Optional[int]]:
        p = self.tenant_provider(tenant)
        return {"consumed_elements": p.consumed_elements,
                "consumed_bundles": p.consumed_bundles,
                "budget_elements": p.budget_elements,
                "remaining_elements": p.remaining_elements}

    @staticmethod
    def _required_elements(plan: Plan) -> int:
        return sum(n for n, w in plan.triple_specs() if n and w)

    # -- admission -------------------------------------------------------------
    def submit(self, tenant: str, x, *, request_id: Optional[int] = None,
               arrival_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> RequestFuture:
        """Enqueue one request; returns its future.

        ``x`` is the caller's secret-shared ``MPCTensor``, or a plain
        array (numpy, a CPU or a CUDA tensor), which is secret-shared on
        the session's device with a key split off the request key.
        ``request_id`` defaults to an auto-increment; an explicit id makes
        the request's protocol randomness independent of submission order.

        ``deadline_s`` is a completion budget from arrival: at execution a
        request whose schedule-predicted solo latency already overruns the
        remaining budget is shed, its future failing with
        ``errors.DeadlineExceeded`` before any round or triple is spent.

        The request's plan is resolved here, so an unservable shape fails
        the submit call and never a queued batch.
        """
        with self._lock:
            if request_id is None:
                request_id = self._next_id
            if request_id in self._used_ids:
                raise errors.DuplicateRequest(
                    f"request id {request_id} already submitted")
            self.plan_for_shape(x.shape)
            self._used_ids.add(request_id)
            self._next_id = max(self._next_id, request_id + 1)
            key = self.session.request_key(request_id)
            if not isinstance(x, MPCTensor):
                enc_key, key = prng.split(key)
                x = MPCTensor.from_plain(enc_key, torch.as_tensor(
                    x, dtype=torch.float32, device=self.session.device))
            out_batch = int(x.shape[0])
            bucket = self.policy.bucket_shape(x.shape)
            if bucket != tuple(x.shape):
                pad = torch.zeros((x.data.shape[0], bucket[0] - out_batch)
                                  + tuple(x.data.shape[2:]), dtype=x.data.dtype,
                                  device=x.data.device)
                x = MPCTensor(torch.cat([x.data, pad], dim=1), x.frac_bits)
            req = Request(id=request_id, tenant=tenant, x=x, key=key,
                          arrival_s=(time.monotonic() if arrival_s is None
                                     else float(arrival_s)),
                          shape=bucket, out_batch=out_batch,
                          deadline_s=(None if deadline_s is None
                                      else float(deadline_s)))
            fut = RequestFuture(self, req)
            self._futures[request_id] = fut
            self._queue.append(req)
            return fut

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- batching policy evaluation -------------------------------------------
    def _merged_schedule(self, requests: Sequence[Request]):
        """Exact fused timeline of executing ``requests`` as one batch:
        ``simulate_merged`` over the ReLU call rows, plus one coalesced
        round per Beaver-open site (the LM's secret products).  Open sites
        align positionally across requests (one forward drives every
        sibling stream), so site i of all requests shares one round."""
        plans = [self.plan_for_shape(r.shape) for r in requests]
        sched = schedule_lib.simulate_merged(
            [p.call_specs() for p in plans],
            cone=self.plan.cone, auto_batch=self.policy.merge_identical)
        open_lists = [p.open_specs() for p in plans]
        for i in range(max((len(o) for o in open_lists), default=0)):
            sched = sched + schedule_lib.simulate_open(
                [o[i] for o in open_lists if i < len(o)])
        return sched

    def _merged_latency(self, requests: Sequence[Request]) -> float:
        sched = self._merged_schedule(requests)
        preset = self.policy.preset
        return sched.latency(preset.bandwidth_bps, preset.rtt_s)

    def _form_batch(self) -> List[Request]:
        """Admit from the queue head while the predicted per-request
        latency of the merged set keeps improving by more than
        ``policy.min_gain`` (relative); the incumbent latency is carried
        forward, so a batch of B costs B merged-schedule simulations."""
        batch = [self._queue.popleft()]
        lat = self._merged_latency(batch)
        while self._queue and len(batch) < self.policy.max_batch:
            n = len(batch)
            lat_new = self._merged_latency(batch + [self._queue[0]])
            if lat <= 0.0:
                # zero-round incumbent (fully culled plan): merging is free
                gain = 1.0
            else:
                gain = 1.0 - (lat_new / (n + 1)) / (lat / n)
            if gain <= self.policy.min_gain:
                break
            batch.append(self._queue.popleft())
            lat = lat_new
        return batch

    # -- execution -------------------------------------------------------------
    def poll(self, now_s: Optional[float] = None) -> List[BatchReport]:
        """Run every batch that is *ready*: the policy closed it with
        requests still queued behind it, it is full, or its head request
        hit the ``max_wait_s`` deadline.  Returns the executed reports."""
        now = time.monotonic() if now_s is None else float(now_s)
        executed = []
        with self._lock:
            while self._queue:
                head_wait = now - self._queue[0].arrival_s
                deadline = head_wait >= self.policy.max_wait_s
                batch = self._form_batch()
                ready = (deadline or len(batch) >= self.policy.max_batch
                         or bool(self._queue))
                if not ready:
                    # put the still-open batch back, wait for more traffic
                    self._queue.extendleft(reversed(batch))
                    break
                report = self._execute(batch, now)
                if report is not None:
                    executed.append(report)
        return executed

    def flush(self) -> List[BatchReport]:
        """Drain the queue unconditionally (deadlines ignored): form
        policy-shaped batches until nothing is pending."""
        executed = []
        with self._lock:
            while self._queue:
                report = self._execute(self._form_batch(), time.monotonic())
                if report is not None:
                    executed.append(report)
        return executed

    def _sync(self) -> None:
        """End a timed window on the device: the replay returns before the
        card finishes."""
        if self.session.device.type == "cuda":
            torch.cuda.synchronize(self.session.device)

    def _execute(self, batch: List[Request],
                 now_s: float) -> Optional[BatchReport]:
        # deadline shedding first: a request whose schedule-predicted solo
        # latency already overruns its remaining budget provably cannot
        # finish in time; fail it typed, before reserving any triples
        shed = 0
        survivors: List[Request] = []
        for r in batch:
            if (r.deadline_s is not None
                    and (now_s - r.arrival_s) + self._merged_latency([r])
                    > r.deadline_s):
                self._futures.pop(r.id)._fail(errors.DeadlineExceeded(
                    f"request {r.id} (tenant {r.tenant!r}): "
                    f"{now_s - r.arrival_s:.3f}s already queued and the "
                    f"schedule-predicted replay alone overruns the "
                    f"{r.deadline_s}s deadline; shed before execution"))
                shed += 1
                continue
            survivors.append(r)
        self._totals["shed"] += shed
        # pre-reserve tenant budgets so a mid-protocol budget error can
        # never leave a half-executed batch: over-quota requests fail their
        # futures here and are dropped before any protocol round
        reserved: Dict[str, int] = {}
        admitted: List[Request] = []
        for r in survivors:
            need = self._required_elements(self.plan_for_shape(r.shape))
            provider = self.tenant_provider(r.tenant)
            if provider.budget_elements is not None:
                already = provider.consumed_elements + reserved.get(r.tenant, 0)
                if already + need > provider.budget_elements:
                    self._futures.pop(r.id)._fail(beaver.TripleBudgetExceeded(
                        f"tenant {r.tenant!r}: request {r.id} needs {need} "
                        f"DReLU elements but only "
                        f"{provider.budget_elements - already} of "
                        f"{provider.budget_elements} remain"))
                    continue
            reserved[r.tenant] = reserved.get(r.tenant, 0) + need
            admitted.append(r)
        if not admitted:                 # every request over quota or shed
            return None
        sched = self._merged_schedule(admitted)
        serial_rounds = sum(self.plan_for_shape(r.shape).schedule().n_rounds
                            for r in admitted)
        providers = [self.tenant_provider(r.tenant) for r in admitted]
        resilient = comm_lib.find_resilient(self.comm)
        attempts = 0
        while True:
            # per attempt: fresh key iterators (same request keys: the retry
            # draws the identical stream), provider checkpoints (a rolled-
            # back tenant redraws identical triples and is billed once), and
            # fresh round/byte marks (the report holds the successful
            # attempt only)
            rounds0, bytes0 = self.comm.n_rounds, self.comm.bytes_tx
            recovered0 = resilient.recovered if resilient else 0
            tokens = [(p, p.checkpoint()) for p in dict.fromkeys(providers)]
            key_iters = [iter(prng.split(r.key, 256)) for r in admitted]
            xs = [r.x for r in admitted]
            if self.on_batch_attempt is not None:
                xs = self.on_batch_attempt(admitted)
            self._sync()
            t0 = time.monotonic()
            try:
                outs = self.model._run_streams(
                    xs, key_iters, providers, self.comm, self.model.params,
                    auto_batch=self.policy.merge_identical)
                break
            except BaseException as e:
                for p, tok in tokens:
                    p.rollback(tok)
                crash = isinstance(e, errors.PartyCrashed)
                retryable = (errors.is_retryable(e)
                             or (crash and self.on_party_crash is not None))
                if not retryable or attempts >= self.max_batch_retries:
                    # a failed replay must not strand its futures
                    for r in admitted:
                        self._futures.pop(r.id)._fail(e)
                    raise
                if crash:
                    self.on_party_crash(e)      # revive the transport
                attempts += 1
                self._totals["retries"] += 1
        if self.on_batch_outputs is not None:
            outs = self.on_batch_outputs(admitted, outs)
        self._sync()
        wall = time.monotonic() - t0
        faults_recovered = ((resilient.recovered - recovered0)
                            if resilient else 0)
        self._totals["faults_recovered"] += faults_recovered
        preset = self.policy.preset
        report = BatchReport(
            request_ids=tuple(r.id for r in admitted),
            tenants=tuple(r.tenant for r in admitted),
            shapes=tuple(r.shape for r in admitted),
            measured_rounds=self.comm.n_rounds - rounds0,
            measured_bytes=self.comm.bytes_tx - bytes0,
            predicted_rounds=sched.n_rounds,
            predicted_bytes=sched.bytes_tx,
            serial_rounds=serial_rounds,
            predicted_latency_s=sched.latency(preset.bandwidth_bps,
                                              preset.rtt_s),
            waits_s=tuple(max(0.0, now_s - r.arrival_s) for r in admitted),
            retries=attempts,
            faults_recovered=faults_recovered,
            shed=shed,
            wall_s=wall)
        self.reports.append(report)
        self._totals["requests"] += report.n_requests
        self._totals["batches"] += 1
        self._totals["fused_rounds"] += report.measured_rounds
        self._totals["serial_rounds"] += report.serial_rounds
        if report.measured_rounds:     # slow-round watchdog (shared EWMA)
            self.watchdog.observe(len(self.reports) - 1,
                                  wall / report.measured_rounds,
                                  on_straggler=self._on_straggler)
        for r, out in zip(admitted, outs):
            if r.out_batch != r.shape[0]:      # slice bucket padding back off
                out = MPCTensor(out.data[:, :r.out_batch], out.frac_bits)
            self._futures.pop(r.id)._resolve(out, report)
        return report

    # -- background pump -------------------------------------------------------
    @property
    def pump_running(self) -> bool:
        return self._pump_thread is not None and self._pump_thread.is_alive()

    def start_pump(self, interval_s: float = 0.005,
                   max_wait_s: Optional[float] = None) -> None:
        """Drive the engine from a daemon thread so ``submit()`` alone makes
        progress: the pump ``poll``s continuously, and once the head
        request has aged past ``max_wait_s`` (default: the policy's, or 50
        ms when that is unbounded) it ``flush``es so a lone request is
        never stranded.  ``poll`` and ``flush`` stay safe to call manually
        (everything serialises on the engine lock).  A batch failure in the
        pump fails its futures as a caller-driven batch would and is kept
        in ``last_pump_error``; the pump keeps running."""
        if self.pump_running:
            return
        if max_wait_s is None:
            max_wait_s = (self.policy.max_wait_s
                          if self.policy.max_wait_s != float("inf") else 0.05)
        self._pump_stop.clear()
        self._pump_thread = threading.Thread(
            target=self._pump_loop, args=(float(interval_s), float(max_wait_s)),
            name="engine-pump", daemon=True)
        self._pump_thread.start()

    def stop_pump(self, timeout_s: float = 5.0) -> None:
        """Stop the background pump (pending requests stay queued)."""
        if self._pump_thread is None:
            return
        self._pump_stop.set()
        self._pump_thread.join(timeout_s)
        self._pump_thread = None

    def _pump_loop(self, interval_s: float, max_wait_s: float) -> None:
        while not self._pump_stop.is_set():
            try:
                executed = self.poll()
                if not executed:
                    with self._lock:
                        head = self._queue[0] if self._queue else None
                        age = (time.monotonic() - head.arrival_s
                               if head is not None else -1.0)
                    if head is not None and age >= max_wait_s:
                        self.flush()
            except Exception as e:          # futures already failed, typed
                with self._lock:
                    self.last_pump_error = e
            self._pump_stop.wait(interval_s)

    # -- aggregate stats -------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Lifetime totals (fused against serial rounds over every executed
        batch) plus the simulated per-request latency distribution (queue
        wait + the merged timeline under ``policy.network``) over the
        retained ``report_history`` window."""
        with self._lock:
            lats = sorted(l for rep in self.reports for l in rep.sim_latencies_s)
            totals = dict(self._totals)

        def pct(p: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(p * len(lats)))]

        return {
            **totals,
            "rounds_saved_ratio": (totals["serial_rounds"]
                                   / max(1, totals["fused_rounds"])),
            "p50_sim_latency_s": pct(0.50),
            "p95_sim_latency_s": pct(0.95),
            "slow_batches": len(self.watchdog.stragglers),
        }
