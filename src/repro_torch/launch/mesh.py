"""MPC meshes over ``torch.distributed`` (twin of the reference's
``launch/mesh.py``).

A ``Mesh`` is this process's view of a grid of ranks with named axes, as a
jax mesh is of a grid of devices: ``axis_names``, ``shape`` (name -> size),
this rank's ``coords`` (name -> index) and, for every axis longer than 1,
the subgroup of ranks that differ from this one only along it (built with
``dist.new_group``).  The MPC mesh is (party, data): the party axis is
always 2 (two non-colluding servers), the data axis splits the request
batch.  Ranks are laid out party-major, as ``jax.make_mesh((2, n_data))``
lays out devices: rank r sits at (r // n_data, r % n_data).

The backend is an argument, never a guess:

- ``gloo``: every exchange is staged through (pinned, for a CUDA payload)
  host memory explicitly; this is how two party ranks share one card;
- ``nccl``: device tensors go to the wire as they are.  NCCL refuses two
  ranks on one device, so ``make_mpc_mesh`` raises when two of its ranks
  name the same device instead of turning into gloo.

Processes meet through ``torch.distributed``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or an explicit
``init_method`` with ``rank``.  Building a mesh starts no process;
``spawn_local`` starts the ranks of a mesh on one host (``chip_smoke.py``'s
``mesh`` phase runs two and four of them on one card).
"""
from __future__ import annotations

import importlib.util
import io
import multiprocessing
import os
import queue
import socket
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import Device, resolve as resolve_device

BACKENDS = ("gloo", "nccl")


class Mesh:
    """This rank's view of a named grid of ranks (see the module doc).

    ``Mesh((1, 1), ("party", "data"))`` is a one-process mesh that needs no
    process group: every axis has size 1 and nothing crosses a process.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, backend: Optional[str] = None,
                 device: Device = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axis_names)}")
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, map(int, shape)))
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if self.size > 1 and backend is None:
            raise ValueError(f"a mesh of {self.size} ranks needs a backend "
                             f"({' or '.join(BACKENDS)})")
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.backend = backend
        self.device = resolve_device(device)
        self.coords = self._coords(rank)
        self.groups: Dict[str, object] = {}
        for axis, n in self.shape.items():
            if n == 1:
                continue
            # every rank builds every subgroup, in the same order
            for line in self._lines(axis):
                group = dist.new_group(list(line), backend=backend)
                if rank in line:
                    self.groups[axis] = group

    def _coords(self, rank: int) -> Dict[str, int]:
        coords = {}
        for axis in reversed(self.axis_names):
            rank, coords[axis] = divmod(rank, self.shape[axis])
        return {a: coords[a] for a in self.axis_names}

    def rank_at(self, **coords: int) -> int:
        """The rank at this rank's coordinates with ``coords`` replaced."""
        at = dict(self.coords, **coords)
        r = 0
        for axis in self.axis_names:
            r = r * self.shape[axis] + at[axis]
        return r

    def _lines(self, axis: str):
        """Every line of ranks along ``axis``, in rank order."""
        lines = {}
        for r in range(self.size):
            c = self._coords(r)
            key = tuple(v for a, v in c.items() if a != axis)
            lines.setdefault(key, []).append(r)
        return list(lines.values())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")

    # -- shard_map's in_specs and out_specs, on tensors -----------------------
    def local_block(self, t: torch.Tensor, spec: Sequence[Optional[str]]):
        """This rank's block of a global tensor: dim d is split into
        ``shape[spec[d]]`` equal blocks along mesh axis ``spec[d]`` (None:
        kept whole), as ``shard_map`` splits an input by its
        ``PartitionSpec``."""
        idx = []
        for d, axis in enumerate(spec):
            if axis is None:
                idx.append(slice(None))
                continue
            n = self.shape[axis]
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of shape {tuple(t.shape)} does not split "
                                 f"into {n} blocks along mesh axis {axis!r}")
            blk = t.shape[d] // n
            idx.append(slice(self.coords[axis] * blk, (self.coords[axis] + 1) * blk))
        return t[tuple(idx)]

    def gather(self, block: torch.Tensor, spec: Sequence[Optional[str]],
               dst: int = 0) -> Optional[torch.Tensor]:
        """The global tensor on rank ``dst`` from every rank's ``block``
        (the inverse of ``local_block`` under ``spec``; axes the spec does
        not name hold replicas, of which coordinate 0's is taken), None on
        every other rank.  A collective: every rank calls it."""
        if self.size == 1:
            return block
        wire = block.contiguous()
        if self.backend == "gloo":
            wire = wire.cpu()
        parts = ([torch.empty_like(wire) for _ in range(self.size)]
                 if self.rank == dst else None)
        dist.gather(wire, parts, dst=dst)
        if self.rank != dst:
            return None

        def assemble(at: Dict[str, int], dims) -> torch.Tensor:
            if not dims:
                return parts[self.rank_at(**at)]
            d, axis = dims[0]
            return torch.cat([assemble(dict(at, **{axis: i}), dims[1:])
                              for i in range(self.shape[axis])], dim=d)

        dims = [(d, a) for d, a in enumerate(spec) if a is not None]
        return assemble({a: 0 for a in self.axis_names}, dims).to(block.device)


def mpc_mesh_shape(n_devices: Optional[int] = None) -> Tuple[int, int]:
    """(party, data) axis sizes for an MPC mesh of ``n_devices`` ranks
    (default: ``WORLD_SIZE``): the party axis is always 2, the data axis
    takes half, rounded down (512 gives the paper's (2, 256), 8 gives
    (2, 4), 7 gives (2, 3))."""
    if n_devices is None:
        n_devices = int(os.environ.get("WORLD_SIZE", "1"))
    if n_devices < 2:
        raise ValueError(
            f"MPC serving needs >= 2 devices (one per party), got {n_devices}; "
            "use make_mpc_smoke_mesh() for one-process runs")
    return (2, n_devices // 2)


def _device_id(device: torch.device) -> str:
    """Host and device identity, to tell two ranks on one card apart."""
    ident = str(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        ident = str(getattr(props, "uuid", device.index))
    return f"{socket.gethostname()}/{ident}"


def _check_nccl_devices(device: torch.device, world: int) -> None:
    """Raise when two ranks of an NCCL group name one device (NCCL's
    ``ncclCommInitRank`` refuses them: "Duplicate GPU detected")."""
    probe = dist.new_group(list(range(world)), backend="gloo")
    ids = [None] * world
    dist.all_gather_object(ids, _device_id(device), group=probe)
    seen: Dict[str, int] = {}
    for r, ident in enumerate(ids):
        if ident in seen:
            raise ValueError(
                f"backend 'nccl': ranks {seen[ident]} and {r} are on one device "
                f"({ident}); NCCL refuses two ranks on one device, so give each "
                "rank its own card, or pass backend='gloo' to stage the "
                "exchanges through host memory")
        seen[ident] = r


def make_mpc_mesh(n_data: Optional[int] = None, *, backend: str,
                  device: Device = None, init_method: Optional[str] = None,
                  rank: Optional[int] = None) -> Mesh:
    """The (party, data) = (2, ``n_data``) MPC mesh over a process group of
    ``2 * n_data`` ranks, this process one of them; ``n_data`` defaults to
    half of ``WORLD_SIZE`` (``mpc_mesh_shape``).  Initialises the default
    process group when none is (``init_method``, default ``env://``, and
    ``rank``, default ``RANK``), else joins the existing one.  ``device``
    (default ``cuda``) is where this rank's shares and kernels live."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if n_data is None:
        _, n_data = mpc_mesh_shape()
    world = 2 * n_data
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ["RANK"])
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()!r}, "
                         f"not {backend!r}")
    if dist.get_world_size() != world:
        raise ValueError(f"a (2, {n_data}) mesh needs {world} ranks, the process "
                         f"group has {dist.get_world_size()}")
    if backend == "nccl":
        _check_nccl_devices(dev, world)
    return Mesh((2, n_data), ("party", "data"), rank=dist.get_rank(),
                backend=backend, device=dev)


def make_mpc_smoke_mesh(device: Device = None) -> Mesh:
    """The one-process MPC mesh with the serving axis names: both party
    rows stay in this process and every exchange is the local flip."""
    return Mesh((1, 1), ("party", "data"), device=device)


def mpc_serving_mesh(*, backend: str, device: Device = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None) -> Mesh:
    """The best MPC mesh this process group supports: ``make_mpc_mesh``
    when ``WORLD_SIZE`` (or the initialised group) holds two ranks or more,
    else the smoke mesh on ``device``."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world >= 2:
        return make_mpc_mesh(world // 2, backend=backend, device=device,
                             init_method=init_method, rank=rank)
    return make_mpc_smoke_mesh(device)


def make_smoke_mesh(device: Device = None) -> Mesh:
    """The one-process mesh with the production axis names."""
    return Mesh((1, 1), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# Production meshes: DeviceMeshes for the DTensor dry run
# ---------------------------------------------------------------------------

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False, *, device: Device = None):
    """The 16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)
    ``DeviceMesh`` over the current process group, which must hold that
    many ranks (``fake_process_group`` gives one process all of them).
    ``device`` (default ``cuda``) is the device type of its tensors."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return make_device_mesh(shape, names, device=device)


def make_device_mesh(shape: Sequence[int], names: Sequence[str], *,
                     device: Device = None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the current
    process group, ranks laid out row-major as ``jax.make_mesh`` lays out
    devices."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    n = 1
    for k in shape:
        n *= int(k)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise ValueError(f"a {tuple(shape)} mesh needs a process group of {n} "
                         f"ranks, the current one has {have}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def fake_process_group(world_size: int, rank: int = 0) -> None:
    """Start torch's ``fake`` process group of ``world_size`` ranks in this
    process, as ``rank``: every collective returns at once and moves
    nothing, so one process can trace a step of a 512-rank mesh.  Any
    process group already started is destroyed first."""
    # the fake backend's store lives in a private testing module: this is
    # the one place the port imports it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _rank_main(script: str, fn: str, rank: int, world: int, init_method: str,
               args: tuple, results) -> None:
    """One spawned rank: load ``script``, run ``fn``, report, leave the
    process group."""
    try:
        spec = importlib.util.spec_from_file_location(f"_mesh_rank_{rank}", script)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out = getattr(module, fn)(rank, world, init_method, *args)
        if dist.is_initialized():
            dist.barrier()
        # bytes, not tensors: a tensor put on a queue is shared through a
        # file descriptor that dies with this process
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:        # noqa: BLE001 (reported to the parent, which raises)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(script: str, fn: str, world: int, *, args: tuple = (),
                timeout_s: float) -> List:
    """Run ``world`` ranks on this host, each a process started with the
    ``spawn`` method that loads the Python file ``script`` and calls
    ``fn(rank, world, init_method, *args)`` (``init_method``: a ``file://``
    store in a fresh temporary directory, for ``make_mpc_mesh``); returns
    the ranks' return values (``torch.save``-able, tensors on the CPU) in
    rank order.
    A rank that raises or dies, or a run past ``timeout_s``, raises here,
    and no rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(script, fn, r, world, init, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{fn}: ranks {sorted(set(range(world)) - set(got))}"
                                       f" still running after {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"{fn}: ranks {dead} exited without a "
                                           "result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"{fn}: rank {rank} failed:\n{out}")
                got[rank] = torch.load(io.BytesIO(out), weights_only=False)
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [got[r] for r in range(world)]
