"""Meshes on ``torch.distributed``: the port's counterpart of the JAX
package's ``launch/mesh.py`` (the fleet mesh, and the LM meshes below).

A ``FleetMesh`` is one rank's view of a 1-D world of W processes: the
axis name (``"replica"``, ``sharding.specs.FLEET_AXIS``), this rank, W,
the process group and this rank's device. ``core.fleet.run_fleet(mesh=)``
and ``rl.distributed.distributed_ppo_train`` split their replica or
environment axis across it in contiguous blocks; every rank runs the same
program on its block and the collectives here join the blocks.

- ``make_fleet_mesh(axis)`` reads the mesh off an initialised process
  group and refuses loudly where there is none, or where a CUDA rank's
  device is missing.
- ``spawn_world(fn, world, backend=, devices=, args=)`` runs
  ``fn(mesh, *args)`` in W fresh processes (``torch.multiprocessing``,
  start method ``spawn``) that meet through a ``file://`` store under
  ``build/mesh/`` of the checkout: no network and no ``MASTER_ADDR``.
  Each rank's return value comes back to the caller, in rank order.

The LM meshes are ``torch.distributed.device_mesh.DeviceMesh``es over
the whole initialised world, their axes named as the JAX package's:
``make_mesh_for(model_axis=M)`` a (data, model) mesh of W / M x M ranks,
``make_production_mesh()`` the (16, 16) pod or, ``multi_pod``, (2, 16,
16) named ("pod", "data", "model"). DTensors on them carry the LM's
params, optimizer state and batches (``sharding.specs``). Under gloo on
card tensors DTensor's all-gathers go through the host, the rest run on
gloo's own kernels: ``stage_collectives_through_host``.

Ranks run on the card unless the caller names the CPU: by default rank r
of an ``nccl`` world takes ``cuda:r`` and every rank of a ``gloo`` world
``cuda:0``; a CPU world passes ``devices=["cpu"] * W``. The backend is the
caller's choice, with no default, and is never switched on failure:
``nccl`` takes one rank per card; ``gloo`` takes CPU tensors, or CUDA
tensors of several ranks that share one card. gloo moves host memory:
each of its collectives on card tensors is a host round trip, run with
sync-debug "error" lifted for its own wait and counted in
``utils.device.HOST_READS``, as ``utils.device.host_read`` counts its
copy. Both backends refuse ``bool`` tensors: a collective reads and
writes them through a ``uint8`` view of the same bytes.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

MESH_ROOT = Path(__file__).resolve().parents[3] / "build" / "mesh"


@dataclass(frozen=True)
class FleetMesh:
    """One rank of a 1-D fleet mesh (see the module docstring)."""

    axis: str
    rank: int
    world: int
    group: Any                 # None: the whole initialised world
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        """{axis: W}, as a JAX mesh's ``shape``."""
        return {self.axis: self.world}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    def _run(self, fn, *tensors):
        """``fn()``; where gloo copies card tensors through the host, with
        sync-debug lifted for that wait and the wait counted as a host
        read."""
        if self.backend != "gloo" or not any(t.is_cuda for t in tensors):
            return fn()
        from repro_torch.utils.device import HOST_READS

        HOST_READS["count"] += 1
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0, in rank order."""
        import torch.distributed as dist

        out_shape = (self.world * x.shape[0],) + tuple(x.shape[1:])
        if x.numel() == 0:
            return x.new_empty(out_shape)
        src = x.contiguous()
        if src.dtype == torch.bool:
            src = src.view(torch.uint8)
        out = src.new_empty(out_shape)
        if self.backend == "nccl":
            self._run(lambda: dist.all_gather_into_tensor(
                out, src, group=self.group), src)
        else:
            parts = list(out.chunk(self.world))
            self._run(lambda: dist.all_gather(parts, src, group=self.group),
                      src)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` reduced over the ranks by ``op`` ("sum" or
        "max")."""
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        out = x.clone()
        self._run(lambda: dist.all_reduce(out, ops[op], group=self.group),
                  out)
        return out

    def barrier(self) -> None:
        """Wait for every rank. A world of one has none to wait for; gloo
        waits on the host alone; nccl's barrier waits on the card, a
        counted host read with sync-debug lifted for it."""
        import torch.distributed as dist

        if self.world == 1:
            return
        if self.backend != "nccl":
            dist.barrier(group=self.group)
            return
        from repro_torch.utils.device import HOST_READS

        HOST_READS["count"] += 1
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            dist.barrier(group=self.group, device_ids=[self.device.index])
        finally:
            torch.cuda.set_sync_debug_mode(mode)


# the functional collectives (``torch.ops._c10d_functional``, what DTensor
# issues) that gloo does not run on card tensors: ``tools/probe_gloo.py``
# found the all-gather ending its rank (SIGSEGV) on torch 2.11 + CUDA 12.8,
# and the reduce-scatter, all-reduce and all-to-all running
STAGED_OPS = ("all_gather_into_tensor",)
# collectives run through the host by ``staged`` in this process, and the
# bytes of their inputs
STAGED = {"calls": 0, "bytes": 0}
_STAGED: dict = {}


def staged(op):
    """``op`` (a functional collective's overload, a tensor in and one
    out) run on a host copy of its input, for a tensor on the card of a
    gloo world: the input goes to the host, the collective runs there
    (gloo's CPU kernel) and is waited for, and its output comes back to
    the input's device. Counted as one host read
    (``utils.device.HOST_READS``), with sync-debug "error" lifted for its
    copies, and in STAGED with its input's bytes."""
    from repro_torch.utils.device import HOST_READS

    wait = torch.ops._c10d_functional.wait_tensor.default

    def impl(x, *args):
        HOST_READS["count"] += 1
        STAGED["calls"] += 1
        STAGED["bytes"] += x.numel() * x.element_size()
        if not x.is_cuda:
            return wait(op(x, *args))
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return wait(op(x.cpu(), *args)).to(x.device)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    return impl


def stage_collectives_through_host() -> None:
    """Register ``staged`` as the CUDA kernel of each functional collective
    of STAGED_OPS, once per process: gloo's own kernel for card tensors is
    not used for them (see STAGED_OPS). A gloo world of ranks that share
    one card runs its DTensor meshes so; ``_device_mesh`` installs them."""
    if _STAGED:
        return
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "overriding a kernel"
        for name in STAGED_OPS:
            lib.impl(name, staged(getattr(torch.ops._c10d_functional,
                                          name).default), "CUDA")
    _STAGED["lib"] = lib


def _world(what: str, n: int) -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialised process group: run under torchrun "
            "or launch.mesh.spawn_world, or call torch.distributed."
            "init_process_group(backend, init_method=..., world_size=W, "
            "rank=r) in each rank first")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"{what}: need {n} ranks, have {world}")
    if world > n:
        raise RuntimeError(f"{what}: a mesh covers the whole world: "
                           f"{n} ranks asked for, the world has {world}")
    return world


def _device_mesh(shape: tuple, names: tuple, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda" and str(dist.get_backend()) == "gloo":
        stage_collectives_through_host()
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_mesh_for(n_devices: int | None = None, *, model_axis: int = 1,
                  device=None):
    """A (data, model) ``DeviceMesh`` of n / model_axis x model_axis over
    the initialised world of n ranks (``n_devices``: the world's size by
    default; a mesh covers the whole world). ``device``: the ranks'
    device type, the card by default ("cpu" for a CPU world)."""
    import torch.distributed as dist

    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 0)
    _world("make_mesh_for", n)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"make_mesh_for: the model axis {model_axis} does "
                         f"not divide {n} ranks")
    return _device_mesh((n // model_axis, model_axis), ("data", "model"),
                        device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (data=16, model=16) over 256 ranks, or
    (pod=2, data=16, model=16) over 512; refused on a smaller world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    _world(f"the production mesh {shape}", math.prod(shape))
    return _device_mesh(shape, names, device)


def _cuda_missing(device: torch.device) -> str | None:
    """Why ``device`` (a CUDA device) cannot be used here, or None."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if (device.index or 0) < n:
        return None
    return (f"device {device} is missing (this host has {n} CUDA "
            "device(s)); nccl takes one rank per card, gloo lets ranks "
            "share cuda:0, and a CPU rank is asked for with device 'cpu'")


def make_fleet_mesh(axis: str = "replica", *,
                    device: str | torch.device | None = None) -> FleetMesh:
    """This rank's ``FleetMesh`` over the initialised world. ``device``:
    this rank's device; by default the current CUDA device, under either
    backend (a CPU rank passes ``device="cpu"``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_fleet_mesh needs an initialised process group: start the "
            "ranks with launch.mesh.spawn_world(fn, world, backend=...) or "
            "call torch.distributed.init_process_group(backend, "
            "init_method=..., world_size=W, rank=r) in each of them first")
    backend = str(dist.get_backend())
    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if torch.cuda.is_available() else "cuda:0")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError(f"rank {rank}: the nccl backend needs a CUDA "
                           f"device, got {device}")
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        why = _cuda_missing(device)
        if why:
            raise RuntimeError(f"rank {rank} of {world}: {why}")
    return FleetMesh(axis, rank, world, None, device, backend)


def _rank_main(rank: int, fn, world: int, backend: str, devices, store: str,
               out_dir: str, args) -> None:
    import torch.distributed as dist

    device = torch.device(devices[rank])
    if device.type == "cuda":
        why = _cuda_missing(device)
        if why:
            raise RuntimeError(f"rank {rank}: {why}")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = fn(make_fleet_mesh(device=device), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable[..., Any], world: int, *, backend: str,
                devices: Sequence[str] | None = None, args: tuple = (),
                timeout: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` on each rank of a new world of ``world``
    processes and return their return values in rank order, their
    tensors on the CPU. ``fn`` must be importable by name (a module-level
    function). ``backend``: ``"nccl"`` or ``"gloo"``. ``devices``: one per
    rank; default ``cuda:r`` under ``nccl`` and ``cuda:0`` under ``gloo``
    (``["cpu"] * world`` for a CPU world). A missing card refuses before
    any process starts. A rank that raises, or a world that
    outlives ``timeout`` seconds, fails the call, and every rank is
    stopped first; the ranks are daemons, so none outlives the caller."""
    import torch.multiprocessing as mp

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if devices is None:
        devices = [f"cuda:{r}" if backend == "nccl" else "cuda:0"
                   for r in range(world)]
    devices = [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a world of {world}")
    for r, d in enumerate(map(torch.device, devices)):
        why = d.type == "cuda" and _cuda_missing(d)
        if why:
            raise RuntimeError(f"spawn_world: rank {r}'s {why}")
    MESH_ROOT.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix=f"world{world}-", dir=MESH_ROOT)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, devices,
                          os.path.join(work, "store"), work, args),
        nprocs=world, join=False, daemon=True, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ({fn.__name__}) "
                                   f"ran past {timeout} s")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(work, ignore_errors=True)


__all__ = ["FleetMesh", "make_fleet_mesh", "spawn_world", "MESH_ROOT",
           "make_mesh_for", "make_production_mesh",
           "stage_collectives_through_host", "STAGED_OPS", "STAGED"]
