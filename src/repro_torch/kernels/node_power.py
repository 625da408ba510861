"""Node power chain kernels: the job table (or per-node load fractions)
-> per-node IT power and input power.

- ``power_tick``: the entry the replay tick calls. From the job table it
  computes the jobs' utilisation, the slot amounts, the placement scatter
  and the node chain, then the facility totals, COP, cooling, PUE and
  GFLOP/s, and with the thermal twin on the derate and each job's
  slowest-node clock, in one launch of ``csrc/power_scatter.cu``. Its
  statics are checked and packed once (``tick_statics``). ``power_tick_torch``
  is its plain version.
- ``power_scatter``: the TPU kernel's function, the placement scatter
  fused with the chain, on the same scatter design. For CPU tensors it runs
  the plain version; for CUDA tensors it launches the hand-written kernel
  ``csrc/power_scatter.cu`` (which replaces the TPU kernel
  ``power_scatter_pallas``) or raises. There is no fallback, for either
  entry.
- ``power_scatter_torch``: the plain PyTorch version of the same
  function, deterministic on every device.
- ``node_chain``: the per-node power chain from load fractions (IT power,
  rectifier-efficiency parabola, conversion loss), shared with
  ``core.power.power_from_fracs``, and the plain version of ``node_power``.
- ``node_power``: the chain alone as a kernel, ``csrc/node_power.cu``
  (which replaces the TPU kernel ``node_power_pallas``), with the same
  dispatch rule. No path of the simulator calls it, as none of the JAX
  package's does.

Every function takes a leading replica dimension E: ``place`` and the
slot amounts are (E, JK), fractions and ``node_up`` (E, N), the node
constants (N,), and the outputs (E, N). ``power_tick`` also takes one
replica with no leading dimension, as the main path calls it, and reads
its trace bank as (W, J, Q): replica e the slice of its workload id
(``SimState.workload``; a single (J, Q) bank is W = 1).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.throttle import CThrottle, Throttle, throttle_curve
from repro_torch.utils.device import full
from repro_torch.utils.errors import ConfigError

Out4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _scatter_index_add(place, amounts, n_nodes: int) -> torch.Tensor:
    """Sequential ``index_add_``: on the CPU it adds in ascending slot
    order, the kernel's order."""
    E = place.shape[0]
    valid = (place >= 0) & (place < n_nodes)
    offs = torch.arange(E, device=place.device)[:, None] * n_nodes
    ids = torch.where(valid, place.long(), 0) + offs
    out = torch.zeros(E * n_nodes, dtype=amounts.dtype, device=place.device)
    out.index_add_(0, ids.reshape(-1),
                   torch.where(valid, amounts, 0.0).reshape(-1))
    return out.reshape(E, n_nodes)


def _scatter_onehot(place, amounts, n_nodes: int) -> torch.Tensor:
    """One-hot select and a plain reduction: deterministic on the card,
    where a float ``index_add_`` uses atomics."""
    nodes = torch.arange(n_nodes, device=place.device, dtype=place.dtype)
    hit = place[:, :, None] == nodes
    return torch.where(hit, amounts[:, :, None], 0.0).sum(1)


def scatter_loads(place: torch.Tensor, amounts: torch.Tensor,
                  n_nodes: int) -> torch.Tensor:
    """(E, N) per-node sums of the (E, JK) slot ``amounts``; slots whose
    id is not a node (-1) drop out. Deterministic on every device."""
    if place.device.type == "cpu":
        return _scatter_index_add(place, amounts, n_nodes)
    return _scatter_onehot(place, amounts, n_nodes)


def node_chain(cpu_frac, gpu_frac, idle_w, cpu_dyn_w, gpu_dyn_w, node_up,
               node_max_w, *, rect_peak: float, rect_load: float,
               rect_curv: float, conv_eff: float):
    """Load fractions -> (node_it_w, node_input_w): IT power, the
    rectifier-efficiency parabola eta(load), conversion loss."""
    it = idle_w + cpu_frac * cpu_dyn_w + gpu_frac * gpu_dyn_w
    it = it * node_up
    load_frac = torch.clamp(it / torch.clamp(node_max_w, min=1.0), 0.0, 1.2)
    eta = torch.clamp(
        rect_peak - rect_curv * torch.square(load_frac - rect_load), 0.5, 1.0)
    return it, it / (eta * conv_eff)


def power_scatter_torch(place, cpu_abs, gpu_abs, cap_cpu, cap_gpu, idle_w,
                        cpu_dyn_w, gpu_dyn_w, node_up, node_max_w, *,
                        rect_peak: float, rect_load: float, rect_curv: float,
                        conv_eff: float) -> Out4:
    """Plain PyTorch version of the fused kernel. Returns (node_it_w,
    node_input_w, cpu_frac, gpu_frac), each (E, N)."""
    n = idle_w.shape[0]
    cpu_node = scatter_loads(place, cpu_abs, n)
    gpu_node = scatter_loads(place, gpu_abs, n)
    cpu_frac = torch.clamp(cpu_node / torch.clamp(cap_cpu, min=1e-6), 0.0, 1.0)
    gpu_frac = torch.clamp(gpu_node / torch.clamp(cap_gpu, min=1e-6), 0.0, 1.0)
    it, inp = node_chain(
        cpu_frac, gpu_frac, idle_w, cpu_dyn_w, gpu_dyn_w, node_up, node_max_w,
        rect_peak=rect_peak, rect_load=rect_load, rect_curv=rect_curv,
        conv_eff=conv_eff)
    return it, inp, cpu_frac, gpu_frac


def _check(place, cpu_abs, gpu_abs, node_vecs, node_up) -> None:
    """Raise on anything the kernel does not take."""
    dev = place.device
    tensors = (place, cpu_abs, gpu_abs, *node_vecs, node_up)
    if any(t.device != dev for t in tensors):
        raise ValueError("power_scatter: all tensors must be on one device")
    if place.dtype != torch.int32:
        raise TypeError(f"power_scatter: place must be int32, got {place.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("power_scatter: amounts and node vectors must be f32")
    if place.dim() != 2 or cpu_abs.shape != place.shape \
            or gpu_abs.shape != place.shape:
        raise ValueError(
            "power_scatter: place, cpu_abs and gpu_abs must share one "
            f"(E, JK) shape, got {tuple(place.shape)}, "
            f"{tuple(cpu_abs.shape)}, {tuple(gpu_abs.shape)}")
    n = node_vecs[0].shape[0]
    if any(v.shape != (n,) for v in node_vecs):
        raise ValueError("power_scatter: node vectors must all be (N,)")
    if node_up.shape != (place.shape[0], n):
        raise ValueError(
            f"power_scatter: node_up must be (E, N) = ({place.shape[0]}, {n}),"
            f" got {tuple(node_up.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("power_scatter: tensors must be contiguous")
    if place.shape[0] > 65535 or place.shape[1] >= 2**31 or n >= 2**31:
        raise ValueError("power_scatter: E <= 65535 and JK, N < 2**31")


def power_scatter(place, cpu_abs, gpu_abs, cap_cpu, cap_gpu, idle_w,
                  cpu_dyn_w, gpu_dyn_w, node_up, node_max_w, *,
                  rect_peak: float, rect_load: float, rect_curv: float,
                  conv_eff: float) -> Out4:
    """Fused placement-scatter + power chain. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    node_vecs = (cap_cpu, cap_gpu, idle_w, cpu_dyn_w, gpu_dyn_w, node_max_w)
    _check(place, cpu_abs, gpu_abs, node_vecs, node_up)
    kw = dict(rect_peak=rect_peak, rect_load=rect_load, rect_curv=rect_curv,
              conv_eff=conv_eff)
    if place.device.type == "cpu":
        return power_scatter_torch(place, cpu_abs, gpu_abs, *node_vecs[:5],
                                   node_up, node_max_w, **kw)
    if place.device.type != "cuda":
        raise ValueError(f"power_scatter: no kernel for {place.device}")
    launch = build.function("power_scatter", pointers=14, ints=3, floats=4)
    E, jk = place.shape
    n = idle_w.shape[0]
    outs = torch.empty((4, E, n), dtype=torch.float32,
                       device=place.device).unbind(0)
    with torch.cuda.device(place.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            place.data_ptr(), cpu_abs.data_ptr(), gpu_abs.data_ptr(),
            cap_cpu.data_ptr(), cap_gpu.data_ptr(), idle_w.data_ptr(),
            cpu_dyn_w.data_ptr(), gpu_dyn_w.data_ptr(), node_up.data_ptr(),
            node_max_w.data_ptr(), *(o.data_ptr() for o in outs),
            E, jk, n, rect_peak, rect_load, rect_curv, conv_eff, stream)
    if err != 0:
        raise RuntimeError(f"power_scatter kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["power_scatter"] += 1
    return outs


def _check_node_power(fracs, node_vecs, node_up) -> None:
    """Raise on anything the ``node_power`` kernel does not take."""
    tensors = (*fracs, node_up, *node_vecs)
    dev = fracs[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("node_power: all tensors must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("node_power: every tensor must be f32")
    shape = fracs[0].shape
    if len(shape) != 2 or fracs[1].shape != shape or node_up.shape != shape:
        raise ValueError(
            "node_power: cpu_frac, gpu_frac and node_up must share one "
            f"(E, N) shape, got {tuple(fracs[0].shape)}, "
            f"{tuple(fracs[1].shape)}, {tuple(node_up.shape)}")
    if any(v.shape != (shape[1],) for v in node_vecs):
        raise ValueError(f"node_power: node vectors must all be (N,) = "
                         f"({shape[1]},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("node_power: tensors must be contiguous")
    if shape[0] >= 2**31 or shape[1] >= 2**31:
        raise ValueError("node_power: E, N < 2**31")


def node_power(cpu_frac, gpu_frac, idle_w, cpu_dyn_w, gpu_dyn_w, node_up,
               node_max_w, *, rect_peak: float, rect_load: float,
               rect_curv: float, conv_eff: float):
    """(E, N) load fractions -> (node_it_w, node_input_w), each (E, N).
    CPU tensors take the plain version ``node_chain``; CUDA tensors launch
    the kernel on the current stream."""
    node_vecs = (idle_w, cpu_dyn_w, gpu_dyn_w, node_max_w)
    _check_node_power((cpu_frac, gpu_frac), node_vecs, node_up)
    kw = dict(rect_peak=rect_peak, rect_load=rect_load, rect_curv=rect_curv,
              conv_eff=conv_eff)
    if cpu_frac.device.type == "cpu":
        return node_chain(cpu_frac, gpu_frac, idle_w, cpu_dyn_w, gpu_dyn_w,
                          node_up, node_max_w, **kw)
    if cpu_frac.device.type != "cuda":
        raise ValueError(f"node_power: no kernel for {cpu_frac.device}")
    launch = build.function("node_power", pointers=9, ints=2, floats=4)
    E, n = cpu_frac.shape
    outs = tuple(torch.empty((E, n), dtype=torch.float32,
                             device=cpu_frac.device) for _ in range(2))
    with torch.cuda.device(cpu_frac.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            cpu_frac.data_ptr(), gpu_frac.data_ptr(), idle_w.data_ptr(),
            cpu_dyn_w.data_ptr(), gpu_dyn_w.data_ptr(), node_up.data_ptr(),
            node_max_w.data_ptr(), *(o.data_ptr() for o in outs), E, n,
            rect_peak, rect_load, rect_curv, conv_eff, stream)
    if err != 0:
        raise RuntimeError(f"node_power kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["node_power"] += 1
    return outs


# --------------------------------------------------------------- the tick
RUNNING = 2              # core/state.py: a running job
N_SCALARS = 8            # it, input, cooling, facility, pue, gflops, cop, idle
Tick = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


class TickConsts(NamedTuple):
    """The config numbers of the tick, as Python floats; each meets the
    f32 arithmetic as a rounded f32, in the kernel and the plain version
    alike (``core.power.tick_consts`` makes them from a ``SimConfig``)."""

    trace_quanta: float
    rect_peak: float
    rect_load: float
    rect_curv: float
    conv_eff: float
    cop_base: float
    cop_wetbulb_coef: float
    wetbulb_ref_c: float
    cop_min: float
    thermal: bool
    throttle: Throttle
    nameplate_w: float        # max(nameplate IT power, 1)
    cop_load_coef: float
    cop_load_ref: float


class _CTickStatics(ctypes.Structure):
    """``TickStatics`` of csrc/power_scatter.cu, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "cpu_trace", "gpu_trace", "cap_cpu", "cap_gpu", "idle_w",
        "cpu_dyn_w", "gpu_dyn_w", "node_max_w", "peak_gflops", "node_rack")]
        + [(f, ctypes.c_int) for f in (
            "n_jobs", "n_slots", "n_quanta", "n_nodes", "n_racks", "n_res",
            "thermal", "n_work")]
        + [(f, ctypes.c_float) for f in (
            "quanta", "rect_peak", "rect_load", "rect_curv", "conv_eff",
            "cop_base", "cop_wetbulb_coef", "wetbulb_ref", "cop_min")]
        + [("throttle", CThrottle)]
        + [(f, ctypes.c_float) for f in (
            "nameplate", "cop_load_coef", "cop_load_ref")])


class TickStatics(NamedTuple):
    """What ``power_tick`` takes that is fixed for a simulation: the trace
    bank (W, J, Q), the node vectors (N,), the node racks, the shapes and
    the constants, checked once by ``tick_statics``; on the card also the
    packed C struct and the resolved launcher."""

    cpu_trace: torch.Tensor
    gpu_trace: torch.Tensor
    cap_cpu: torch.Tensor
    cap_gpu: torch.Tensor
    idle_w: torch.Tensor
    cpu_dyn_w: torch.Tensor
    gpu_dyn_w: torch.Tensor
    node_max_w: torch.Tensor
    peak_gflops: torch.Tensor
    node_rack: torch.Tensor       # (N,) int32
    n_slots: int                  # K, slots per job
    n_racks: int
    n_res: int                    # rows of the job table's ``req``
    consts: TickConsts
    c_struct: Optional[_CTickStatics] = None
    launch: Optional[object] = None


def tick_statics(cpu_trace, gpu_trace, cap_cpu, cap_gpu, idle_w, cpu_dyn_w,
                 gpu_dyn_w, node_max_w, peak_gflops, node_rack, *,
                 n_slots: int, n_racks: int, n_res: int,
                 consts: TickConsts) -> TickStatics:
    """Check the tick's fixed inputs once and, on the card, pack them for
    the kernel (and build it on first use). The trace bank is (J, Q) or
    banked (W, J, Q). Raises on anything the kernel does not take."""
    node_vecs = (cap_cpu, cap_gpu, idle_w, cpu_dyn_w, gpu_dyn_w, node_max_w,
                 peak_gflops)
    tensors = (cpu_trace, gpu_trace, *node_vecs, node_rack)
    dev = cpu_trace.device
    if any(t.device != dev for t in tensors):
        raise ValueError("power_tick: all statics must be on one device")
    if node_rack.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in tensors[:-1]):
        raise TypeError("power_tick: node_rack must be int32, the trace "
                        "bank and node vectors f32")
    n = idle_w.shape[0] if idle_w.dim() == 1 else -1
    if cpu_trace.dim() not in (2, 3) or gpu_trace.shape != cpu_trace.shape \
            or cpu_trace.shape[-1] < 1 or cpu_trace.shape[0] < 1 \
            or any(t.shape != (n,) for t in (*node_vecs, node_rack)):
        raise ValueError(
            "power_tick: the trace bank must be (J, Q) or (W, J, Q) twice "
            f"and every node vector (N,), got {tuple(cpu_trace.shape)}, "
            f"{tuple(gpu_trace.shape)} and {[tuple(t.shape) for t in node_vecs]}")
    if n_slots < 1 or n_racks < 1 or n_res < 2:
        raise ValueError("power_tick: need K >= 1 slots, R >= 1 racks and "
                         "two resource rows (cpu, gpu) at least")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("power_tick: statics must be contiguous")
    if cpu_trace.dim() == 2:
        cpu_trace, gpu_trace = cpu_trace[None], gpu_trace[None]
    W, J, Q = cpu_trace.shape
    if J * n_slots >= 2**31 or n >= 2**31 or J * n_res >= 2**31 \
            or J * Q >= 2**31 or W >= 2**31:
        raise ValueError("power_tick: J*K, J*Q, J*NRES, W and N < 2**31")
    ts = TickStatics(cpu_trace, gpu_trace, *node_vecs, node_rack, n_slots,
                     n_racks, n_res, consts)
    if dev.type == "cpu":
        return ts
    if dev.type != "cuda":
        raise ValueError(f"power_tick: no kernel for {dev}")
    launch = build.function("power_scatter", pointers=11, ints=2, floats=0,
                            entry="power_tick")
    size = build.load("power_scatter").power_tick_statics_size()
    if size != ctypes.sizeof(_CTickStatics):
        raise RuntimeError(f"power_tick: the C struct has {size} bytes, its "
                           f"ctypes mirror {ctypes.sizeof(_CTickStatics)}")
    c = consts
    packed = _CTickStatics(
        *(t.data_ptr() for t in tensors),
        J, n_slots, Q, n, n_racks, n_res, int(c.thermal), W,
        c.trace_quanta, c.rect_peak, c.rect_load, c.rect_curv, c.conv_eff,
        c.cop_base, c.cop_wetbulb_coef, c.wetbulb_ref_c, c.cop_min,
        CThrottle(*c.throttle), c.nameplate_w, c.cop_load_coef,
        c.cop_load_ref)
    # the launcher takes the struct's address before the tensor pointers
    launch.argtypes = [ctypes.POINTER(_CTickStatics)] + launch.argtypes[1:]
    return ts._replace(c_struct=packed, launch=launch)


def _tick_shapes(ts: TickStatics, lead) -> tuple:
    J = ts.cpu_trace.shape[1]
    return (lead + (J,), lead, lead + (J,), lead + (J, ts.n_slots),
            lead + (ts.n_res, J), lead + ts.idle_w.shape,
            lead + (ts.n_racks,), lead, lead)


_TICK_NAMES = ("jstate", "t", "start_t", "placement", "req", "node_up",
               "rack_outlet", "wetbulb", "workload")
_TICK_DTYPES = (torch.int32, torch.float32, torch.float32, torch.int32,
                torch.float32, torch.float32, torch.float32, torch.float32,
                torch.int32)


def _check_tick(ts: TickStatics, tensors) -> None:
    """Raise on per-tick tensors the kernel does not take: one replica
    (``t`` 0-d) or E (``t`` (E,)), each in its shape, dtype and layout on
    the statics' device. Workload ids outside [0, W) are refused here when
    they lie on the CPU; the card reads no tensor on the host, so there the
    kernel reads nothing for such a replica and gives it NaN."""
    lead = tuple(tensors[1].shape)
    if len(lead) > 1 or (lead and not 0 < lead[0] <= 65535):
        raise ValueError("power_tick: t must be 0-d or (E,), 0 < E <= 65535")
    dev = ts.cpu_trace.device
    for name, x, shape, dtype in zip(_TICK_NAMES, tensors,
                                     _tick_shapes(ts, lead), _TICK_DTYPES):
        if x.device != dev:
            raise ValueError(f"power_tick: {name} is on {x.device}, the "
                             f"statics on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"power_tick: {name} must be {dtype}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"power_tick: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"power_tick: {name} must be contiguous")
    ids = tensors[-1]
    W = ts.cpu_trace.shape[0]
    if ids.device.type == "cpu" and bool(((ids < 0) | (ids >= W)).any()):
        raise ConfigError(
            f"workload ids must be in [0, {W}) for this bank; got "
            f"[{int(ids.min())}, {int(ids.max())}] — an out-of-range id "
            "would read outside the bank")


def _ids(workload, t):
    """Each replica's bank slice: ``workload``, or slice 0."""
    if workload is None:
        return torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    return workload


def power_tick_torch(ts: TickStatics, jstate, t, start_t, placement, req,
                     node_up, rack_outlet, wetbulb, workload=None) -> Tick:
    """Plain PyTorch version of the fused tick: ``core.power``'s
    ``job_utilization`` (from each replica's slice of the bank: its
    ``workload`` id, or slice 0 when None),
    ``placement_amounts``, the scatter and chain
    (``power_scatter_torch``) and ``finish_power`` with the static COP at
    ``wetbulb``; with ``consts.thermal``, the tail's derate from the
    previous tick's ``rack_outlet`` and ``job_thermal_rate``. Returns
    (node_it_w, node_input_w, scalars, job factor or None): the node
    values (..., N), the scalars (..., 8) in the order it_w, input_w,
    cooling_w, facility_w, pue, gflops, cop, idle_w (the up nodes' idle
    power), the job factor (..., J)."""
    lead = tuple(t.shape)
    workload = _ids(workload, t)
    if not lead:
        outs = power_tick_torch(ts, jstate[None], t[None], start_t[None],
                                placement[None], req[None], node_up[None],
                                rack_outlet[None], wetbulb[None],
                                workload[None])
        return tuple(None if o is None else o[0] for o in outs)
    c = ts.consts
    E, J = jstate.shape
    running = (jstate == RUNNING).to(torch.float32)
    age = torch.clamp(t[:, None] - start_t, min=0.0)
    quanta = full(c.trace_quanta, torch.float32, t.device)
    q = ts.cpu_trace.shape[-1]
    qi = torch.clamp((age / quanta).to(torch.int32), 0, q - 1).long()
    w = workload.long()[:, None]
    jj = torch.arange(J, device=t.device)
    cpu = ts.cpu_trace[w, jj, qi]
    gpu = ts.gpu_trace[w, jj, qi]
    cpu, gpu = cpu * running, gpu * running
    w = (placement >= 0).to(torch.float32)
    cpu_abs = (req[:, 0, :, None] * cpu[..., None]) * w
    gpu_abs = (req[:, 1, :, None] * gpu[..., None]) * w
    place = placement.reshape(E, -1)
    node_it, node_input, cf, gf = power_scatter_torch(
        place, cpu_abs.reshape(E, -1), gpu_abs.reshape(E, -1), ts.cap_cpu,
        ts.cap_gpu, ts.idle_w, ts.cpu_dyn_w, ts.gpu_dyn_w, node_up,
        ts.node_max_w, rect_peak=c.rect_peak, rect_load=c.rect_load,
        rect_curv=c.rect_curv, conv_eff=c.conv_eff)
    gflops = torch.sum(ts.peak_gflops * torch.maximum(cf, gf) * node_up, -1)
    node_idle = ts.idle_w * node_up
    cop = c.cop_base + c.cop_wetbulb_coef * (wetbulb - c.wetbulb_ref_c)
    job_th = None
    if c.thermal:
        th_r = throttle_curve(rack_outlet, c.throttle)
        node_th = th_r.index_select(1, ts.node_rack.long())
        node_dyn = torch.clamp(node_it - node_idle, min=0.0)
        it2 = node_idle + node_th * node_dyn
        node_input = node_input * (it2 / torch.clamp(node_it, min=1e-9))
        node_it = it2
        dyn_tot = torch.sum(node_dyn, -1)
        gscale = torch.where(
            dyn_tot > 0.0,
            torch.sum(node_th * node_dyn, -1) / torch.clamp(dyn_tot, min=1e-9),
            1.0)
        it_w = torch.sum(node_it, -1)
        nameplate = full(c.nameplate_w, torch.float32, t.device)
        cop = cop + c.cop_load_coef * (it_w / nameplate - c.cop_load_ref)
        gflops = gflops * gscale
        valid = place >= 0
        slot_th = torch.gather(node_th, 1, torch.where(valid, place, 0).long())
        job_th = torch.amin(torch.where(valid, slot_th, 1.0).reshape(
            E, J, ts.n_slots), dim=2)
    it_w = torch.sum(node_it, -1)
    input_w = torch.sum(node_input, -1)
    cop = torch.clamp(cop, min=c.cop_min)
    cooling_w = input_w / cop
    facility_w = input_w + cooling_w
    pue = torch.where(it_w > 1.0,
                      facility_w / torch.clamp(it_w, min=1.0), 1.0)
    scalars = torch.stack([it_w, input_w, cooling_w, facility_w, pue, gflops,
                           cop, torch.sum(node_idle, -1)], -1)
    return node_it, node_input, scalars, job_th


def power_tick(ts: TickStatics, jstate, t, start_t, placement, req, node_up,
               rack_outlet, wetbulb, workload=None) -> Tick:
    """One tick's power chain from the job table (see ``power_tick_torch``
    for what it returns). CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream, one output allocation a
    call."""
    tensors = (jstate, t, start_t, placement, req, node_up, rack_outlet,
               wetbulb, _ids(workload, t))
    _check_tick(ts, tensors)
    if ts.launch is None:
        return power_tick_torch(ts, *tensors)
    lead = tuple(t.shape)
    E = lead[0] if lead else 1
    J = ts.cpu_trace.shape[1]
    n = ts.idle_w.shape[0]
    dev = t.device
    out = torch.empty(E * (2 * n + N_SCALARS + J), dtype=torch.float32,
                      device=dev)
    idx = dev.index
    err = ts.launch(ts.c_struct, *(x.data_ptr() for x in tensors),
                    out.data_ptr(), E, idx,
                    torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"power_tick kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["power_scatter"] += 1
    node_it, node_input, scalars, job_th = out.split(
        [E * n, E * n, E * N_SCALARS, E * J])
    return (node_it.view(lead + (n,)), node_input.view(lead + (n,)),
            scalars.view(lead + (N_SCALARS,)),
            job_th.view(lead + (J,)) if ts.consts.thermal else None)
