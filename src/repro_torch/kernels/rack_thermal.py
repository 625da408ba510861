"""Rack heat scatter + first-order RC outlet-temperature update: the
thermal twin's per-tick pass.

- ``rack_tick``: the entry the thermal tick calls. From the post-cap node
  input power, the cap's scale, the wetbulb and the pre-update outlet
  temperatures it makes the rack heat, the supply temperature and the RC
  step, the tick's throttled seconds, the hottest new outlet and the new
  peak, in one launch of ``csrc/rack_thermal.cu`` over the racks' static
  CSR (``rack_statics``, checked and packed once). ``rack_tick_torch`` is
  its plain version.
- ``rack_thermal``: the TPU kernel's function. For CPU tensors it runs the
  plain version; for CUDA tensors it launches the hand-written kernel
  ``csrc/rack_thermal.cu`` (which replaces the TPU kernel
  ``rack_thermal_pallas``) or raises. There is no fallback, for either
  entry.
- ``rack_thermal_torch``: the plain PyTorch version of the same function,
  deterministic on every device.

Shapes carry a leading replica dimension E: node heat (E, N), outlet
temperatures (E, R), supply temperature (E,); the rack ids ``node_rack``
(N,) int32 and ``r_th`` (R,) are shared. ``alpha`` is a Python float,
rounded to f32 once, as the JAX package's ``jnp.float32(alpha)`` rounds
it. ``rack_thermal`` returns (new_outlet_c, rack_heat_w), each (E, R).
``rack_tick`` also takes one replica with no leading dimension.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.node_power import scatter_loads
from repro_torch.kernels.throttle import CThrottle, Throttle, throttle_curve

Out2 = Tuple[torch.Tensor, torch.Tensor]


def rack_thermal_torch(heat_w, node_rack, outlet_c, supply_c, r_th, *,
                       alpha: float) -> Out2:
    """Plain PyTorch version: per-rack heat sums (ascending node order on
    the CPU, a one-hot reduction on the card), then
    ``T + alpha * (supply + heat * r_th - T)``."""
    E = heat_w.shape[0]
    heat = scatter_loads(node_rack.expand(E, -1), heat_w, r_th.shape[0])
    t_ss = supply_c[:, None] + heat * r_th
    return outlet_c + alpha * (t_ss - outlet_c), heat


def _check(heat_w, node_rack, outlet_c, supply_c, r_th) -> None:
    """Raise on anything the kernel does not take."""
    tensors = (heat_w, node_rack, outlet_c, supply_c, r_th)
    dev = heat_w.device
    if any(t.device != dev for t in tensors):
        raise ValueError("rack_thermal: all tensors must be on one device")
    if node_rack.dtype != torch.int32:
        raise TypeError(
            f"rack_thermal: node_rack must be int32, got {node_rack.dtype}")
    if any(t.dtype != torch.float32 for t in (heat_w, outlet_c, supply_c,
                                                r_th)):
        raise TypeError("rack_thermal: heat, temperatures and r_th must be f32")
    if heat_w.dim() != 2 or node_rack.shape != heat_w.shape[1:]:
        raise ValueError(
            "rack_thermal: heat_w must be (E, N) and node_rack (N,), got "
            f"{tuple(heat_w.shape)}, {tuple(node_rack.shape)}")
    E, R = heat_w.shape[0], r_th.shape[0]
    if r_th.dim() != 1 or outlet_c.shape != (E, R) or supply_c.shape != (E,):
        raise ValueError(
            f"rack_thermal: need r_th (R,), outlet_c (E, R) = ({E}, {R}) and "
            f"supply_c (E,), got {tuple(r_th.shape)}, "
            f"{tuple(outlet_c.shape)}, {tuple(supply_c.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rack_thermal: tensors must be contiguous")
    if E >= 2**31 or heat_w.shape[1] >= 2**31 or R >= 2**31:
        raise ValueError("rack_thermal: E, N, R < 2**31")


def rack_thermal(heat_w, node_rack, outlet_c, supply_c, r_th, *,
                 alpha: float) -> Out2:
    """One RC step of every rack of every replica. CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream."""
    _check(heat_w, node_rack, outlet_c, supply_c, r_th)
    if heat_w.device.type == "cpu":
        return rack_thermal_torch(heat_w, node_rack, outlet_c, supply_c, r_th,
                                  alpha=alpha)
    if heat_w.device.type != "cuda":
        raise ValueError(f"rack_thermal: no kernel for {heat_w.device}")
    launch = build.function("rack_thermal", pointers=7, ints=3, floats=1)
    E, n = heat_w.shape
    R = r_th.shape[0]
    outs = torch.empty((2, E, R), dtype=torch.float32,
                       device=heat_w.device).unbind(0)
    with torch.cuda.device(heat_w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            heat_w.data_ptr(), node_rack.data_ptr(), outlet_c.data_ptr(),
            supply_c.data_ptr(), r_th.data_ptr(),
            *(o.data_ptr() for o in outs), E, n, R, alpha, stream)
    if err != 0:
        raise RuntimeError(
            f"rack_thermal kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["rack_thermal"] += 1
    return outs


# --------------------------------------------------------------- the tick
Tick = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
N_SCALARS = 3            # th_step, rack_max, peak


class RackConsts(NamedTuple):
    """The thermal config of the tick, as Python floats (each rounded to
    f32 where the arithmetic meets it)."""

    cooling_approach_c: float
    cooling_supply_min_c: float
    alpha: float
    dt: float
    throttle: Throttle


class _CRackStatics(ctypes.Structure):
    """``RackStatics`` of csrc/rack_thermal.cu, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("rack_ptr", "rack_nodes",
                                                 "r_th")]
                + [(f, ctypes.c_int) for f in ("n_nodes", "n_racks")]
                + [(f, ctypes.c_float) for f in RackConsts._fields[:-1]]
                + [("throttle", CThrottle)])


class RackStatics(NamedTuple):
    """What ``rack_tick`` takes that is fixed for a simulation: the racks
    as a CSR (``rack_ptr`` (R+1,), ``rack_nodes`` (N,), ascending inside
    each rack) and as ids (``node_rack`` (N,), for the plain version), the
    racks' ``r_th`` and the constants; on the card also the packed C struct
    and the resolved launcher."""

    rack_ptr: torch.Tensor
    rack_nodes: torch.Tensor
    node_rack: torch.Tensor
    r_th: torch.Tensor
    consts: RackConsts
    c_struct: Optional[_CRackStatics] = None
    launch: Optional[object] = None


def _check_csr(rack_ptr, rack_nodes, node_rack, n_racks: int) -> None:
    """Raise unless (``rack_ptr``, ``rack_nodes``) is the CSR of
    ``node_rack`` that ``core.state.rack_csr`` makes (each rack's nodes
    ascending): the kernel walks the CSR, the plain version reads
    ``node_rack``, and the two must describe the same racks. The check
    runs on the tensors' device and reads nothing on the host; on the card
    a mismatch is a device-side assert, raised at the next sync."""
    rack = node_rack.long()
    in_range = ((rack >= 0) & (rack < n_racks)).all()
    counts = torch.zeros(n_racks, dtype=torch.int64, device=rack.device)
    counts.index_add_(0, rack.clamp(0, n_racks - 1), torch.ones_like(rack))
    ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    nodes = torch.sort(rack, stable=True).indices
    torch._assert_async(
        in_range & (ptr == rack_ptr).all() & (nodes == rack_nodes).all(),
        "rack_tick: rack_ptr and rack_nodes are not the CSR of node_rack "
        "(core.state.rack_csr)")


def rack_statics(rack_ptr, rack_nodes, node_rack, r_th, *,
                 consts: RackConsts) -> RackStatics:
    """Check the racks once and, on the card, pack them for the kernel (and
    build it on first use). Raises on anything the kernel does not take,
    and unless the CSR is ``node_rack``'s (see ``_check_csr``); adds no
    host sync."""
    tensors = (rack_ptr, rack_nodes, node_rack, r_th)
    dev = r_th.device
    if any(t.device != dev for t in tensors):
        raise ValueError("rack_tick: all statics must be on one device")
    if any(t.dtype != torch.int32 for t in tensors[:3]) \
            or r_th.dtype != torch.float32:
        raise TypeError("rack_tick: rack_ptr, rack_nodes and node_rack must "
                        "be int32, r_th f32")
    R = r_th.shape[0] if r_th.dim() == 1 else 0
    n = node_rack.shape[0] if node_rack.dim() == 1 else -1
    if R < 1 or rack_ptr.shape != (R + 1,) or rack_nodes.shape != (n,):
        raise ValueError(
            "rack_tick: need r_th (R,) with R >= 1, rack_ptr (R + 1,) and "
            f"rack_nodes (N,) = node_rack's, got {tuple(r_th.shape)}, "
            f"{tuple(rack_ptr.shape)}, {tuple(rack_nodes.shape)}, "
            f"{tuple(node_rack.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rack_tick: statics must be contiguous")
    if n >= 2**31:
        raise ValueError("rack_tick: N < 2**31")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rack_tick: no kernel for {dev}")
    _check_csr(rack_ptr, rack_nodes, node_rack, R)
    rs = RackStatics(rack_ptr, rack_nodes, node_rack, r_th, consts)
    if dev.type == "cpu":
        return rs
    launch = build.function("rack_thermal", pointers=7, ints=2, floats=0,
                            entry="rack_tick")
    size = build.load("rack_thermal").rack_tick_statics_size()
    if size != ctypes.sizeof(_CRackStatics):
        raise RuntimeError(f"rack_tick: the C struct has {size} bytes, its "
                           f"ctypes mirror {ctypes.sizeof(_CRackStatics)}")
    packed = _CRackStatics(rack_ptr.data_ptr(), rack_nodes.data_ptr(),
                           r_th.data_ptr(), n, R, *consts[:-1],
                           CThrottle(*consts.throttle))
    launch.argtypes = [ctypes.POINTER(_CRackStatics)] + launch.argtypes[1:]
    return rs._replace(c_struct=packed, launch=launch)


_TICK_NAMES = ("node_input", "r", "wetbulb", "outlet", "peak")


def _check_tick(rs: RackStatics, tensors) -> None:
    """Raise on per-tick tensors the kernel does not take: one replica
    (``r`` 0-d) or E (``r`` (E,)), f32 and contiguous on the statics'
    device."""
    lead = tuple(tensors[1].shape)
    if len(lead) > 1 or (lead and not 0 < lead[0] < 2**31):
        raise ValueError("rack_tick: r must be 0-d or (E,), 0 < E < 2**31")
    shapes = (lead + tuple(rs.node_rack.shape), lead, lead,
              lead + tuple(rs.r_th.shape), lead)
    dev = rs.r_th.device
    for name, x, shape in zip(_TICK_NAMES, tensors, shapes):
        if x.device != dev:
            raise ValueError(f"rack_tick: {name} is on {x.device}, the "
                             f"statics on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"rack_tick: {name} must be f32, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"rack_tick: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"rack_tick: {name} must be contiguous")


def rack_tick_torch(rs: RackStatics, node_input, r, wetbulb, outlet,
                    peak) -> Tick:
    """Plain PyTorch version of the thermal tail: rack heat from
    ``node_input * r`` and the RC step toward the supply temperature at
    ``wetbulb`` (``rack_thermal_torch``), ``dt`` throttled seconds if any
    rack's throttle from the pre-update ``outlet`` is below 1 (else 0), the
    hottest new outlet and ``max(peak, hottest)``. Returns (new_outlet,
    th_step, rack_max, peak)."""
    if not r.shape:
        outs = rack_tick_torch(rs, node_input[None], r[None], wetbulb[None],
                               outlet[None], peak[None])
        return tuple(o[0] for o in outs)
    c = rs.consts
    supply = torch.clamp(wetbulb + c.cooling_approach_c,
                         min=c.cooling_supply_min_c)
    new_t, _ = rack_thermal_torch(node_input * r[:, None], rs.node_rack,
                                  outlet, supply, rs.r_th, alpha=c.alpha)
    th_r = throttle_curve(outlet, c.throttle)
    th_step = torch.where(torch.any(th_r < 1.0, 1), c.dt, 0.0)
    rack_max = torch.amax(new_t, 1)
    return new_t, th_step, rack_max, torch.maximum(peak, rack_max)


def rack_tick(rs: RackStatics, node_input, r, wetbulb, outlet, peak) -> Tick:
    """The thermal tail of one tick (see ``rack_tick_torch``). CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream, one output allocation a call."""
    tensors = (node_input, r, wetbulb, outlet, peak)
    _check_tick(rs, tensors)
    if rs.launch is None:
        return rack_tick_torch(rs, *tensors)
    lead = tuple(r.shape)
    E = lead[0] if lead else 1
    R = rs.r_th.shape[0]
    dev = r.device
    out = torch.empty(E * (R + N_SCALARS), dtype=torch.float32, device=dev)
    idx = dev.index
    err = rs.launch(rs.c_struct, *(x.data_ptr() for x in tensors),
                    out.data_ptr(), E, idx,
                    torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"rack_tick kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["rack_thermal"] += 1
    new_t, scalars = out.split([E * R, E * N_SCALARS])
    th_step, rack_max, peak = scalars.view((N_SCALARS,) + lead).unbind(0)
    return new_t.view(lead + (R,)), th_step, rack_max, peak
