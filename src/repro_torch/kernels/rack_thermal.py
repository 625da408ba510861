"""Rack heat scatter + first-order RC outlet-temperature update: the
thermal twin's per-tick pass.

- ``rack_thermal``: the wrapper ``core.thermal.rack_thermal_update``
  calls. For CPU tensors it runs the plain version; for CUDA tensors it
  launches the hand-written kernel ``csrc/rack_thermal.cu`` (which
  replaces the TPU kernel ``rack_thermal_pallas``) or raises. There is no
  fallback.
- ``rack_thermal_torch``: the plain PyTorch version of the same function,
  deterministic on every device.

Shapes carry a leading replica dimension E: node heat (E, N), outlet
temperatures (E, R), supply temperature (E,); the rack ids ``node_rack``
(N,) int32 and ``r_th`` (R,) are shared. ``alpha`` is a Python float,
rounded to f32 once, as the JAX package's ``jnp.float32(alpha)`` rounds
it. Returns (new_outlet_c, rack_heat_w), each (E, R).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.node_power import scatter_loads

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
    outs = tuple(torch.empty((E, R), dtype=torch.float32,
                             device=heat_w.device) for _ in range(2))
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
