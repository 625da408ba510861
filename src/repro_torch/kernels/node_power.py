"""Node power chain kernels: the job table (or per-node load fractions)
-> per-node IT power and input power.

- ``power_scatter``: the wrapper the simulator calls, fusing the
  placement scatter with the chain. For CPU tensors it runs the plain
  version; for CUDA tensors it launches the hand-written kernel
  ``csrc/power_scatter.cu`` (which replaces the TPU kernel
  ``power_scatter_pallas``) or raises. There is no fallback.
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
constants (N,), and the outputs (E, N). The main path calls with E = 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build

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
    outs = tuple(torch.empty((E, n), dtype=torch.float32, device=place.device)
                 for _ in range(4))
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
