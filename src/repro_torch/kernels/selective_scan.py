"""The selective scan of the Mamba mixer: the state-space recurrence over a
prompt, and its one-token decode step.

- ``selective_scan``: the wrapper ``models.mamba.mamba_apply`` calls. For
  CPU tensors it runs the plain version; for CUDA tensors it launches the
  hand-written kernel ``csrc/selective_scan.cu`` (which replaces the TPU
  kernel ``selective_scan_pallas``) or raises. There is no fallback.
- ``selective_scan_torch``: the plain PyTorch version of the same
  function, a loop over time in f32 in the kernel's order.
- ``selective_scan_step``: one decode step, plain PyTorch, as it is jnp in
  the JAX package (``kernels/ref.py::selective_scan_step_ref``).

Layout is the JAX package's, all f32: x, dt (Ba, S, di), A (di, ds)
(negative), B, C (Ba, S, ds). From ``s = 0``, per step t:
``s_t = exp(dt_t * A) * s_{t-1} + (dt_t * x_t) * B_t`` and ``y_t =
sum_ds s_t * C_t``. Returns y (Ba, S, di) and the final state
(Ba, di, ds). Any S: the scan is sequential, so nothing is chunked or
padded (the JAX package's oracle pads to its chunk with dt = 0, which
leaves the state as it was).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build

D_STATES = (4, 8, 16, 32)    # the kernel's instantiations
MAX_BATCH = 65535            # the grid's y dimension


def _update(state, x, dt, A, B):
    """The state after one step: x, dt (Ba, di), B (Ba, ds)."""
    decay = torch.exp(dt[..., None] * A)
    return decay * state + (dt * x)[..., None] * B[:, None, :]


def selective_scan_step(state, x, dt, A, B, C
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step from ``state`` (Ba, di, ds): x, dt (Ba, di), B, C
    (Ba, ds). Returns (y (Ba, di), new state); the sum over ds is an
    einsum, as in ``selective_scan_step_ref``."""
    state = _update(state, x, dt, A, B)
    return torch.einsum("bds,bs->bd", state, C), state


def selective_scan_torch(x, dt, A, B, C
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one state update per step t = 0..S-1, and
    y_t's terms added from n = 0 up, as the kernel adds them."""
    ba, s, di = x.shape
    state = torch.zeros(ba, di, A.shape[-1], dtype=torch.float32,
                        device=x.device)
    y = torch.empty(ba, s, di, dtype=torch.float32, device=x.device)
    for t in range(s):
        state = _update(state, x[:, t], dt[:, t], A, B[:, t])
        prod = state * C[:, t, None, :]
        acc = prod[..., 0]
        for n in range(1, prod.shape[-1]):
            acc = acc + prod[..., n]
        y[:, t] = acc
    return y, state


def _check(x, dt, A, B, C) -> None:
    """Raise on anything the kernel does not take."""
    ts = (x, dt, A, B, C)
    if len({t.device for t in ts}) != 1:
        raise ValueError("selective_scan: x, dt, A, B and C must be on one "
                         "device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("selective_scan: x, dt, A, B and C must be f32, got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(
            "selective_scan: need x, dt (Ba, S, di), A (di, ds), B, C "
            f"(Ba, S, ds), got {[tuple(t.shape) for t in ts]}")
    ba, s, di = x.shape
    ds = A.shape[1]
    if (dt.shape != x.shape or A.shape[0] != di
            or B.shape != (ba, s, ds) or C.shape != (ba, s, ds)):
        raise ValueError(
            "selective_scan: need x, dt (Ba, S, di), A (di, ds), B, C "
            f"(Ba, S, ds), got {[tuple(t.shape) for t in ts]}")
    if min(ba, s, di) == 0:
        raise ValueError(f"selective_scan: empty input {tuple(x.shape)}")
    if ds not in D_STATES:
        raise ValueError(f"selective_scan: d_state {ds} not in {D_STATES}")
    if ba > MAX_BATCH:
        raise ValueError(f"selective_scan: batch {ba} above {MAX_BATCH}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("selective_scan: x, dt, A, B and C must be "
                         "contiguous")
    if max(x.numel(), ba * di * ds) >= 2**31:
        raise ValueError("selective_scan: tensors must hold < 2**31 values")


def selective_scan(x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the scan. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        return selective_scan_torch(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for {x.device}")
    launch = build.function("selective_scan", pointers=7, ints=4, floats=0)
    ba, s, di = x.shape
    ds = A.shape[1]
    y = torch.empty_like(x)
    final = torch.empty(ba, di, ds, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), final.data_ptr(), ba, s, di,
                     ds, stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["selective_scan"] += 1
    return y, final
