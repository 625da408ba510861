"""The selective scan of the Mamba mixer: the state-space recurrence over a
prompt, the mixer's fused entry around it, and its one-token decode step.

- ``selective_scan``: the TPU kernel's signature. For CPU tensors it runs
  the plain version; for CUDA tensors it launches the hand-written kernel
  ``csrc/selective_scan.cu`` (which replaces the TPU kernel
  ``selective_scan_pallas``) or raises. There is no fallback. Nothing
  differentiates it: on the card it raises where autograd records its
  inputs.
- ``mamba_scan``: the entry ``models.mamba.mamba_apply`` calls. The same
  scan with the mixer's elementwise work around it (dt's bias and
  softplus, the f32 casts, the gated D skip), in the compute dtype; the
  same kernel source on the card, ``mamba_scan_torch`` on the CPU. On
  the card it is differentiable (``MambaScan``): the kernel forward, the
  backward the vjp of the plain version.
- ``selective_scan_torch``, ``mamba_scan_torch``: the plain PyTorch
  versions, a loop over time in f32.
- ``selective_scan_step``: one decode step, plain PyTorch, as it is jnp in
  the JAX package (``kernels/ref.py::selective_scan_step_ref``).

Layout is the JAX package's: x, dt (Ba, S, di), A (di, ds) (negative), B,
C (Ba, S, ds). From ``s = 0``, per step t: ``s_t = exp(dt_t * A) * s_{t-1}
+ (dt_t * x_t) * B_t`` and ``y_t = sum_ds s_t * C_t``. Returns y (Ba, S,
di) and the final state (Ba, di, ds). Any S: the scan is sequential, so
nothing is chunked or padded (the JAX package's oracle pads to its chunk
with dt = 0, which leaves the state as it was).

The kernel reads x, dt and z and writes y through TMA tensor maps: on
the card they need 16-byte aligned addresses and byte strides, and B and
C, which are tiny, are copied where a map cannot read them in place.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import build

D_STATES = (4, 8, 16, 32)    # the kernel's instantiations
MAX_BATCH = 65535            # the grid's y dimension
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


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
    y_t's terms added from n = 0 up."""
    ba, s, di = x.shape
    state = torch.zeros(ba, di, A.shape[-1], dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        state = _update(state, x[:, t], dt[:, t], A, B[:, t])
        prod = state * C[:, t, None, :]
        acc = prod[..., 0]
        for n in range(1, prod.shape[-1]):
            acc = acc + prod[..., n]
        ys.append(acc)
    return torch.stack(ys, dim=1), state


def mamba_scan_torch(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused entry: the mixer's lines around
    the scan, in their order, in xb's dtype (the scan in f32)."""
    dt_ = xb.dtype
    dtv = F.softplus(dt_proj + dt_b)
    y, final = selective_scan_torch(xb.float(), dtv.float(), A, Bc.float(),
                                    Cc.float())
    y = y.to(dt_) + xb * D_skip
    return y * F.silu(z), final


def _shapes_error(name: str, ts, want: str) -> ValueError:
    return ValueError(f"{name}: need {want}, got "
                      f"{[tuple(t.shape) for t in ts]}")


def _check_common(name, ts, ba, s, di, ds) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    if min(ba, s, di) == 0:
        raise ValueError(f"{name}: empty input {(ba, s, di)}")
    if ds not in D_STATES:
        raise ValueError(f"{name}: d_state {ds} not in {D_STATES}")
    if ba > MAX_BATCH:
        raise ValueError(f"{name}: batch {ba} above {MAX_BATCH}")


def _refuse_dtensor(name: str, ts) -> None:
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{name}: a DTensor reached the kernel; pass each "
                        "rank's local shards (models.layers.local_scan)")


def _check(x, dt, A, B, C) -> None:
    """Raise on anything the kernel does not take."""
    ts = (x, dt, A, B, C)
    _refuse_dtensor("selective_scan", ts)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("selective_scan: x, dt, A, B and C must be f32, got "
                        f"{[t.dtype for t in ts]}")
    want = "x, dt (Ba, S, di), A (di, ds), B, C (Ba, S, ds)"
    if x.dim() != 3 or A.dim() != 2:
        raise _shapes_error("selective_scan", ts, want)
    ba, s, di = x.shape
    ds = A.shape[1]
    if (dt.shape != x.shape or A.shape[0] != di
            or B.shape != (ba, s, ds) or C.shape != (ba, s, ds)):
        raise _shapes_error("selective_scan", ts, want)
    _check_common("selective_scan", ts, ba, s, di, ds)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("selective_scan: x, dt, A, B and C must be "
                         "contiguous")
    if max(x.numel(), ba * di * ds) >= 2**31:
        raise ValueError("selective_scan: tensors must hold < 2**31 values")


def _tma_readable(t) -> bool:
    """A TMA tensor map reads ``t``: a 16-byte aligned address and byte
    strides (the last dimension's stride is 1)."""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:-1])


def _check_tma(name: str, **tensors) -> None:
    for key, t in tensors.items():
        if not _tma_readable(t):
            raise ValueError(
                f"{name}: {key} needs a 16-byte aligned address and byte "
                f"strides for its tensor map, got address "
                f"{t.data_ptr():#x} and strides {t.stride()}")


def _tma_rows(t):
    """``t`` (Ba, S, ds) itself where a tensor map reads it, else a copy
    whose rows are padded to a multiple of 16 bytes (B and C are small)."""
    if _tma_readable(t):
        return t
    per_row = 16 // t.element_size()
    width = -(-t.shape[-1] // per_row) * per_row
    buf = t.new_empty(*t.shape[:-1], width)[..., :t.shape[-1]]
    return buf.copy_(t)


def _launch_scan(x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the current stream, for CUDA tensors that passed
    ``_check``."""
    kernels.refuse_autograd("selective_scan", x, dt, A, B, C)
    _check_tma("selective_scan", x=x, dt=dt)
    B, C = _tma_rows(B), _tma_rows(C)
    launch = build.function("selective_scan", pointers=7, ints=8, floats=0)
    ba, s, di = x.shape
    ds = A.shape[1]
    y = torch.empty_like(x)
    final = torch.empty(ba, di, ds, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), final.data_ptr(), ba, s, di,
                     ds, B.stride(1), B.stride(0), C.stride(1), C.stride(0),
                     stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["selective_scan"] += 1
    return y, final


def scan_cost(inputs, outputs) -> tuple:
    """(FLOPs, bytes) of one call of either entry: the plain version is
    elementwise, with no product ``FlopCounterMode`` counts, so 0 FLOPs;
    each input read once and each output written once."""
    return 0, kernels.nbytes(*inputs, *outputs)


def _meta_outputs(x, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """Outputs of the kernels' shapes and dtypes: y as x, the final state
    (Ba, di, ds) f32."""
    return (torch.empty_like(x),
            x.new_empty(x.shape[0], x.shape[2], A.shape[1],
                        dtype=torch.float32))


class MetaScan(torch.autograd.Function):
    """The fused entry's call on meta tensors: outputs of its shapes and
    dtypes, no computation, no launch, the cost ``scan_cost`` reported
    (``kernels.meta_cost``); its backward reports the plain vjp's reads
    (the inputs and the outputs' gradients) and writes (the inputs'
    gradients)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        out = _meta_outputs(inputs[0], inputs[3])
        kernels.meta_cost(*scan_cost(inputs, out))
        return out

    @staticmethod
    def backward(ctx, g_out, g_final):
        inputs = ctx.saved_tensors
        grads = tuple(torch.empty_like(t) for t in inputs)
        kernels.meta_cost(*scan_cost(inputs + (g_out, g_final), grads))
        return grads


def selective_scan(x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the scan. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream; meta tensors
    are traced (outputs of the kernel's shapes, ``scan_cost`` reported)."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        return selective_scan_torch(x, dt, A, B, C)
    if x.device.type == "meta":
        out = _meta_outputs(x, A)
        kernels.meta_cost(*scan_cost((x, dt, A, B, C), out))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for {x.device}")
    return _launch_scan(x, dt, A, B, C)


def _check_fused(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip) -> None:
    """Raise on anything the fused kernel does not take."""
    ts = (xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)
    _refuse_dtensor("mamba_scan", ts)
    if xb.dtype not in COMPUTE_DTYPES or A.dtype != torch.float32 or any(
            t.dtype != xb.dtype for t in (dt_proj, dt_b, Bc, Cc, z, D_skip)):
        raise TypeError(
            "mamba_scan: need A in f32 and the rest in one of "
            f"{COMPUTE_DTYPES}, got {[t.dtype for t in ts]}")
    want = ("xb, dt_proj, z (Ba, S, di), dt_b, D_skip (di,), A (di, ds), "
            "Bc, Cc (Ba, S, ds)")
    if xb.dim() != 3 or A.dim() != 2:
        raise _shapes_error("mamba_scan", ts, want)
    ba, s, di = xb.shape
    ds = A.shape[1]
    if (dt_proj.shape != xb.shape or z.shape != xb.shape
            or A.shape[0] != di or dt_b.shape != (di,)
            or D_skip.shape != (di,) or Bc.shape != (ba, s, ds)
            or Cc.shape != (ba, s, ds)):
        raise _shapes_error("mamba_scan", ts, want)
    _check_common("mamba_scan", ts, ba, s, di, ds)
    if not all(t.is_contiguous() for t in (xb, dt_proj, dt_b, A, D_skip)):
        raise ValueError("mamba_scan: xb, dt_proj, dt_b, A and D_skip must "
                         "be contiguous")
    if any(t.stride(-1) != 1 for t in (Bc, Cc, z)):
        raise ValueError("mamba_scan: Bc, Cc and z need unit stride along "
                         "their last dimension")
    # the last element's offset in each view, for the kernel's int indices
    span = max(sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
               for t in (xb, Bc, Cc, z))
    if max(span, ba * di * ds) >= 2**31:
        raise ValueError("mamba_scan: tensors must span < 2**31 values")


def _launch_mamba(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel on the current stream, for CUDA tensors that
    passed ``_check_fused``."""
    kernels.refuse_autograd("mamba_scan", xb, dt_proj, dt_b, A, Bc, Cc, z,
                            D_skip)
    _check_tma("mamba_scan", xb=xb, dt_proj=dt_proj, z=z)
    Bc, Cc = _tma_rows(Bc), _tma_rows(Cc)
    launch = build.function("selective_scan", pointers=10, ints=11, floats=0,
                            entry="mamba_scan")
    ba, s, di = xb.shape
    ds = A.shape[1]
    out = torch.empty_like(xb)
    final = torch.empty(ba, di, ds, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(xb.data_ptr(), dt_proj.data_ptr(), dt_b.data_ptr(),
                     A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), z.data_ptr(),
                     D_skip.data_ptr(), out.data_ptr(), final.data_ptr(), ba,
                     s, di, ds, int(xb.dtype == torch.bfloat16), Bc.stride(1),
                     Bc.stride(0), Cc.stride(1), Cc.stride(0), z.stride(1),
                     z.stride(0), stream)
    if err != 0:
        raise RuntimeError(
            f"mamba_scan kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["selective_scan"] += 1
    return out, final


class MambaScan(torch.autograd.Function):
    """The fused kernel forward; the backward is the vjp of
    ``mamba_scan_torch`` recomputed from the inputs, so it launches no
    kernel."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _launch_mamba(*inputs)

    @staticmethod
    def backward(ctx, g_out, g_final):
        return kernels.plain_vjp(mamba_scan_torch, ctx.saved_tensors,
                                 ctx.needs_input_grad, (g_out, g_final))


def mamba_scan(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba mixer's scan with its elementwise work fused around it:
    ``out = (y + xb * D_skip) * silu(z)`` with y the scan of (xb,
    softplus(dt_proj + dt_b), A, Bc, Cc), in xb's dtype (f32 or bf16), and
    the final state in f32. xb, dt_proj, z (Ba, S, di); dt_b, D_skip (di,);
    A (di, ds) f32; Bc, Cc (Ba, S, ds). z, Bc and Cc may be views with
    spaced rows (halves and slices of the projections' outputs). CPU
    tensors take ``mamba_scan_torch``; CUDA tensors launch the kernel on
    the current stream, counted under ``selective_scan``, differentiable
    through ``MambaScan``; meta tensors are traced (``MetaScan``)."""
    _check_fused(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)
    if xb.device.type == "cpu":
        return mamba_scan_torch(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)
    if xb.device.type == "meta":
        return MetaScan.apply(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)
    if xb.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for {xb.device}")
    return MambaScan.apply(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)
