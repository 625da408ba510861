"""GQA attention forward with causal and sliding-window masks: the LM's
prefill attention.

- ``flash_attention``: the wrapper ``models.layers.attention`` calls. For
  CPU tensors it runs the plain version; for CUDA tensors it launches the
  hand-written kernels of ``csrc/flash_attn.cu`` (which replace the TPU
  kernel ``flash_attention_fwd``) or raises. The dtype picks the entry
  (``kernel_entry``): bf16 runs on the tensor cores (wgmma, TMA), f32 on
  the CUDA cores, the reference path. There is no fallback. On the card
  it is differentiable through ``FlashAttention``: the kernel forward,
  the backward the vjp of the plain version.
- ``attention_torch``: the plain PyTorch version of the same function,
  with materialised f32 scores.

Layout is the JAX package's: q (B, Sq, H, hd), k and v (B, Sk, Kv, hd),
output (B, Sq, H, hd) in q's dtype, f32 or bf16. Queries end where the keys
end (``q_pos = i + Sk - Sq``); ``causal`` keeps ``q_pos - k_pos >= 0`` and
``window > 0`` keeps ``q_pos - k_pos < window``. Any Sq <= Sk; Sq > Sk only
without either mask (a cross-attention onto a shorter memory: every key is
live for every query, as in the JAX package's ``attention``). Scores, the
softmax and P.V are f32, as in the Pallas kernel and
``kernels/ref.py::attention_ref``.
The bf16 kernel alone rounds the probabilities to bf16 before P.V (its
tensor-core product takes bf16 operands), as
``models/layers.py::attention_full`` casts them to v's dtype; it is held
to the plain version at the bf16 tolerance, 2e-2.
"""

from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations
_ENTRY = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


def scale_of(head_dim: int) -> float:
    """The softmax scale ``1 / sqrt(hd)``, rounded to f32 by both paths."""
    return 1.0 / math.sqrt(head_dim)


def attention_torch(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Plain PyTorch version: (B, Kv, rep, Sq, Sk) f32 scores, masked with
    ``NEG_INF``, softmax, then P.V in f32."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qg = q.float().reshape(b, sq, kv, rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale_of(hd)
    if causal or window > 0:
        q_pos = torch.arange(sq, device=q.device) + (sk - sq)
        dist = q_pos[:, None] - torch.arange(sk, device=q.device)[None, :]
        live = torch.ones_like(dist, dtype=torch.bool)
        if causal:
            live &= dist >= 0
        if window > 0:
            live &= dist < window
        logits = logits.masked_fill(~live, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _check(q, k, v, causal: bool, window: int) -> None:
    """Raise on anything the kernel does not take."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention: a DTensor reached the kernel; "
                        "pass each rank's local shards "
                        "(models.layers.local_attention)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must all be f32 or all "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "flash_attention: need q (B, Sq, H, hd) and k, v (B, Sk, Kv, hd), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    kb, sk, kv, khd = k.shape
    if kb != b or khd != hd or kv == 0 or h % kv != 0:
        raise ValueError(
            "flash_attention: batch and head_dim must match and H must be a "
            f"multiple of Kv, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if sq > sk and (causal or window):
        raise ValueError(f"flash_attention: Sq ({sq}) must not exceed Sk "
                         f"({sk}) for a causal or windowed call")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention: window must be an int >= 0, got "
                         f"{window!r}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("flash_attention: tensors must hold < 2**31 values")


def kernel_entry(q, k, v) -> str:
    """The C entry point for tensors that passed ``_check``: the dtype
    picks it. The bf16 kernel reads q, k and v through TMA tensor maps,
    which need 16-byte aligned base addresses and strides: raise if a
    tensor does not give them (the f32 kernel reads with plain loads)."""
    entry = _ENTRY[q.dtype]
    if q.dtype == torch.bfloat16:
        for name, t in zip("qkv", (q, k, v)):
            strides = [s * t.element_size() for s in t.stride()[:-1]]
            if t.data_ptr() % 16 or any(s % 16 for s in strides):
                raise ValueError(
                    f"flash_attention: bf16 {name} needs a 16-byte aligned "
                    f"address and strides for its tensor map, got address "
                    f"{t.data_ptr():#x} and byte strides {strides}")
    return entry


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The kernel on the current stream, for CUDA tensors that passed
    ``_check``."""
    kernels.refuse_autograd("flash_attn", q, k, v)
    launch = build.function("flash_attn", pointers=4, ints=8, floats=1,
                            entry=kernel_entry(q, k, v))
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, sk, h, kv, hd, int(causal), window, scale_of(hd),
                     stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attn kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES["flash_attn"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward is the vjp of ``attention_torch``
    recomputed from q, k and v (the JAX package's ``_fa_bwd`` takes the
    vjp of its jnp attention), so it launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window)
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        return kernels.plain_vjp(attention_torch, ctx.saved_tensors,
                                 ctx.needs_input_grad[:3], (g,),
                                 **ctx.mask) + (None, None)


def attention_cost(q, k, v) -> tuple:
    """(FLOPs, bytes) of one call: the plain version's two products over
    the full Sq x Sk scores (Q.K^T and P.V, 2 * B * H * Sq * Sk * hd
    each, masked or not), as ``FlopCounterMode`` counts
    ``attention_torch``; q, k and v read once, the output written once."""
    b, sq, h, hd = q.shape
    return 4 * b * h * sq * k.shape[1] * hd, kernels.nbytes(q, k, v, q)


class MetaAttention(torch.autograd.Function):
    """The kernel's call on meta tensors: an output of its shape and
    dtype, no computation, no launch, the cost ``attention_cost``
    reported (``kernels.meta_cost``). Its backward reports the plain
    version's vjp: four products of the forward's size (dQ, dK, dP, dV),
    q, k, v and the output's gradient read, their gradients written."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        kernels.meta_cost(*attention_cost(q, k, v))
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        flops, _ = attention_cost(q, k, v)
        kernels.meta_cost(2 * flops, 2 * kernels.nbytes(q, k, v) +
                          kernels.nbytes(g))
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Attention of q over k, v. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, differentiable
    through ``FlashAttention``; meta tensors are traced
    (``MetaAttention``)."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_torch(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return MetaAttention.apply(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return FlashAttention.apply(q, k, v, causal, window)
