"""Core neural layers of the LMs (the JAX package's
``models/layers.py``): RMSNorm, RoPE, GQA attention for prefill (through
the ``flash_attn`` kernel wrapper) and for one decode token over a cache,
and the MLPs (gated, or plain GELU).

Each function casts where the JAX package casts: ``rms_norm`` and
``apply_rope`` compute in f32 and return the input's dtype,
``decode_attention`` is all f32 over a cache in the compute dtype, and the
MLP's products run in the compute dtype. Attention is causal and may be
windowed in the decoders; the encoder's and the cross-attentions onto a
memory (vision tokens, audio frames) have no mask.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import flash_attention, scale_of


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim//2) f32."""
    half = head_dim // 2
    freq = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(theta, freq)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:   # (S, half) -> broadcast over batch and heads
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:                # (B, S, half)
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos_ - x2 * sin_
    out2 = x2 * cos_ + x1 * sin_
    return torch.cat([out1, out2], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# GQA helpers
def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kv, hd) -> (B, S, Kv*n_rep, hd)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention: the ``flash_attn`` kernel on the card, its plain
    version on the CPU. q: (B, Sq, H, hd); k/v: (B, Sk, Kv, hd)."""
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One query token over the first ``cache_len`` slots of a KV cache,
    all in f32. q: (B, 1, H, hd); caches (B, S, Kv, hd).

    ``cache_len`` is a Python int, so the valid slots are a slice rather
    than the JAX package's -1e30 mask (the masked slots add exactly 0
    there) and nothing reads the device.
    """
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    n_rep = h // kv
    qg = q[:, 0].float().reshape(b, kv, n_rep, hd)            # (B, Kv, rep, hd)
    kf = k_cache[:, :cache_len].float()                       # (B, S, Kv, hd)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, kf) * scale_of(hd)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    probs = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bgrs,bsgd->bgrd", probs,
                       v_cache[:, :cache_len].float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
def mlp_apply(w: Mapping[str, torch.Tensor], x: torch.Tensor, *,
              gated: bool, eps: float) -> torch.Tensor:
    """The gated MLP ``silu(h wg) * (h wi) wo2`` of every arch but the
    encoder-decoder, whose MLP is ``gelu(h wi) wo2`` with the tanh
    approximation (``jax.nn.gelu``'s default). ``w``: the layer's weights,
    matrices already in x's dtype."""
    h = rms_norm(x, w["ln2"], eps)
    if gated:
        a = F.silu(h @ w["wg"]) * (h @ w["wi"])
    else:
        a = F.gelu(h @ w["wi"], approximate="tanh")
    return a @ w["wo2"]
