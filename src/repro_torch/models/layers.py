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

On a mesh the activations are DTensors and every function here but
``attention`` runs as DTensor operations. ``attention`` hands the kernel
each rank's local batch and heads (``local_attention``), and
``local_scan`` hands the Mamba scan each rank's local batch and
channels: the kernels launch through raw pointers and never see a
DTensor. ``on_local_batch`` runs a whole function (the xLSTM cells) on
each rank's local batch with its weights gathered once.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attn import NEG_INF, flash_attention, scale_of
from repro_torch.kernels.selective_scan import mamba_scan
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def normed(x, scale, eps: float, ctx: ShardCtx = UNSHARDED):
    """``rms_norm`` of the residual stream, laid out (dp, None, None) on a
    mesh: the projections after it read whole sequences (a split one
    gathered, as sequence parallelism gathers before a column-parallel
    product; DTensor cannot flatten (B, S) into the rows of a product
    while S is split)."""
    return ctx.constrain(rms_norm(x, scale, eps), "dp", None, None)


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
    version on the CPU. q: (B, Sq, H, hd); k/v: (B, Sk, Kv, hd); DTensors
    on a mesh (``local_attention``)."""
    if isinstance(q, DTensor):
        return local_attention(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


def kv_heads_of(h0: int, n_local: int, n_heads: int, n_kv: int) -> list:
    """The KV heads of the q heads ``h0 .. h0 + n_local - 1`` of ``n_heads``
    grouped over ``n_kv`` (q head g reads KV head g // (n_heads / n_kv)):
    the contiguous run of KV heads when the local q heads fill whole
    groups of it, else one KV head per q head."""
    group = n_heads // n_kv
    per_q = [(h0 + j) // group for j in range(n_local)]
    run = list(range(per_q[0], per_q[-1] + 1))
    if n_local % len(run) == 0 and per_q == [
            run[j // (n_local // len(run))] for j in range(n_local)]:
        return run
    return per_q


def local_attention(q, k, v, *, causal: bool, window: int):
    """``flash_attention`` on each rank's local shards of DTensors q (B,
    Sq, H, hd), k, v (B, Sk, Kv, hd): batch split over the dp axes or
    whole, heads split over ``model`` or whole, the sequence and head dim
    whole. Where q's heads are split but the KV heads are not (Kv does
    not divide the axis), the rank hands the kernel the KV heads its q
    heads read (``kv_heads_of``), and their gradients are partial sums
    over that axis. Returns the output as a DTensor laid out as q."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    qp, kp = tuple(q.placements), tuple(k.placements)
    allowed = (Replicate(), Shard(0), Shard(2))
    if (any(p not in allowed for p in qp + kp) or tuple(v.placements) != kp
            or any((a == Shard(0)) != (b == Shard(0))
                   for a, b in zip(qp, kp))
            or any(b == Shard(2) and a != Shard(2) for a, b in zip(qp, kp))):
        raise ValueError(f"local_attention: q {qp}, k {kp}, v "
                         f"{tuple(v.placements)}: the batch and the heads "
                         "may be split, the KV heads only where q's are")
    grad = tuple(Partial() if a == Shard(2) and b != Shard(2) else b
                 for a, b in zip(qp, kp))
    ql = q.to_local()
    kl, vl = k.to_local(grad_placements=grad), v.to_local(
        grad_placements=grad)
    if grad != kp:
        block, coord = 0, mesh.get_coordinate()
        for i, p in enumerate(qp):
            if p == Shard(2):
                block = block * mesh.size(i) + coord[i]
        heads = kv_heads_of(block * ql.shape[2], ql.shape[2], q.shape[2],
                            k.shape[2])
        if heads == list(range(heads[0], heads[-1] + 1)):
            kl, vl = (t.narrow(2, heads[0], len(heads)) for t in (kl, vl))
        else:
            idx = torch.tensor(heads, device=kl.device)
            kl, vl = (t.index_select(2, idx) for t in (kl, vl))
    out = flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                          causal=causal, window=window)
    return DTensor.from_local(out, mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())


def local_view(t, want: tuple, act: tuple):
    """The local shard of the DTensor ``t`` laid out as ``want``, read
    beside an activation laid out as ``act``: where ``t`` is whole on a
    mesh axis that splits the activation, each rank's gradient is a
    partial sum over that axis. A mesh axis of one rank keeps ``t``'s own
    placement (no copy, no collective)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = t.device_mesh
    want = tuple(p if mesh.size(i) == 1 else w
                 for i, (p, w) in enumerate(zip(t.placements, want)))
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local(grad_placements=tuple(
        Partial() if w == Replicate() and a != Replicate()
        and mesh.size(i) > 1 else w
        for i, (w, a) in enumerate(zip(want, act))))


def local_scan(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip):
    """``mamba_scan`` on each rank's local shards of DTensors: xb,
    dt_proj, z (B, S, di) with the batch split over the dp axes or whole
    and the channels split over ``model`` or whole; dt_b, D_skip (di,) and
    A (di, ds) taken on the rank's channels, Bc, Cc (B, S, ds) on its
    rows. The scan is per channel, so each rank's output is its shard of
    the whole scan's. Bc's and Cc's gradients are partial sums over the
    axis that splits the channels; the weights' over the axes that split
    the batch. Returns (out, final state (B, di, ds)) as DTensors laid
    out as xb."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, xp = xb.device_mesh, tuple(xb.placements)
    if (any(p not in (Replicate(), Shard(0), Shard(2)) for p in xp)
            or tuple(dt_proj.placements) != xp
            or tuple(z.placements) != xp):
        raise ValueError(f"local_scan: xb {xp}, dt_proj "
                         f"{tuple(dt_proj.placements)}, z "
                         f"{tuple(z.placements)}: the batch and the "
                         "channels may be split, the sequence not")
    chan = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xp)
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in xp)
    out, final = mamba_scan(
        xb.to_local().contiguous(), dt_proj.to_local().contiguous(),
        local_view(dt_b, chan, xp).contiguous(),
        local_view(A, chan, xp).contiguous(), local_view(Bc, rows, xp),
        local_view(Cc, rows, xp), z.to_local(),
        local_view(D_skip, chan, xp).contiguous())
    fp = tuple(Shard(1) if p == Shard(2) else p for p in xp)
    B, _, di = xb.shape
    return (DTensor.from_local(out, mesh, xp, run_check=False,
                               shape=xb.shape, stride=xb.stride()),
            DTensor.from_local(final, mesh, fp, run_check=False,
                               shape=(B, di, A.shape[1]),
                               stride=(di * A.shape[1], A.shape[1], 1)))


def scan(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip):
    """The Mamba mixer's scan: the ``mamba_scan`` kernel on the card, its
    plain version on the CPU; DTensors on a mesh (``local_scan``)."""
    if isinstance(xb, DTensor):
        return local_scan(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)
    return mamba_scan(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip)


def on_local_batch(fn: Callable, w: Mapping[str, torch.Tensor], x, ctx):
    """``fn(w, x)`` (returning a tensor, or a tensor and a dict of
    batch-leading tensors) on each rank's local batch of the DTensor x
    (B, S, D), gathered whole over the sequence, with every weight of
    ``w`` gathered whole once: the model axis computes the same thing on
    every rank, so the weights' gradients are partial sums over the dp
    axes alone. Returns fn's results as DTensors laid out as the
    gathered x (the batch on the dp axes). ``fn(w, x)`` itself on a
    plain tensor."""
    if not isinstance(x, DTensor):
        return fn(w, x)
    from torch.distributed.tensor import Replicate

    x = ctx.constrain(x, "dp", None, None)
    mesh, xp = x.device_mesh, tuple(x.placements)
    whole = (Replicate(),) * mesh.ndim
    got = fn({k: local_view(t, whole, xp) if isinstance(t, DTensor) else t
              for k, t in w.items()}, x.to_local())

    def back(t, shape):
        return dtensor_from_local(t, mesh, xp, shape)

    if isinstance(got, tuple):
        out, state = got
        return back(out, x.shape), {
            k: back(v, (x.shape[0],) + tuple(v.shape[1:]))
            for k, v in state.items()}
    return back(got, x.shape)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One query token over the first ``cache_len`` slots of a KV cache,
    all in f32. q: (B, 1, H, hd); caches (B, S, Kv, hd).

    ``cache_len`` is a Python int, so the valid slots are a slice rather
    than the JAX package's -1e30 mask (the masked slots add exactly 0
    there) and nothing reads the device. A DTensor cache takes the mask
    instead: ``decode_attention_mesh``, the distributed flash-decode.
    """
    if isinstance(k_cache, DTensor):
        return decode_attention_mesh(q, k_cache, v_cache, cache_len)
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


def local_box(t) -> tuple:
    """(local shape, global offset) of this rank's shard of the DTensor
    ``t``, as DTensor cuts it (an uneven split gives the last ranks
    fewer rows, or none)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return tuple(shape), tuple(off)


def dtensor_from_local(t: torch.Tensor, mesh, placements, shape):
    """The local tensor ``t`` as a DTensor of global ``shape``, its
    strides the contiguous ones (computed, not read off a tensor: no
    tensor of the global shape is made, not even on the meta device)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def decode_attention_mesh(q, k_cache, v_cache, cache_len: int):
    """``decode_attention`` over DTensor caches (B, S, Kv, hd) laid out by
    ``ShardCtx.kv_cache_pspec``: the batch split over the dp axes or
    whole, the sequence over one or more mesh axes (``"seq"``,
    ``"seq2d"``), the KV heads over ``model`` (``"head"``), or neither.
    Each rank reads only its own slots and KV heads, with q (B, 1, H, hd)
    whole but for the batch, and masks the slots at or past ``cache_len``
    with -1e30 as the JAX package does. The softmax's max, and its sum
    beside the unnormalised P.V, are partial over the axes that split the
    sequence: two all-reduces of (B, Kv, rep, hd + 1) values, the
    distributed flash-decode. Nothing gathers the cache. Returns (B, 1,
    H, hd) in q's dtype: split as the cache's batch and KV heads (by
    whole groups of rep q heads), or, where the KV heads split unevenly,
    partial over those axes (each rank's heads, zeros elsewhere)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, cp = k_cache.device_mesh, tuple(k_cache.placements)
    if (any(p not in (Replicate(), Shard(0), Shard(1), Shard(2))
            for p in cp) or tuple(v_cache.placements) != cp):
        raise ValueError(f"decode_attention: k {cp}, v "
                         f"{tuple(v_cache.placements)}: the batch, the "
                         "sequence and the KV heads may be split")
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    ql = q.redistribute(mesh, tuple(
        Shard(0) if p == Shard(0) else Replicate() for p in cp)).to_local()
    (bl, sl, kvl, _), (_, s0, g0, _) = local_box(k_cache)
    kl, vl = k_cache.to_local().float(), v_cache.to_local().float()
    qg = ql[:, 0].float().reshape(bl, kv, rep, hd)[:, g0:g0 + kvl]
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, kl) * scale_of(hd)
    pos = torch.arange(s0, s0 + sl, device=kl.device)
    logits = torch.where(pos < cache_len, logits, NEG_INF)
    if sl:
        m = torch.amax(logits, dim=-1, keepdim=True)
    else:
        m = logits.new_full((bl, kvl, rep, 1), NEG_INF)
    # partial over the sequence's axes; the batch and the KV heads as the
    # cache's (dims 0 and 1 of a (B, Kv, rep, .) value)
    lay = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
                else Replicate() for p in cp)

    def reduce(t, op):
        part = tuple(Partial(op) if p == Shard(1) else a
                     for p, a in zip(cp, lay))
        return dtensor_from_local(t, mesh, part, (b, kv) + tuple(
            t.shape[2:])).redistribute(mesh, lay).to_local()

    m = reduce(m, "max")
    p = torch.exp(logits - m)
    ol = torch.cat([torch.einsum("bgrs,bsgd->bgrd", p, vl),
                    torch.sum(p, dim=-1, keepdim=True)], dim=-1)
    ol = reduce(ol, "sum")
    out = (ol[..., :hd] / torch.clamp(ol[..., hd:], min=1e-30)).reshape(
        bl, 1, kvl * rep, hd).to(q.dtype)
    splits = math.prod(mesh.size(i) for i, p in enumerate(cp)
                       if p == Shard(2))
    if kv % splits == 0:
        heads = Shard(2)
    else:
        heads = Partial()
        whole = out.new_zeros(bl, 1, h, hd)
        whole[:, :, g0 * rep:(g0 + kvl) * rep] = out
        out = whole
    return dtensor_from_local(out, mesh, tuple(
        Shard(0) if p == Shard(0) else heads if p == Shard(2)
        else Replicate() for p in cp), (b, 1, h, hd))


# ---------------------------------------------------------------------------
# MLPs
def mlp_apply(w: Mapping[str, torch.Tensor], x: torch.Tensor, *,
              gated: bool, eps: float, ctx: ShardCtx = UNSHARDED
              ) -> torch.Tensor:
    """The gated MLP ``silu(h wg) * (h wi) wo2`` of every arch but the
    encoder-decoder, whose MLP is ``gelu(h wi) wo2`` with the tanh
    approximation (``jax.nn.gelu``'s default). ``w``: the layer's weights,
    matrices already in x's dtype. On a mesh the normed input is
    gathered over the sequence first (``normed``)."""
    h = normed(x, w["ln2"], eps, ctx)
    if gated:
        a = F.silu(h @ w["wg"]) * (h @ w["wi"])
    else:
        a = F.gelu(h @ w["wi"], approximate="tanh")
    return a @ w["wo2"]
