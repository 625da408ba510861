"""Per-layer block application of the LMs (the JAX package's
``models/blocks.py``): a mixer (self-attention, global or sliding-window;
a self-attention followed by the gated cross-attention onto the vision
tokens; the Mamba mixer; the mLSTM or sLSTM cell) + the FFN (the dense MLP,
or on an MoE layer the top-k experts of ``moe.moe_apply``; none where the
layer has no ``ln2``, as xLSTM's cells carry their own projections), for
the parallel (prefill) and the one-token (decode) paths. An
encoder-decoder's layers add a cross-attention onto the encoder's memory
after the mixer (``xa``: that layer's ``xattn`` weights).

``w`` is a layer's weights by the JAX package's leaf names, matrices in the
compute dtype and norm scales, the router and the sLSTM's ``r`` and ``b``
in f32 (``model.DecoderLayer.weights``). ``rope`` is the ``(cos, sin)``
pair of ``layers.rope_cos_sin`` for the positions in flight, computed once
per forward and shared by the attention layers.

``ctx`` (``sharding.ctx``) constrains the activations where the JAX
package does: q, k and v (the cross-attentions' too, k and v from the
memory) to (dp, None, heads, None), the heads split over ``model`` where
their count divides it (``ShardCtx.heads_axis``), the Mamba mixer's
channels to (dp, None, tp) (``mamba``), and the residual stream after
each mixer and FFN to (dp, sp, None); the MoE FFN runs each rank's
groups (``moe``), the xLSTM cells each rank's local batch
(``layers.on_local_batch``); and
where DTensor needs it: each product's input gathered over the sequence
(``layers.normed``) and the row-parallel products' outputs laid out as
the residual stream before they are added to it, so no gradient reaches
a product split over the sequence. Off a mesh (``UNSHARDED``, serving,
one card) it does nothing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    CROSS,
    MAMBA,
    MLSTM,
    SLSTM,
    ModelConfig,
)
from repro_torch.models import spec as S
from repro_torch.models.layers import (
    apply_rope,
    attention,
    decode_attention,
    dtensor_from_local,
    local_box,
    mlp_apply,
    normed,
    on_local_batch,
    rms_norm,
)
from repro_torch.models.mamba import mamba_apply, mamba_decode
from repro_torch.models.moe import moe_apply
from repro_torch.models.xlstm import (
    mlstm_apply,
    mlstm_decode,
    slstm_apply,
    slstm_decode,
)
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx

Weights = Mapping[str, torch.Tensor]
Rope = Tuple[torch.Tensor, torch.Tensor]


def layer_window(cfg: ModelConfig, kind: str) -> int:
    """The sliding window of an attention layer's cache (0 = global)."""
    if kind == ATTN_LOCAL or (cfg.block_pattern is None and cfg.swa_window):
        return cfg.swa_window
    return 0


def self_window(cfg: ModelConfig, kind: str) -> int:
    """The window of a layer's self-attention: a ``CROSS`` layer's is
    global, as in the JAX package, whatever its cache holds."""
    return 0 if kind == CROSS else layer_window(cfg, kind)


def _qkv(w: Weights, h: torch.Tensor, cfg: ModelConfig,
         ctx: ShardCtx = UNSHARDED):
    """q (B, S, H, hd), k and v (B, S, Kv, hd). On a mesh each projection
    is laid out by its heads (``ShardCtx.heads_axis``) before it is split
    into heads, so a split over ``model`` falls on whole heads."""
    return (_heads(w["wq"], h, cfg.n_heads, cfg, ctx),
            _heads(w["wk"], h, cfg.n_kv_heads, cfg, ctx),
            _heads(w["wv"], h, cfg.n_kv_heads, cfg, ctx))


def _heads(wp: torch.Tensor, h: torch.Tensor, n: int, cfg: ModelConfig,
           ctx: ShardCtx) -> torch.Tensor:
    """``h @ wp`` split into ``n`` heads (B, S, n, hd)."""
    y = ctx.constrain_raw(h @ wp, (ctx.axis("dp"), None, ctx.heads_axis(n)))
    return y.reshape(*h.shape[:2], n, cfg.hd)


def _maybe_qk_norm(w: Weights, q, k, cfg: ModelConfig):
    if cfg.qk_norm and "qn" in w:
        q = rms_norm(q, w["qn"], cfg.norm_eps)
        k = rms_norm(k, w["kn"], cfg.norm_eps)
    return q, k


def self_attention_parallel(w: Weights, x: torch.Tensor, cfg: ModelConfig, *,
                            rope: Rope, window: int, causal: bool = True,
                            ctx: ShardCtx = UNSHARDED
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-attention (causal in the decoders, not in the encoder).
    Returns (attention output, kv dict for cache construction)."""
    h = normed(x, w["ln1"], cfg.norm_eps, ctx)
    q, k, v = _qkv(w, h, cfg, ctx)
    q, k = _maybe_qk_norm(w, q, k, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    dp, kv_ax = ctx.axis("dp"), ctx.heads_axis(cfg.n_kv_heads)
    q = ctx.constrain_raw(q, (dp, None, ctx.heads_axis(cfg.n_heads), None))
    k = ctx.constrain_raw(k, (dp, None, kv_ax, None))
    v = ctx.constrain_raw(v, (dp, None, kv_ax, None))
    o = attention(q, k, v, causal=causal, window=window)
    return _out_proj(o, w["wo"], cfg, ctx), {"k": k, "v": v}


def _out_proj(o: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
              ctx: ShardCtx) -> torch.Tensor:
    """The attention's output o (B, S, H, hd) through its row-parallel
    projection ``wo`` (H * hd, D), laid out as the residual stream. Where
    the heads do not split over ``model`` but wo's rows do, wo's rows are
    gathered whole first, and the flattened o's gradient is held to o's
    own layout: DTensor may return it split across H * hd finer than the
    heads (16 ranks over 4 heads), which it cannot unflatten."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    o = o.reshape(*o.shape[:2], cfg.n_heads * cfg.hd)
    if (isinstance(wo, DTensor) and ctx.tp in wo.device_mesh.mesh_dim_names
            and ctx.heads_axis(cfg.n_heads) is None):
        model = wo.device_mesh.mesh_dim_names.index(ctx.tp)
        if wo.placements[model] == Shard(0):
            wo = wo.redistribute(wo.device_mesh, tuple(
                Replicate() if i == model else p
                for i, p in enumerate(wo.placements)))
        if isinstance(o, DTensor):
            o = dtensor_from_local(o.to_local(), o.device_mesh,
                                   tuple(o.placements), o.shape)
    return ctx.constrain(o @ wo, "dp", "sp", None)


def _gated(out: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The VLM's cross-attention output times ``tanh(xgate)`` (in the
    compute dtype, as the JAX package casts the gate)."""
    return out if gate is None else out * torch.tanh(gate)


def cross_attention_parallel(w: Weights, x: torch.Tensor,
                             memory: torch.Tensor, cfg: ModelConfig, *,
                             gate: Optional[torch.Tensor] = None,
                             ctx: ShardCtx = UNSHARDED
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention of x's tokens onto ``memory`` (B, M, D), the vision tokens
    or the encoder's states, with no mask (M may be shorter than the
    prompt). Returns (output, its ``{"k", "v"}`` (B, M, Kv, hd)). On a
    mesh the memory is laid out (dp, None, None), q, k and v are split by
    their heads as in the self-attention, and the gate multiplies the
    output laid out as the residual stream."""
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    h = normed(x, w["lnx"], cfg.norm_eps, ctx)
    q = _heads(w["xq"], h, H, cfg, ctx)
    k = _heads(w["xk"], memory, Kv, cfg, ctx)
    v = _heads(w["xv"], memory, Kv, cfg, ctx)
    o = attention(q, k, v, causal=False, window=0)
    return _gated(_out_proj(o, w["xo"], cfg, ctx), gate), {"k": k, "v": v}


def ffn_parallel(w: Weights, x: torch.Tensor, cfg: ModelConfig,
                 is_moe: bool, ctx: ShardCtx = UNSHARDED
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual FFN (none on a layer without ``ln2``) and the f32 aux
    loss of an MoE layer (None elsewhere: no tensor made for a 0)."""
    if "ln2" not in w:
        return x, None
    if is_moe:
        y, aux = moe_apply(w, x, cfg, ctx=ctx)
        y = ctx.constrain(y, "dp", "sp", None)
        return ctx.constrain(x + y, "dp", "sp", None), aux
    y = ctx.constrain(mlp_apply(w, x, gated=S.mlp_gated(cfg),
                                eps=cfg.norm_eps, ctx=ctx), "dp", "sp", None)
    return ctx.constrain(x + y, "dp", "sp", None), None


def block_forward(w: Weights, x: torch.Tensor, kind: str, is_moe: bool,
                  cfg: ModelConfig, *, rope: Rope,
                  memory: Optional[torch.Tensor] = None,
                  xa: Optional[Weights] = None, causal: bool = True,
                  ctx: ShardCtx = UNSHARDED
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """One layer (the JAX package's ``block_parallel``). Returns (x, the
    MoE aux loss or None, its cache state): ``{"k", "v"}`` (B, S, Kv, hd) of an
    attention layer, with ``{"xk", "xv"}`` (B, M, Kv, hd) of its
    cross-attention onto ``memory`` (a ``CROSS`` layer, or any layer
    given ``xa``); ``{"conv", "ssm"}`` of a Mamba layer; the mLSTM's or
    the sLSTM's final state."""
    if kind in (ATTN, ATTN_LOCAL, CROSS):
        o, kv = self_attention_parallel(w, x, cfg, rope=rope,
                                        window=self_window(cfg, kind),
                                        causal=causal, ctx=ctx)
        x = ctx.constrain(x + o, "dp", "sp", None)
        if kind == CROSS:
            xo, kvx = cross_attention_parallel(w, x, memory, cfg,
                                               gate=w["xgate"], ctx=ctx)
            x = ctx.constrain(x + xo, "dp", "sp", None)
            kv.update(xk=kvx["k"], xv=kvx["v"])
    else:
        if kind == MAMBA:
            o, kv = mamba_apply(w, x, cfg, return_state=True, ctx=ctx)
        else:
            apply = {MLSTM: mlstm_apply, SLSTM: slstm_apply}[kind]
            o, kv = on_local_batch(lambda w, x: apply(
                w, x, cfg, return_state=True), w, x, ctx)
        x = ctx.constrain(x + ctx.constrain(o, "dp", "sp", None),
                          "dp", "sp", None)
    if xa is not None and kind != CROSS:
        # the encoder-decoder's cross-attention, in every decoder layer
        xo, kvx = cross_attention_parallel(xa, x, memory, cfg, ctx=ctx)
        x = ctx.constrain(x + xo, "dp", "sp", None)
        kv.update(xk=kvx["k"], xv=kvx["v"])
    x, aux = ffn_parallel(w, x, cfg, is_moe, ctx)
    return x, aux, kv


def block_parallel(w: Weights, x: torch.Tensor, kind: str, is_moe: bool,
                   cfg: ModelConfig, *, rope: Rope,
                   memory: Optional[torch.Tensor] = None,
                   xa: Optional[Weights] = None, causal: bool = True,
                   return_kv: bool = False, ctx: ShardCtx = UNSHARDED
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One layer of serving (``block_forward`` without the aux loss,
    which serving drops, as the JAX package's does). Returns (x, its cache
    state, or None without ``return_kv``)."""
    x, _, kv = block_forward(w, x, kind, is_moe, cfg, rope=rope,
                             memory=memory, xa=xa, causal=causal, ctx=ctx)
    return x, (kv if return_kv else None)


# ---------------------------------------------------------------------------
# decode path
def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Write ``new`` (B, 1, Kv, hd) into slot ``slot`` of ``cache`` (B, S,
    Kv, hd), in place, in the cache's dtype. A DTensor cache is written on
    the rank that holds that slot, through its local shard, with ``new``
    laid out as the cache's batch and KV heads: no other rank's shard
    changes and nothing gathers the cache."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(cache, DTensor):
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    mesh, cp = cache.device_mesh, tuple(cache.placements)
    local = new.redistribute(mesh, tuple(
        Replicate() if p == Shard(1) else p for p in cp)).to_local()
    (_, n, _, _), (_, s0, _, _) = local_box(cache)
    if s0 <= slot < s0 + n:
        cache.to_local()[:, slot - s0] = local[:, 0].to(cache.dtype)


def attn_decode(w: Weights, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                cache_len: int, cfg: ModelConfig, *, rope: Rope, window: int,
                ctx: ShardCtx = UNSHARDED
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D). cache: {'k', 'v'} (B, S_c, Kv, hd), a ring of S_c slots
    for a sliding-window layer. Writes this token's k, v into its slot in
    place (the JAX package returns updated copies; ``write_slot``) and
    returns (out, cache). On a mesh q, k and v are laid out by their heads
    as in prefill, the cache keeps its layout and the attention is the
    distributed flash-decode (``layers.decode_attention_mesh``)."""
    h = normed(x, w["ln1"], cfg.norm_eps, ctx)
    q, k, v = _qkv(w, h, cfg, ctx)
    q, k = _maybe_qk_norm(w, q, k, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    s_cache = cache["k"].shape[1]
    slot = cache_len % s_cache if window else min(cache_len, s_cache - 1)
    write_slot(cache["k"], k, slot)
    write_slot(cache["v"], v, slot)
    valid = min(cache_len + 1, s_cache)
    o = decode_attention(q, cache["k"], cache["v"], valid)
    return _out_proj(o, w["wo"], cfg, ctx), cache


def cross_decode(w: Weights, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, gate: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """One token (B, 1, D) onto the whole memory cached at prefill
    (``cache["xk"]``, ``cache["xv"]``, never written here)."""
    B = x.shape[0]
    h = rms_norm(x, w["lnx"], cfg.norm_eps)
    q = (h @ w["xq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    o = decode_attention(q, cache["xk"], cache["xv"], cache["xk"].shape[1])
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd)
    return _gated(o @ w["xo"], gate)


def block_decode(w: Weights, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cache_len: int, kind: str, is_moe: bool, cfg: ModelConfig,
                 *, rope: Rope, xa: Optional[Weights] = None,
                 ctx: ShardCtx = UNSHARDED
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token (B, 1, D) through a layer; an MoE layer routes the B
    tokens as one group, as the JAX package's decode does. ``ctx`` lays
    out an attention layer's and the dense MLP's activations on a mesh
    (the other families serve on one device)."""
    if kind in (ATTN, ATTN_LOCAL, CROSS):
        o, cache = attn_decode(w, x, cache, cache_len, cfg, rope=rope,
                               window=self_window(cfg, kind), ctx=ctx)
        x = x + o
        if kind == CROSS:
            x = x + cross_decode(w, x, cache, cfg, gate=w["xgate"])
    else:
        step = {MAMBA: mamba_decode, MLSTM: mlstm_decode,
                SLSTM: slstm_decode}[kind]
        o, cache = step(w, x, cache, cfg)
        x = x + o
    if xa is not None and kind != CROSS:
        x = x + cross_decode(xa, x, cache, cfg)
    return ffn_parallel(w, x, cfg, is_moe, ctx)[0], cache
