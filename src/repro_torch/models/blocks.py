"""Per-layer block application of the LMs (the JAX package's
``models/blocks.py``): a mixer (self-attention, global or sliding-window,
or the Mamba mixer) + the FFN (the dense gated MLP, or on an MoE layer the
top-k experts of ``moe.moe_apply``), for the parallel (prefill) and the
one-token (decode) paths.

``w`` is a layer's weights by the JAX package's leaf names, matrices in the
compute dtype and norm scales and the router in f32
(``model.DecoderLayer.weights``). ``rope`` is the ``(cos, sin)`` pair of
``layers.rope_cos_sin`` for the positions in flight, computed once per
forward and shared by the attention layers.
Other mixer kinds raise ``NotImplementedError`` naming the slice of the
port that brings them, as ``spec.check_ported`` does for a whole config
(other mixers, the encoder-decoder) wherever a model or its weights are
built.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, ModelConfig
from repro_torch.models import spec as S
from repro_torch.models.layers import (
    apply_rope,
    attention,
    decode_attention,
    mlp_apply,
    rms_norm,
)
from repro_torch.models.mamba import mamba_apply, mamba_decode
from repro_torch.models.moe import moe_apply

Weights = Mapping[str, torch.Tensor]
Rope = Tuple[torch.Tensor, torch.Tensor]


def layer_window(cfg: ModelConfig, kind: str) -> int:
    """The sliding window of an attention layer (0 = global)."""
    if kind == ATTN_LOCAL or (cfg.block_pattern is None and cfg.swa_window):
        return cfg.swa_window
    return 0


def _qkv(w: Weights, h: torch.Tensor, cfg: ModelConfig):
    B, Sq, _ = h.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ w["wq"]).reshape(B, Sq, H, hd)
    k = (h @ w["wk"]).reshape(B, Sq, Kv, hd)
    v = (h @ w["wv"]).reshape(B, Sq, Kv, hd)
    return q, k, v


def _maybe_qk_norm(w: Weights, q, k, cfg: ModelConfig):
    if cfg.qk_norm and "qn" in w:
        q = rms_norm(q, w["qn"], cfg.norm_eps)
        k = rms_norm(k, w["kn"], cfg.norm_eps)
    return q, k


def self_attention_parallel(w: Weights, x: torch.Tensor, cfg: ModelConfig, *,
                            rope: Rope, window: int
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal self-attention. Returns (attention output, kv dict for cache
    construction)."""
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q, k, v = _qkv(w, h, cfg)
    q, k = _maybe_qk_norm(w, q, k, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, causal=True, window=window)
    o = o.reshape(*o.shape[:2], cfg.n_heads * cfg.hd)
    return o @ w["wo"], {"k": k, "v": v}


def ffn_parallel(w: Weights, x: torch.Tensor, cfg: ModelConfig,
                 is_moe: bool) -> torch.Tensor:
    """The residual FFN; an MoE layer's aux loss is dropped, as serving
    drops it in the JAX package."""
    if is_moe:
        return x + moe_apply(w, x, cfg)[0]
    return x + mlp_apply(w, x, eps=cfg.norm_eps)


def block_parallel(w: Weights, x: torch.Tensor, kind: str, is_moe: bool,
                   cfg: ModelConfig, *, rope: Rope, return_kv: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One layer. Returns (x, its cache state or None): ``{"k", "v"}``
    (B, S, Kv, hd) of an attention layer, ``{"conv", "ssm"}`` of a Mamba
    layer."""
    if kind in (ATTN, ATTN_LOCAL):
        o, kv = self_attention_parallel(w, x, cfg, rope=rope,
                                        window=layer_window(cfg, kind))
    elif kind == MAMBA:
        o, kv = mamba_apply(w, x, cfg, return_state=True)
    else:
        raise S.not_ported(kind)
    x = ffn_parallel(w, x + o, cfg, is_moe)
    return x, (kv if return_kv else None)


# ---------------------------------------------------------------------------
# decode path
def attn_decode(w: Weights, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                cache_len: int, cfg: ModelConfig, *, rope: Rope, window: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D). cache: {'k', 'v'} (B, S_c, Kv, hd), a ring of S_c slots
    for a sliding-window layer. Writes this token's k, v into its slot in
    place (the JAX package returns updated copies) and returns (out,
    cache)."""
    B = x.shape[0]
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q, k, v = _qkv(w, h, cfg)
    q, k = _maybe_qk_norm(w, q, k, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    s_cache = cache["k"].shape[1]
    slot = cache_len % s_cache if window else min(cache_len, s_cache - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    valid = min(cache_len + 1, s_cache)
    o = decode_attention(q, cache["k"], cache["v"], valid)
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd)
    return o @ w["wo"], cache


def block_decode(w: Weights, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cache_len: int, kind: str, is_moe: bool, cfg: ModelConfig,
                 *, rope: Rope
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token (B, 1, D) through a layer; an MoE layer routes the B
    tokens as one group, as the JAX package's decode does."""
    if kind in (ATTN, ATTN_LOCAL):
        o, cache = attn_decode(w, x, cache, cache_len, cfg, rope=rope,
                               window=layer_window(cfg, kind))
    elif kind == MAMBA:
        o, cache = mamba_decode(w, x, cache, cfg)
    else:
        raise S.not_ported(kind)
    return ffn_parallel(w, x + o, cfg, is_moe), cache
