"""Model assembly of the LMs (the JAX package's ``models/model.py``):
embedding -> decoder layers -> final norm -> head, with prefill and
one-token decode over explicit caches.

``DecoderLM`` holds the f32 master weights: the embedding, the final norm,
the untied head if any, and a ``ModuleList`` of ``DecoderLayer`` in layer
order. The JAX package casts each master to ``cfg.dtype`` at every use; the
port makes those copies once, at load, which gives the same values (norm
scales, ``A_log`` and the MoE router stay f32, as the JAX package reads
them in f32).

The cache is a list with one entry per layer. An attention layer's is
``{"k", "v"}``, each (B, S_c, Kv, hd) in the compute dtype; a
sliding-window layer keeps ``min(cache_seq_len, window)`` slots as a ring
(absolute position P in slot P % S_c). A Mamba layer's is ``{"conv"
(B, d_conv - 1, di), "ssm" (B, di, d_state)}`` in f32. ``cache_len`` is a
Python int everywhere, so prefill and decode never read the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.models import spec as S
from repro_torch.models.blocks import block_decode, block_parallel, layer_window
from repro_torch.models.init import NORMS
from repro_torch.models.layers import rms_norm, rope_cos_sin
from repro_torch.models.mamba import mamba_cache_spec

# read in f32 from the masters by the JAX package
F32_LEAVES = NORMS + ("A_log", "router")

Cache = List[Dict[str, torch.Tensor]]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DecoderLayer(nn.Module):
    """One layer's f32 master weights, by the JAX package's leaf names,
    and their compute-dtype copies (``weights()``); ``kind`` is its mixer,
    ``is_moe`` whether its FFN is the experts (``cfg.is_moe_layer``)."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], kind: str,
                 is_moe: bool, dtype: torch.dtype):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.kind = kind
        self.is_moe = is_moe
        self.dtype = dtype
        self._weights: Optional[Dict[str, torch.Tensor]] = None

    def weights(self) -> Dict[str, torch.Tensor]:
        """Norm scales, ``A_log`` and ``router`` as the f32 masters; every
        other leaf in the compute dtype (the masters themselves when that
        is f32), made at first call."""
        if self._weights is None:
            self._weights = {
                name: p if name in F32_LEAVES else p.to(self.dtype)
                for name, p in self.named_parameters()}
        return self._weights

    def _apply(self, fn, recurse=True):
        self._weights = None   # moved or cast masters: copies are remade
        return super()._apply(fn, recurse)


class DecoderLM(nn.Module):
    """A decoder-only LM, built from the JAX package's parameter tree
    (``from_tree``)."""

    def __init__(self, cfg: ModelConfig, tree: Mapping[str, Any]):
        super().__init__()
        S.check_ported(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.emb = nn.Parameter(tree["emb"], requires_grad=False)
        self.final_ln = nn.Parameter(tree["final_ln"], requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(tree["head"], requires_grad=False)
        period, R, _ = S.layout(cfg)
        layers = []
        for i in range(cfg.n_layers):
            if i < R * period:
                leaves = {k: t[i // period]
                          for k, t in tree["body"][i % period].items()}
            else:
                leaves = tree["tail"][i - R * period]
            layers.append(DecoderLayer(leaves, S.layer_kind_at(cfg, i),
                                       cfg.is_moe_layer(i), self.dtype))
        self.layers = nn.ModuleList(layers)
        self._head: Optional[torch.Tensor] = None

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: Mapping[str, Any]) -> "DecoderLM":
        """Build from f32 tensors in the JAX package's layout (``body[p]
        [name][r]`` is layer ``r * period + p``, ``tail[j]`` layer ``R *
        period + j``), and make the compute-dtype copies now."""
        model = cls(cfg, tree)
        model.head_weights()
        for layer in model.layers:
            layer.weights()
        return model

    def head_weights(self) -> torch.Tensor:
        """(D, V) head in the compute dtype; the tied one is a transposed
        view of the embedding's copy, made once."""
        if self._head is None:
            if self.cfg.tie_embeddings:
                self._head = self.emb.to(self.dtype).T
            else:
                self._head = self.head.to(self.dtype)
        return self._head

    def _apply(self, fn, recurse=True):
        self._head = None
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.emb.device


def embed(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    """Gather f32 rows of the embedding, then cast to the compute dtype."""
    rows = model.emb.index_select(0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, -1).to(model.dtype)


def _logits(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """(B, D) hidden -> (B, V) f32 logits: final norm, the head product in
    the compute dtype, then f32."""
    xf = rms_norm(x, model.final_ln, model.cfg.norm_eps)
    return (xf @ model.head_weights()).float()


# ---------------------------------------------------------------------------
# caches
def _attn_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    window = layer_window(cfg, kind)
    return min(seq_len, window) if window else seq_len


def layer_cache_spec(cfg: ModelConfig, layer_idx: int, batch: int,
                     seq_len: int, dtype: torch.dtype
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Name -> (shape, dtype) of one layer's decode cache: ``{"k", "v"}``
    of an attention layer, ``{"conv", "ssm"}`` of a Mamba layer."""
    kind = S.layer_kind_at(cfg, layer_idx)
    if kind == MAMBA:
        return mamba_cache_spec(cfg, batch)
    sc = _attn_cache_len(cfg, kind, seq_len)
    shape = (batch, sc, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_cache(model: DecoderLM, batch: int, seq_len: int) -> Cache:
    return [{name: torch.zeros(shape, dtype=dt, device=model.device)
             for name, (shape, dt) in
             layer_cache_spec(model.cfg, i, batch, seq_len, model.dtype).items()}
            for i in range(model.cfg.n_layers)]


def _kv_cache_entry(kv: Dict[str, torch.Tensor], layer_idx: int,
                    cfg: ModelConfig, batch: int, cache_seq_len: int,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A layer's decode-cache entry from its prefill state: k, v
    (B, S, Kv, hd) into their slots, or the Mamba layer's final conv and
    ssm states as they are."""
    out = {}
    for name, (shape, dt) in layer_cache_spec(cfg, layer_idx, batch,
                                              cache_seq_len, dtype).items():
        src = kv[name].to(dt)
        if name not in ("k", "v"):
            out[name] = src
            continue
        sc, full = shape[1], src.shape[1]
        if full >= sc:
            # ring-buffer layout: absolute position P lives in slot P % sc
            out[name] = torch.roll(src[:, -sc:], full % sc, dims=1)
        else:
            entry = torch.zeros(shape, dtype=dt, device=src.device)
            entry[:, :full] = src
            out[name] = entry
    return out


# ---------------------------------------------------------------------------
# prefill and decode
@torch.no_grad()
def prefill(model: DecoderLM, tokens: torch.Tensor, *,
            cache_seq_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt ``tokens`` (B, S) through every layer. Returns the
    last token's f32 logits (B, V) and the cache, sized for
    ``cache_seq_len`` tokens (default S)."""
    cfg = model.cfg
    B, Sq = tokens.shape
    cache_seq_len = cache_seq_len or Sq
    x = embed(model, tokens)
    positions = torch.arange(Sq, device=tokens.device)
    rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    cache = []
    for i, layer in enumerate(model.layers):
        x, kv = block_parallel(layer.weights(), x, layer.kind, layer.is_moe,
                               cfg, rope=rope, return_kv=True)
        cache.append(_kv_cache_entry(kv, i, cfg, B, cache_seq_len,
                                     model.dtype))
    return _logits(model, x[:, -1]), cache


@torch.no_grad()
def decode_step(model: DecoderLM, cache: Cache, tokens: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
    """One token ``tokens`` (B, 1) at position ``cache_len`` (a Python
    int: the number of tokens already in the cache). Updates ``cache`` in
    place and returns (f32 logits (B, V), cache)."""
    cfg = model.cfg
    x = embed(model, tokens)
    pos = torch.full((1,), cache_len, dtype=torch.int32, device=tokens.device)
    rope = rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
    for i, layer in enumerate(model.layers):
        x, cache[i] = block_decode(layer.weights(), x, cache[i], cache_len,
                                   layer.kind, layer.is_moe, cfg, rope=rope)
    return _logits(model, x[:, 0]), cache
