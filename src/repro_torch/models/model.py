"""Model assembly of the LMs (the JAX package's ``models/model.py``):
embedding -> decoder layers -> final norm -> head, with prefill and
one-token decode over explicit caches; an encoder-decoder (whisper) runs
its encoder over the audio frames first, and its decoder layers attend to
the encoder's output.

``DecoderLM`` holds the f32 master weights: the embedding, the final norm,
the untied head if any, and a ``ModuleList`` of ``DecoderLayer`` in layer
order (each with its ``xattn`` weights in an encoder-decoder), and the
``Encoder`` of an encoder-decoder. The JAX package casts each master to
``cfg.dtype`` at every use; the port makes those copies once, at load,
which gives the same values (norm scales, ``A_log``, the MoE router and
the sLSTM's ``r`` and ``b`` stay f32, as the JAX package reads them in
f32).

The memory a model attends to comes with the prompt (``extras``, as in the
JAX package's batch): ``"vision"`` (B, n_vision_tokens, D), taken as it is
in the compute dtype by a VLM's ``CROSS`` layers, or ``"audio"`` (B,
n_audio_frames, D), the frames an encoder-decoder's encoder reads.

The cache is a list with one entry per layer. An attention layer's is
``{"k", "v"}``, each (B, S_c, Kv, hd) in the compute dtype; a
sliding-window layer keeps ``min(cache_seq_len, window)`` slots as a ring
(absolute position P in slot P % S_c). A layer that attends to a memory
adds ``{"xk", "xv"}`` (B, M, Kv, hd), written at prefill and only read by
decode. A Mamba layer's is ``{"conv" (B, d_conv - 1, di), "ssm" (B, di,
d_state)}``, an mLSTM's ``{"C", "n", "m", "conv"}`` and an sLSTM's ``{"c",
"n", "h", "m"}`` (``xlstm``), all f32. ``cache_len`` is a Python int
everywhere, so prefill and decode never read the device.

Training does not use ``DecoderLM``: ``forward_train`` takes the JAX
package's stacked parameter tree itself (the train state's ``params``),
reads per-layer views of its leaves (``layer_leaves``) and casts each at
its use inside autograd, so the gradients are the stacked leaves' and
land in the f32 masters; ``prefill`` and ``decode_step`` record no
gradient. On a mesh the tree's leaves and the batch are DTensors
(``sharding.specs.distribute``) and ``forward_train`` runs as DTensor
operations, constrained by its ``ShardCtx`` where the JAX package
constrains: the embedding's output and the residual stream to (dp, sp,
None), q, k and v by their heads (``blocks``), the logits to (dp, None,
tp).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor

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
from repro_torch.models.blocks import (
    block_decode,
    block_forward,
    block_parallel,
    layer_window,
)
from repro_torch.models.init import NORMS
from repro_torch.models.layers import normed, rms_norm, rope_cos_sin
from repro_torch.models.mamba import mamba_cache_spec
from repro_torch.models.xlstm import mlstm_cache_spec, slstm_cache_spec
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx

# read in f32 from the masters by the JAX package
F32_LEAVES = NORMS + ("A_log", "router", "r", "b")

Cache = List[Dict[str, torch.Tensor]]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Weights(nn.Module):
    """Leaves' f32 master weights, by the JAX package's names, and their
    compute-dtype copies (``weights()``)."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], dtype: torch.dtype):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.dtype = dtype
        self._weights: Optional[Dict[str, torch.Tensor]] = None

    def weights(self) -> Dict[str, torch.Tensor]:
        """The ``F32_LEAVES`` as the f32 masters; every other leaf in the
        compute dtype (the masters themselves when that is f32), made at
        first call."""
        if self._weights is None:
            self._weights = {
                name: p if name in F32_LEAVES else p.to(self.dtype)
                for name, p in self.named_parameters(recurse=False)}
        return self._weights

    def _apply(self, fn, recurse=True):
        self._weights = None   # moved or cast masters: copies are remade
        return super()._apply(fn, recurse)


class DecoderLayer(Weights):
    """One layer's weights; ``kind`` is its mixer, ``is_moe`` whether its
    FFN is the experts (``cfg.is_moe_layer``), ``xattn`` an
    encoder-decoder's cross-attention weights onto the encoder's output
    (None elsewhere)."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], kind: str,
                 is_moe: bool, dtype: torch.dtype,
                 xattn: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__(leaves, dtype)
        self.kind = kind
        self.is_moe = is_moe
        self.xattn = None if xattn is None else Weights(xattn, dtype)

    def xattn_weights(self) -> Optional[Dict[str, torch.Tensor]]:
        return None if self.xattn is None else self.xattn.weights()


def _stacked(tree: Mapping[str, Any], i: int,
             period: int, R: int, body: str, tail: str) -> Dict[str, Any]:
    """Layer ``i``'s leaves of a stacked tree: ``tree[body][i % period]
    [name][i // period]`` for the R superblocks, ``tree[tail][i - R *
    period]`` after them."""
    if i < R * period:
        return {k: t[i // period] for k, t in tree[body][i % period].items()}
    return tree[tail][i - R * period]


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``n_enc_layers`` non-causal attention
    layers with the plain MLP (the JAX package's ``encoder["layers"]``,
    stacked over layers) and their final norm."""

    def __init__(self, cfg: ModelConfig, tree: Mapping[str, Any],
                 dtype: torch.dtype):
        super().__init__()
        self.final_ln = nn.Parameter(tree["final_ln"], requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer({k: t[i] for k, t in tree["layers"].items()}, ATTN,
                         False, dtype)
            for i in range(cfg.n_enc_layers))


class DecoderLM(nn.Module):
    """An LM built from the JAX package's parameter tree (``from_tree``):
    decoder-only, or with an encoder (``cfg.enc_dec``)."""

    def __init__(self, cfg: ModelConfig, tree: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.emb = nn.Parameter(tree["emb"], requires_grad=False)
        self.final_ln = nn.Parameter(tree["final_ln"], requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(tree["head"], requires_grad=False)
        period, R, _ = S.layout(cfg)
        self.encoder = (Encoder(cfg, tree["encoder"], self.dtype)
                        if cfg.enc_dec else None)
        self.layers = nn.ModuleList(
            DecoderLayer(_stacked(tree, i, period, R, "body", "tail"),
                         S.layer_kind_at(cfg, i), cfg.is_moe_layer(i),
                         self.dtype,
                         _stacked(tree, i, period, R, "xattn_body",
                                  "xattn_tail") if cfg.enc_dec else None)
            for i in range(cfg.n_layers))
        self._head: Optional[torch.Tensor] = None

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: Mapping[str, Any]) -> "DecoderLM":
        """Build from f32 tensors in the JAX package's layout (``body[p]
        [name][r]`` is layer ``r * period + p``, ``tail[j]`` layer ``R *
        period + j``; ``xattn_body`` / ``xattn_tail`` likewise, and
        ``encoder["layers"][name][i]``), and make the compute-dtype copies
        now."""
        model = cls(cfg, tree)
        model.head_weights()
        for layer in model.modules():
            if isinstance(layer, Weights):
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
    of an attention layer (with ``{"xk", "xv"}`` onto the memory on a
    ``CROSS`` layer and on every layer of an encoder-decoder), or the
    Mamba, mLSTM or sLSTM layer's states."""
    kind = S.layer_kind_at(cfg, layer_idx)
    Kv, hd = cfg.n_kv_heads, cfg.hd
    if kind == MAMBA:
        spec = mamba_cache_spec(cfg, batch)
    elif kind == MLSTM:
        spec = mlstm_cache_spec(cfg, batch)
    elif kind == SLSTM:
        spec = slstm_cache_spec(cfg, batch)
    else:
        shape = (batch, _attn_cache_len(cfg, kind, seq_len), Kv, hd)
        spec = {"k": (shape, dtype), "v": (shape, dtype)}
    _, memory = S.memory_input(cfg)
    if memory and S.attends_memory(cfg, kind):
        shape = (batch, memory, Kv, hd)
        spec.update(xk=(shape, dtype), xv=(shape, dtype))
    return spec


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    """The decode caches in the JAX package's stacked layout (``body[p]``
    each layer leaf with the R superblocks on a leading axis, ``tail[j]``
    as it is), as tensors on the ``meta`` device (never allocated): what
    ``sharding.specs.cache_pspecs`` mirrors."""
    dtype = compute_dtype(cfg)
    period, R, n_tail = S.layout(cfg)

    def meta(i: int, lead: tuple) -> Dict[str, torch.Tensor]:
        return {name: torch.empty(lead + tuple(shape), dtype=dt,
                                  device="meta")
                for name, (shape, dt) in
                layer_cache_spec(cfg, i, batch, seq_len, dtype).items()}

    return {"body": [meta(p, (R,)) for p in range(period)] if R else [],
            "tail": [meta(R * period + j, ()) for j in range(n_tail)]}


def init_cache(model: DecoderLM, batch: int, seq_len: int) -> Cache:
    return [{name: torch.zeros(shape, dtype=dt, device=model.device)
             for name, (shape, dt) in
             layer_cache_spec(model.cfg, i, batch, seq_len, model.dtype).items()}
            for i in range(model.cfg.n_layers)]


def _kv_cache_entry(kv: Dict[str, torch.Tensor], layer_idx: int,
                    cfg: ModelConfig, batch: int, cache_seq_len: int,
                    dtype: torch.dtype,
                    pspecs: Optional[Dict[str, tuple]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A layer's decode-cache entry from its prefill state: k, v
    (B, S, Kv, hd) into their slots; the cross-attention's xk, xv and the
    recurrent layers' final states as they are. DTensor k and v (whole
    over the sequence on every rank) become DTensor entries laid out by
    ``pspecs`` (the layer's ``sharding.specs.layer_cache_pspecs``): each
    rank places its own slots of the prompt, and the entry is
    redistributed once to the cache's layout."""
    out = {}
    for name, (shape, dt) in layer_cache_spec(cfg, layer_idx, batch,
                                              cache_seq_len, dtype).items():
        src = kv[name].to(dt)
        if name not in ("k", "v"):
            out[name] = src
        elif isinstance(src, DTensor):
            out[name] = _kv_entry_mesh(src, shape, pspecs[name])
        else:
            out[name] = _slots(src, shape)
    return out


def _slots(src: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The prompt's k or v (B, S, Kv, hd) in a cache of ``shape`` (B, S_c,
    Kv, hd): the first S slots, or, where S >= S_c, a ring holding the
    last S_c positions with absolute position P in slot P % S_c."""
    sc, full = shape[1], src.shape[1]
    if full >= sc:
        return torch.roll(src[:, -sc:], full % sc, dims=1)
    entry = torch.zeros(shape, dtype=src.dtype, device=src.device)
    entry[:, :full] = src
    return entry


def _kv_entry_mesh(src, shape: tuple, spec: tuple):
    """``_slots`` of a DTensor ``src`` whose sequence is whole on every
    rank, then redistributed to ``spec``'s placements. A split that does
    not divide its dim (a ring of S_c slots over more ranks than divide
    it, Kv over a larger axis) takes DTensor's uneven cut: the first
    ranks hold ceil(S_c / n) slots, the last fewer or none, and
    ``blocks.write_slot`` and ``layers.decode_attention_mesh`` read the
    same cut."""
    from repro_torch.models.layers import dtensor_from_local
    from repro_torch.sharding.specs import placements

    mesh, local = src.device_mesh, src.to_local()
    entry = dtensor_from_local(
        _slots(local, (local.shape[0], shape[1]) + tuple(local.shape[2:])),
        mesh, tuple(src.placements), shape)
    return entry.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# prefill and decode
def encode(layers, final_ln: torch.Tensor, frames: torch.Tensor,
           cfg: ModelConfig, dtype: torch.dtype,
           remat: bool = False, ctx: ShardCtx = UNSHARDED) -> torch.Tensor:
    """An encoder-decoder's encoder over the audio frames (B, F, D) (the
    frontend is a stub: the frames are embeddings already): non-causal
    attention layers (``layers``: each layer's weights) with RoPE over
    positions 0..F-1, then the final norm. With ``remat`` each layer is
    recomputed in the backward pass. Returns (B, F, D) in ``dtype``; on
    a mesh the frames' stream is laid out (dp, sp, None) as the
    decoder's, and the output (dp, None, None), as the memory its
    cross-attentions read."""
    x = ctx.constrain(frames.to(dtype), "dp", "sp", None)
    positions = torch.arange(frames.shape[1], device=frames.device)
    rope = tuple(_replicated_like(t, x) for t in rope_cos_sin(
        positions, cfg.hd, cfg.rope_theta))

    def layer(w, x):
        return block_forward(w, x, ATTN, False, cfg, rope=rope,
                             causal=False, ctx=ctx)[0]

    for w in layers:
        x = _checkpointed(layer, w, x) if remat else layer(w, x)
    return normed(x, final_ln, cfg.norm_eps, ctx)


def encoder_forward(model: DecoderLM, frames: torch.Tensor) -> torch.Tensor:
    """The model's encoder (``encode``) on its compute-dtype copies."""
    enc = model.encoder
    return encode([layer.weights() for layer in enc.layers], enc.final_ln,
                  frames, model.cfg, model.dtype)


def memory_of(model: DecoderLM, extras: Optional[Mapping[str, torch.Tensor]]
              ) -> Optional[torch.Tensor]:
    """The memory the model's layers attend to: the encoder's output over
    ``extras["audio"]`` for an encoder-decoder, ``extras["vision"]`` in
    the compute dtype for a VLM, None for the others."""
    cfg = model.cfg
    need, _ = S.memory_input(cfg)
    if need is None:
        return None
    if not extras or need not in extras:
        raise ValueError(f"{cfg.name} attends to a memory: pass "
                         f'extras={{"{need}": (B, M, {cfg.d_model}) tensor}}')
    if cfg.enc_dec:
        return encoder_forward(model, extras[need])
    return extras[need].to(model.dtype)


def check_mesh_serving(cfg: ModelConfig, ctx: ShardCtx) -> None:
    """Refuse prefill and decode of a family that does not serve on a
    mesh yet: under an enabled ``ctx`` the port serves the dense family
    alone (self-attention layers, global or windowed, with the dense
    MLP)."""
    if not ctx.enabled:
        return
    kinds = {S.layer_kind_at(cfg, i) for i in range(cfg.n_layers)}
    other = ([k for k in sorted(kinds) if k not in (ATTN, ATTN_LOCAL)]
             + (["moe"] if any(cfg.is_moe_layer(i)
                               for i in range(cfg.n_layers)) else [])
             + (["encoder-decoder"] if cfg.enc_dec else []))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: prefill and decode on a mesh serve the dense "
            f"family only, not {', '.join(other)} layers; serving the MoE, "
            "Mamba, xLSTM, cross-attention and encoder-decoder families on "
            "a mesh is the next item of ROADMAP.md queue 1 (run them with "
            "ctx=UNSHARDED on one device)")


def _decode_ctx(ctx: ShardCtx) -> ShardCtx:
    """The context of a decode step: no sequence to split (the residual
    stream is one token), and under ``decode_kv_shard="seq2d"`` (a batch
    too small to split) no batch split either, as the tokens'
    ``batch_pspecs``."""
    if not ctx.enabled:
        return ctx
    return ctx.with_(seq_parallel=False,
                     dp=() if ctx.decode_kv_shard == "seq2d" else ctx.dp)


def _last_logits(model: DecoderLM, x, ctx: ShardCtx) -> torch.Tensor:
    """The f32 logits (B, V) of position ``-1`` of x (B, S, D): on a mesh
    x is whole over the sequence first and the logits are laid out (dp,
    tp), as the JAX package constrains them."""
    x = ctx.constrain(x, "dp", None, None)
    return ctx.constrain(_logits(model, x[:, -1]), "dp", "tp")


@torch.no_grad()
def prefill(model: DecoderLM, tokens: torch.Tensor, *,
            cache_seq_len: Optional[int] = None,
            extras: Optional[Mapping[str, torch.Tensor]] = None,
            ctx: ShardCtx = UNSHARDED) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt ``tokens`` (B, S) through every layer, with the
    memory of ``extras`` (``memory_of``) where the model has one. Returns
    the last token's f32 logits (B, V) and the cache, sized for
    ``cache_seq_len`` tokens (default S).

    On a mesh (an enabled ``ctx``; the dense family, ``check_mesh_serving``)
    the model's weights are DTensors laid out by ``param_pspecs`` and
    ``tokens`` a DTensor laid out by ``batch_pspecs``: the layers run as in
    the training forward (the attention on each rank's local heads,
    ``layers.local_attention``), and the cache comes laid out by
    ``sharding.specs.layer_cache_pspecs``."""
    check_mesh_serving(model.cfg, ctx)
    cfg = model.cfg
    B, Sq = tokens.shape
    cache_seq_len = cache_seq_len or Sq
    memory = memory_of(model, extras)
    x = ctx.constrain(embed(model, tokens), "dp", "sp", None)
    positions = torch.arange(Sq, device=tokens.device)
    rope = tuple(_replicated_like(t, x) for t in rope_cos_sin(
        positions, cfg.hd, cfg.rope_theta))
    if ctx.enabled:
        from repro_torch.sharding.specs import layer_cache_pspecs

        specs = layer_cache_pspecs(cfg, ctx)
    else:
        specs = [None] * cfg.n_layers
    cache = []
    for i, layer in enumerate(model.layers):
        x, kv = block_parallel(layer.weights(), x, layer.kind, layer.is_moe,
                               cfg, rope=rope, memory=memory,
                               xa=layer.xattn_weights(), return_kv=True,
                               ctx=ctx)
        cache.append(_kv_cache_entry(kv, i, cfg, B, cache_seq_len,
                                     model.dtype, specs[i]))
    return _last_logits(model, x, ctx), cache


@torch.no_grad()
def decode_step(model: DecoderLM, cache: Cache, tokens: torch.Tensor,
                cache_len: int, ctx: ShardCtx = UNSHARDED
                ) -> Tuple[torch.Tensor, Cache]:
    """One token ``tokens`` (B, 1) at position ``cache_len`` (a Python
    int: the number of tokens already in the cache). Updates ``cache`` in
    place and returns (f32 logits (B, V), cache). On a mesh the cache's
    leaves are DTensors that keep their layout: each rank writes the new
    token's k and v into its own slots, and the attention is the
    distributed flash-decode (``layers.decode_attention_mesh``)."""
    check_mesh_serving(model.cfg, ctx)
    cfg = model.cfg
    ctx = _decode_ctx(ctx)
    x = ctx.constrain(embed(model, tokens), "dp", None, None)
    pos = torch.full((1,), cache_len, dtype=torch.int32, device=tokens.device)
    rope = tuple(_replicated_like(t, x) for t in rope_cos_sin(
        pos, cfg.hd, cfg.rope_theta))
    for i, layer in enumerate(model.layers):
        x, cache[i] = block_decode(layer.weights(), x, cache[i], cache_len,
                                   layer.kind, layer.is_moe, cfg, rope=rope,
                                   xa=layer.xattn_weights(), ctx=ctx)
    return _last_logits(model, x, ctx), cache


def batch_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """The dry-run's inputs of ``shape`` (a ``configs.ShapeConfig``) as
    tensors on the ``meta`` device (the JAX package's ``batch_specs``, its
    ShapeDtypeStructs): train and prefill tokens (with labels for train,
    and the VLM's or whisper's memory), or a decode step's one token,
    cache (``cache_specs``) and cache length."""
    B, Sq = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.mode in ("train", "prefill"):
        out = {"tokens": meta((B, Sq))}
        if shape.mode == "train":
            out["labels"] = meta((B, Sq))
        if cfg.n_vision_tokens:
            out["vision"] = meta((B, cfg.n_vision_tokens, cfg.d_model),
                                 compute_dtype(cfg))
        if cfg.enc_dec:
            out["audio"] = meta((B, cfg.n_audio_frames, cfg.d_model),
                                compute_dtype(cfg))
        return out
    return {"tokens": meta((B, 1)), "cache": cache_specs(cfg, B, Sq),
            "cache_len": meta(())}


# ---------------------------------------------------------------------------
# training forward and loss, over the JAX package's stacked tree
def _checkpointed(fn, *args):
    """``fn(*args)`` recomputed in the backward pass instead of saved
    (non-reentrant: tensors ``fn`` closes over get their gradients)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _at_use(w: Mapping[str, torch.Tensor], dtype: torch.dtype
            ) -> Dict[str, torch.Tensor]:
    """A layer's leaves as its layer code reads them: the ``F32_LEAVES``
    as they come, every other leaf in ``dtype`` (the JAX package's casts
    at use)."""
    return {k: t if k in F32_LEAVES or t.dtype == dtype else t.to(dtype)
            for k, t in w.items()}


def _replicated_like(t: torch.Tensor, ref) -> Any:
    """``t`` replicated on ``ref``'s mesh where ``ref`` is a DTensor (the
    RoPE tables beside a DTensor stream), else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _unstacked(tree: Mapping[str, Any]) -> Dict[str, List[torch.Tensor]]:
    """A stacked leaf dict as name -> its per-repeat views (one ``unbind``
    a leaf, whose backward stacks the repeats' gradients in one copy)."""
    return {k: torch.unbind(t, 0) for k, t in tree.items()}


def layer_leaves(params: Mapping[str, Any], cfg: ModelConfig,
                 body: str = "body", tail: str = "tail"
                 ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of a stacked parameter tree, in layer order: layer
    ``r * period + p`` reads ``params[body][p][name][r]``, layer ``R *
    period + j`` reads ``params[tail][j]`` (``xattn_body`` /
    ``xattn_tail`` for an encoder-decoder's cross-attentions)."""
    period, R, n_tail = S.layout(cfg)
    views = [_unstacked(d) for d in params.get(body) or []]
    out = [{k: v[r] for k, v in views[p].items()}
           for r in range(R) for p in range(period)]
    return out + [dict(params[tail][j]) for j in range(n_tail)]


def _label_logits(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, cs, 1) logits of the labels ``idx`` (B, cs) in ``logits`` (B,
    cs, V). On a mesh (logits whole over the vocabulary, laid out as the
    labels) each rank gathers its own rows: DTensor's gather backward
    would make the whole (B, cs, V) gradient on every rank
    (``new_zeros`` of the global shape)."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx[..., None])
    from repro_torch.models.layers import dtensor_from_local

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    if tuple(idx.placements) != pl:
        idx = idx.redistribute(mesh, pl)
    local = torch.gather(logits.to_local(), -1, idx.to_local()[..., None])
    return dtensor_from_local(local, mesh, pl, tuple(idx.shape) + (1,))


def lm_loss_chunked(xf: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    ctx: ShardCtx = UNSHARDED
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed token losses, counted tokens) of the final hidden states xf
    (B, S, D) under the head w (D, V), ``-1`` labels ignored. The logits
    of one ``ctx.logit_chunk`` of the sequence exist at a time: each
    chunk's are recomputed in the backward pass."""
    Sq = xf.shape[1]
    cs = min(ctx.logit_chunk, Sq)
    if Sq % cs:
        raise ValueError(f"sequence {Sq} is not a multiple of the logit "
                         f"chunk {cs}")

    def one(xc, w, lc):
        logits = (xc @ w.to(xc.dtype)).float()             # (B, cs, V)
        logits = ctx.constrain(logits, "dp", None, "tp")
        # the log-sum-exp and the label's logit read whole vocabulary rows
        logits = ctx.constrain(logits, "dp", None, None)
        lse = torch.logsumexp(logits, dim=-1)
        ll = _label_logits(logits, torch.clamp(lc, min=0))
        valid = (lc >= 0).float()
        return torch.sum((lse - ll[..., 0]) * valid), torch.sum(valid)

    losses, counts = zip(*(
        _checkpointed(one, xf[:, c:c + cs], w, labels[:, c:c + cs].long())
        for c in range(0, Sq, cs)))
    return torch.sum(torch.stack(losses)), torch.sum(torch.stack(counts))


def forward_train(params: Mapping[str, Any], batch: Mapping[str, Any],
                  cfg: ModelConfig, ctx: ShardCtx = UNSHARDED
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss (the JAX package's ``forward_train``) of
    ``batch`` (``tokens``, ``labels`` (B, S), ``-1`` labels ignored; and
    ``vision`` or ``audio`` where the model attends to a memory) under
    ``params``, the JAX package's stacked tree of tensors (or DTensors on
    a mesh), which autograd differentiates leaf by leaf. Each leaf is cast
    to ``cfg.dtype`` where it is used, ``F32_LEAVES`` excepted.
    Recomputation follows ``ctx.remat``. Returns (loss + load_balance_coef
    * aux / n_layers, {"loss", "moe_aux", "tokens"})."""
    dtype = compute_dtype(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["emb"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1).to(dtype)
    x = ctx.constrain(x, "dp", "sp", None)
    rope = tuple(_replicated_like(t, x) for t in rope_cos_sin(
        torch.arange(tokens.shape[1], device=tokens.device), cfg.hd,
        cfg.rope_theta))
    memory = None
    if cfg.enc_dec:
        enc = params["encoder"]
        n_enc = enc["layers"]["ln1"].shape[0]
        views = _unstacked(enc["layers"])
        memory = encode([_at_use({k: v[i] for k, v in views.items()}, dtype)
                         for i in range(n_enc)], enc["final_ln"],
                        batch["audio"], cfg, dtype,
                        remat=ctx.remat == "block", ctx=ctx)
    elif cfg.n_vision_tokens:
        memory = ctx.constrain(batch["vision"].to(dtype), "dp", None, None)

    period, R, _ = S.layout(cfg)
    layers = layer_leaves(params, cfg)
    xattn = (layer_leaves(params, cfg, "xattn_body", "xattn_tail")
             if cfg.enc_dec else [None] * cfg.n_layers)

    def layer(i: int, x):
        xa = xattn[i]
        return block_forward(
            _at_use(layers[i], dtype), x, S.layer_kind_at(cfg, i),
            cfg.is_moe_layer(i), cfg, rope=rope, memory=memory,
            xa=None if xa is None else _at_use(xa, dtype), ctx=ctx)[:2]

    def run(lo: int, hi: int, x, aux):
        for i in range(lo, hi):
            if ctx.remat == "layer" and i < R * period:
                x, a = _checkpointed(lambda x, i=i: layer(i, x), x)
            else:
                x, a = layer(i, x)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    aux = None     # the MoE layers' sum (a DTensor on a mesh), if any
    for r in range(R):
        lo, hi = r * period, (r + 1) * period
        if ctx.remat == "block":
            x, aux = _checkpointed(lambda x, aux, lo=lo, hi=hi:
                                   run(lo, hi, x, aux), x, aux)
        else:
            x, aux = run(lo, hi, x, aux)
    x, aux = run(R * period, cfg.n_layers, x, aux)
    xf = normed(x, params["final_ln"], cfg.norm_eps, ctx)
    head = params["emb"].T if cfg.tie_embeddings else params["head"]
    total, count = lm_loss_chunked(xf, head, labels, ctx)
    loss = total / torch.clamp(count, min=1.0)
    if aux is None:
        return loss, {"loss": loss, "moe_aux": torch.zeros_like(loss),
                      "tokens": count}
    full = loss + cfg.moe.load_balance_coef * aux / max(cfg.n_layers, 1)
    return full, {"loss": loss, "moe_aux": aux, "tokens": count}
