"""Single source of truth for parameter shapes (the JAX package's
``models/spec.py``, every layer kind).

``model_param_specs(cfg)`` returns the JAX package's parameter tree with a
shape tuple at each leaf; the port's random init, its numpy weights for the
tests, the analytic parameter count and the perf model's roofline all read
it.

Layer layout
------------
Layers are grouped into *superblocks* of ``period`` layers (the LCM of the
block pattern length, the MoE period and the cross-attention period).
Params of position ``p`` inside the superblock are stacked over the
``n_repeats`` superblocks (leading axis R); any remainder layers live
unstacked under ``tail``. Layer ``r * period + p`` is
``body[p][name][r]``; layer ``R * period + j`` is ``tail[j]``.

Every layer = mixer (attn / attn_local / cross / mamba / mlstm / slstm)
+ optional FFN (dense or MoE). ``d_ff == 0`` (xlstm) means no FFN: the
cells carry their own up/down projections. An encoder-decoder config
(whisper) adds the ``encoder`` stack and a cross-attention onto its memory
in every decoder layer (``xattn_body`` / ``xattn_tail``).

The port builds and serves every kind of layer above.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    CROSS,
    MAMBA,
    MLSTM,
    SLSTM,
    ModelConfig,
)

Shape = Tuple[int, ...]

def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def superblock_period(cfg: ModelConfig) -> int:
    p = len(cfg.block_pattern) if cfg.block_pattern else 1
    if cfg.moe.n_experts > 0:
        p = _lcm(p, cfg.moe.period)
    if cfg.cross_attn_period:
        p = _lcm(p, cfg.cross_attn_period)
    return p


def layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, n_repeats, n_tail) of the decoder stack."""
    period = superblock_period(cfg)
    n_repeats = cfg.n_layers // period
    n_tail = cfg.n_layers - n_repeats * period
    return period, n_repeats, n_tail


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def layer_kind_at(cfg: ModelConfig, layer_idx: int) -> str:
    kind = cfg.layer_kind(layer_idx)
    if cfg.cross_attn_period and (layer_idx % cfg.cross_attn_period) == (
        cfg.cross_attn_period - 1
    ):
        kind = CROSS
    return kind


def memory_input(cfg: ModelConfig) -> Tuple[Optional[str], int]:
    """The memory a prompt comes with: ``("audio", n_audio_frames)`` for
    an encoder-decoder (its encoder reads the frames), ``("vision",
    n_vision_tokens)`` for a VLM, ``(None, 0)`` for the others."""
    if cfg.enc_dec:
        return "audio", cfg.n_audio_frames
    if cfg.n_vision_tokens:
        return "vision", cfg.n_vision_tokens
    return None, 0


def attends_memory(cfg: ModelConfig, kind: str) -> bool:
    """Whether a decoder layer of ``kind`` attends to the memory: every
    layer of an encoder-decoder, a VLM's ``CROSS`` layers."""
    return cfg.enc_dec or kind == CROSS


def attention_calls(cfg: ModelConfig) -> int:
    """The attention calls of one prefill: one per self-attention layer
    (``CROSS`` layers included), one per layer that attends to the memory
    and one per encoder layer."""
    kinds = [layer_kind_at(cfg, i) for i in range(cfg.n_layers)]
    return (sum(k in (ATTN, ATTN_LOCAL, CROSS) for k in kinds)
            + sum(attends_memory(cfg, k) for k in kinds)
            + (cfg.n_enc_layers if cfg.enc_dec else 0))


def slstm_ff(cfg: ModelConfig) -> int:
    return int(round(cfg.d_model * 4 / 3 / 64)) * 64 or 64


def mixer_specs(cfg: ModelConfig, kind: str) -> Dict[str, Shape]:
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s: Dict[str, Shape] = {"ln1": (D,)}
    if kind in (ATTN, ATTN_LOCAL, CROSS):
        s.update(wq=(D, H * hd), wk=(D, Kv * hd), wv=(D, Kv * hd),
                 wo=(H * hd, D))
        if cfg.qk_norm:
            s.update(qn=(hd,), kn=(hd,))
        if kind == CROSS:
            s.update(lnx=(D,), xq=(D, H * hd), xk=(D, Kv * hd),
                     xv=(D, Kv * hd), xo=(H * hd, D), xgate=(1,))
    elif kind == MAMBA:
        di, ds, dc, dr = (d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv,
                          dt_rank(cfg))
        s.update(
            in_proj=(D, 2 * di),
            conv_w=(dc, di),
            conv_b=(di,),
            x_proj=(di, dr + 2 * ds),
            dt_w=(dr, di),
            dt_b=(di,),
            A_log=(di, ds),
            D_skip=(di,),
            out_proj=(di, D),
        )
    elif kind == MLSTM:
        di, nh = d_inner(cfg), cfg.n_heads
        s.update(up=(D, 2 * di), conv_w=(4, di), conv_b=(di,),
                 wq=(di, di), wk=(di, di), wv=(di, di), gi=(di, nh),
                 gf=(di, nh), ln_inner=(di,), down=(di, D))
    elif kind == SLSTM:
        nh = cfg.n_heads
        dh = D // nh
        ff = slstm_ff(cfg)
        s.update(w=(D, 4 * D), r=(nh, dh, 4 * dh), b=(4 * D,),
                 ln_inner=(D,), up=(D, 2 * ff), down=(ff, D))
    else:
        raise ValueError(f"unknown mixer kind {kind}")
    return s


def mlp_gated(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"   # whisper uses plain GELU MLPs


def ffn_specs(cfg: ModelConfig, is_moe: bool) -> Dict[str, Shape]:
    D, F = cfg.d_model, cfg.d_ff
    if F == 0:
        return {}
    s: Dict[str, Shape] = {"ln2": (D,)}
    if is_moe:
        E = cfg.moe.n_experts
        s.update(router=(D, E), e_wg=(E, D, F), e_wi=(E, D, F),
                 e_wo=(E, F, D))
    else:
        s.update(wi=(D, F), wo2=(F, D))
        if mlp_gated(cfg):
            s["wg"] = (D, F)
    return s


def layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Shape]:
    s = dict(mixer_specs(cfg, layer_kind_at(cfg, layer_idx)))
    s.update(ffn_specs(cfg, cfg.is_moe_layer(layer_idx)))
    return s


def _stack(specs: Dict[str, Shape], n: int) -> Dict[str, Shape]:
    return {k: (n,) + v for k, v in specs.items()}


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree, with shape tuples as leaves."""
    period, n_repeats, n_tail = layout(cfg)
    D = cfg.d_model
    specs: Dict[str, Any] = {"emb": (cfg.vocab, D), "final_ln": (D,)}
    if not cfg.tie_embeddings:
        specs["head"] = (D, cfg.vocab)
    specs["body"] = [_stack(layer_specs(cfg, p), n_repeats)
                     for p in range(period)] if n_repeats > 0 else []
    specs["tail"] = [
        layer_specs(cfg, n_repeats * period + j) for j in range(n_tail)
    ]
    if cfg.enc_dec:
        enc_layer = dict(mixer_specs(cfg, ATTN))
        enc_layer.update(ffn_specs(cfg, False))
        specs["encoder"] = {"layers": _stack(enc_layer, cfg.n_enc_layers),
                            "final_ln": (D,)}
        # decoder layers gain cross-attention onto encoder memory
        H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        xa = {"lnx": (D,), "xq": (D, H * hd), "xk": (D, Kv * hd),
              "xv": (D, Kv * hd), "xo": (H * hd, D)}
        if n_repeats > 0:
            specs["xattn_body"] = [_stack(xa, n_repeats)
                                   for _ in range(period)]
        specs["xattn_tail"] = [dict(xa) for _ in range(n_tail)]
    return specs


def leaves_with_names(specs: Dict[str, Any]):
    """``(name, shape)`` of every leaf in the JAX package's flatten order
    (dict keys sorted, lists in order); names are '/'-joined paths such as
    ``body/0/wq``."""
    out = []

    def visit(path: str, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                visit(f"{path}/{k}" if path else k, node[k])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(f"{path}/{i}" if path else str(i), v)
        else:
            out.append((path, node))

    visit("", specs)
    return out


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact element count of ``model_param_specs``; MoE experts scaled by
    top_k/n_experts when ``active_only`` (for MODEL_FLOPS = 6*N_active*D)."""
    total = 0
    for name, shape in leaves_with_names(model_param_specs(cfg)):
        n = math.prod(shape)
        if active_only and ("/e_w" in name
                            or name.endswith(("e_wg", "e_wi", "e_wo"))):
            n = n * cfg.moe.top_k // max(cfg.moe.n_experts, 1)
        total += n
    return total
