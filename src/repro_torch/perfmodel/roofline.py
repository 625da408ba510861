"""Analytic (Calculon-style) performance model over the assigned archs.

The JAX package's ``perfmodel/roofline.py``, reading the port's
``models.spec`` (shape tuples), with its arithmetic in the same order so
that every field is the same float64. Mirrors the models layer-by-layer:
matmul FLOPs from exact parameter shapes, attention FLOPs from
(causal/windowed) context length, SSM/LSTM recurrence FLOPs from state sizes; HBM bytes from the
FSDP/TP sharding layout (param gathers, optimizer state, saved residual
stream, logits chunks, KV caches); collective bytes from the parallelism
plan (FSDP gathers + grad reduction + TP/SP boundary collectives + MoE
all-to-all).

Its times are estimates for the modelled chip (``constants.V5E``), not
measurements of the card the port runs on. Consumer: the workload
generator (the paper's "synthetic workloads from performance modeling
tools": job duration and power for the RAPS twin).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    CROSS,
    MAMBA,
    MLSTM,
    SLSTM,
    ModelConfig,
    ShapeConfig,
)
from repro_torch.models import spec as S
from repro_torch.perfmodel.constants import V5E, Chip


@dataclass
class RooflineEstimate:
    flops_per_dev: float
    bytes_per_dev: float
    collective_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    dominant: str
    util: float                 # compute_s / step_s
    chip_power_w: float

    def terms(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s}


def _layer_param_count(cfg: ModelConfig, p: int, active: bool) -> float:
    import numpy as np

    specs = S.layer_specs(cfg, p)
    total = 0.0
    for name, shape in specs.items():
        n = float(np.prod(shape))
        if name.startswith("e_w") and active:
            n *= cfg.moe.top_k / max(cfg.moe.n_experts, 1)
        total += n
    return total


def _attn_ctx(cfg: ModelConfig, kind: str, shape: ShapeConfig) -> float:
    """Mean attended context length per query token."""
    s = shape.seq_len
    window = cfg.swa_window if (
        kind == ATTN_LOCAL or (cfg.block_pattern is None and cfg.swa_window)
    ) else 0
    if shape.mode == "decode":
        full = min(s, window) if window else s
        return float(full)
    ctx = s / 2.0
    if window:
        ctx = min(ctx, float(window))
    return ctx


def _layer_flops_per_token(cfg: ModelConfig, p: int, shape: ShapeConfig) -> float:
    """Forward FLOPs per token for layer position p."""
    kind = S.layer_kind_at(cfg, p)
    f = 2.0 * _layer_param_count(cfg, p, active=True)   # matmuls: 2*N
    if kind in (ATTN, ATTN_LOCAL, CROSS):
        ctx = _attn_ctx(cfg, kind, shape)
        f += 4.0 * cfg.n_heads * cfg.hd * ctx           # qk^T + pv
        if kind == CROSS:
            f += 4.0 * cfg.n_heads * cfg.hd * cfg.n_vision_tokens
    if cfg.enc_dec:
        f += 4.0 * cfg.n_heads * cfg.hd * cfg.n_audio_frames
    if kind == MAMBA:
        di, ds = S.d_inner(cfg), cfg.ssm.d_state
        f += 10.0 * di * ds                             # scan update + y
    if kind in (MLSTM,):
        di = S.d_inner(cfg)
        nh = cfg.n_heads
        dh = di // nh
        f += 8.0 * nh * dh * dh                         # state update + read
    if kind == SLSTM:
        f += 12.0 * cfg.d_model
    return f


def analytic_roofline(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    n_chips: int = 256,
    tp: int = 16,
    chip: Chip = V5E,
    remat: bool = True,
    efficiency: float = 0.6,
) -> RooflineEstimate:
    dp = n_chips // tp
    mode = shape.mode
    tokens = shape.global_batch * (1 if mode == "decode" else shape.seq_len)

    fwd = sum(
        _layer_flops_per_token(cfg, p, shape) for p in range(cfg.n_layers)
    )
    # embedding + head
    fwd += 2.0 * cfg.d_model * cfg.vocab
    if cfg.enc_dec and mode != "decode":
        enc_tokens_ratio = cfg.n_audio_frames / max(shape.seq_len, 1)
        fwd *= (1 + 0.5 * enc_tokens_ratio)  # encoder ~ half the stack depth

    # fwd already counts 2*N per token; train = fwd + bwd (2x fwd) +
    # remat recompute (1x fwd) => 4x fwd total (the "8*N*D" of 6*N*D fame)
    if mode == "train":
        total_flops = fwd * tokens * (4.0 if remat else 3.0)
    else:
        total_flops = fwd * tokens

    flops_dev = total_flops / n_chips

    # ---- HBM bytes per device
    n_params = cfg.param_count()
    p_bytes = 0.0
    if mode == "train":
        # ZeRO-3: fp32 shard rw + 2x bf16 gathered use (fwd+bwd) + grads
        opt_mult = 12.0 if n_params < 100e9 else 4.5    # adamw vs adafactor
        p_bytes += n_params * (4.0 + opt_mult) / n_chips
        p_bytes += 2.0 * n_params * 2.0 / tp            # gathered bf16 reads
        # saved residual stream (sequence-parallel sharded)
        act = (shape.global_batch / dp) * shape.seq_len * cfg.d_model * 2.0
        p_bytes += cfg.n_layers * act / tp * 3.0        # save + 2 reads
        # logits chunks
        p_bytes += (shape.global_batch / dp) * shape.seq_len * cfg.vocab * 4.0 / tp
    else:
        p_bytes += n_params * 2.0 / n_chips * (2.0 if mode == "prefill" else 1.0)
        if mode == "decode":
            # read the whole KV cache (+ recurrent states) once per token
            kv = 0.0
            for p in range(cfg.n_layers):
                kind = S.layer_kind_at(cfg, p)
                if kind in (ATTN, ATTN_LOCAL, CROSS):
                    sc = min(shape.seq_len, cfg.swa_window) if (
                        kind == ATTN_LOCAL or
                        (cfg.block_pattern is None and cfg.swa_window)
                    ) else shape.seq_len
                    kv += 2.0 * sc * cfg.n_kv_heads * cfg.hd * 2.0
                if kind == MAMBA:
                    kv += S.d_inner(cfg) * cfg.ssm.d_state * 4.0 * 2.0
                if kind in (MLSTM,):
                    kv += S.d_inner(cfg) * (S.d_inner(cfg) // cfg.n_heads) * 4.0
            p_bytes += shape.global_batch * kv / n_chips
        else:
            act = (shape.global_batch / dp) * shape.seq_len * cfg.d_model * 2.0
            p_bytes += cfg.n_layers * act / tp * 2.0

    # ---- collective bytes per device
    coll = 0.0
    if mode == "train":
        coll += 2.0 * n_params * 2.0 / tp               # FSDP all-gather x2
        coll += n_params * 4.0 / tp                     # grad reduce (dp)
        # TP/SP boundary: ~4 (B,S,D) reshards per layer
        bsd = (shape.global_batch / dp) * shape.seq_len * cfg.d_model * 2.0
        coll += 4.0 * cfg.n_layers * bsd / tp
        if cfg.moe.n_experts:
            moe_layers = cfg.n_layers // cfg.moe.period
            coll += (2.0 * moe_layers * bsd * cfg.moe.top_k * 1.25) / tp
    elif mode == "prefill":
        coll += n_params * 2.0 / tp
        bsd = (shape.global_batch / dp) * shape.seq_len * cfg.d_model * 2.0
        coll += 2.0 * cfg.n_layers * bsd / tp
    else:
        coll += n_params * 2.0 / tp                     # weight gathers
        bd = shape.global_batch * cfg.d_model * 2.0 / dp
        coll += 3.0 * cfg.n_layers * bd

    compute_s = flops_dev / (chip.peak_flops_bf16 * efficiency)
    memory_s = p_bytes / chip.hbm_bw
    collective_s = coll / chip.ici_bw
    step_s = max(compute_s, memory_s, collective_s)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    util = compute_s / max(step_s, 1e-12)
    power = chip.idle_w + util * chip.dyn_w
    return RooflineEstimate(
        flops_per_dev=flops_dev,
        bytes_per_dev=p_bytes,
        collective_bytes_per_dev=coll,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        step_s=step_s,
        dominant=dominant,
        util=util,
        chip_power_w=power,
    )
