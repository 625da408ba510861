"""Model / shape configuration dataclasses, copied field for field from
the JAX package's ``configs/base.py``, so that ``reduced()`` gives the same
config in both packages.

Every architecture file of the port (``src/repro_torch/configs/<id>.py``)
builds a :class:`ModelConfig`; the four input shapes are :data:`SHAPES`.
``reduced()`` derives the CPU-smoke-test variant of any config (same block
structure, tiny widths). The port registers all ten archs: the perf
model (``repro_torch.perfmodel``) counts every one of them, and the port
builds and serves every one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from repro_torch.utils.registry import Registry

# ---------------------------------------------------------------------------
# Block kinds (per-layer). Hybrid archs interleave these.
ATTN = "attn"            # self-attention (GQA; optional sliding window)
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MAMBA = "mamba"          # selective-state-space block
SLSTM = "slstm"          # xLSTM sLSTM block
MLSTM = "mlstm"          # xLSTM mLSTM block
CROSS = "cross"          # cross-attention (VLM / enc-dec decoder)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    # every `period` layers are MoE (1 = all layers MoE); jamba uses 2.
    period: int = 1
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25   # tokens kept per expert = cf * T*k/E


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256     # chunked-scan block size (Pallas tile)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention details
    rope_theta: float = 1e4
    qk_norm: bool = False
    swa_window: int = 0              # 0 = full attention
    # per-layer pattern; None -> all ATTN. Entry i gives layer i's kind
    # (cycled if shorter than n_layers).
    block_pattern: Optional[Tuple[str, ...]] = None
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # VLM: a cross-attention layer after every `cross_attn_period` layers.
    cross_attn_period: int = 0
    n_vision_tokens: int = 0         # stub frontend: precomputed patch embeds
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_audio_frames: int = 0          # stub frontend: precomputed frame embeds
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"
    # notes for DESIGN/EXPERIMENTS tables
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        if self.block_pattern is None:
            return ATTN
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    def is_moe_layer(self, i: int) -> bool:
        if self.moe.n_experts == 0:
            return False
        return (i % self.moe.period) == (self.moe.period - 1)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode without a dense KV scan.

        SSM/hybrid archs and sliding-window-attention archs qualify; pure
        full-attention archs do not (long_500k is SKIPped for them).
        """
        kinds = set(self.layer_kinds())
        if kinds & {MAMBA, SLSTM, MLSTM}:
            return True
        if self.swa_window > 0:
            if self.block_pattern is None:
                return True  # every attention layer is windowed (mixtral)
            # gemma-style local:global mix: eligible if globals are a
            # minority (their caches still bound memory, not compute)
            n_global = sum(1 for k in self.layer_kinds() if k == ATTN)
            return n_global * 4 <= self.n_layers
        return False

    # ---------------- parameter counting (exact, matches init) -------------
    def param_count(self) -> int:
        """Exact parameter count of the model as initialized by repro_torch.models."""
        from repro_torch.models.spec import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.spec import count_params_analytic

        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len x global_batch, plus mode.
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode skipped (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants: same structure, tiny widths.
def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-runnable config of the same family; keeps the block pattern."""
    n_layers = cfg.n_layers
    if cfg.block_pattern is not None:
        # keep at least one full pattern period
        n_layers = min(max(len(cfg.block_pattern), 2), 8)
    else:
        n_layers = 2
    moe = cfg.moe
    if moe.n_experts > 0:
        # capacity = E/k removes token dropping -> deterministic smoke tests
        moe = replace(moe, n_experts=4, top_k=min(2, moe.top_k or 1),
                      capacity_factor=4.0)
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        head_dim=16,
        d_ff=(128 if cfg.d_ff else 0),
        vocab=512,
        moe=moe,
        ssm=replace(cfg.ssm, d_state=8, d_conv=4, expand=2, chunk=16),
        max_seq_len=1024,
        dtype="float32",
    )
    if cfg.n_vision_tokens:
        kw["n_vision_tokens"] = 16
    if cfg.enc_dec:
        kw["n_enc_layers"] = 2
        kw["n_audio_frames"] = 24
    if cfg.cross_attn_period:
        kw["cross_attn_period"] = 2
    return replace(cfg, **kw)


SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
SMOKE_DECODE_SHAPE = ShapeConfig("smoke_decode", 64, 2, "decode")


# ---------------------------------------------------------------------------
# Arch registry: populated by the per-arch modules in repro_torch/configs/.
ARCHS: Registry[ModelConfig] = Registry("arch")


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (ensures registrations ran)

    return ARCHS.get(name)()


def arch_names():
    import repro_torch.configs  # noqa: F401

    return ARCHS.names()


def to_dict(cfg) -> dict:
    if dataclasses.is_dataclass(cfg):
        return dataclasses.asdict(cfg)
    return dict(cfg)
