"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import (
    ARCHS,
    ATTN,
    MAMBA,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)


@ARCHS.register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=65536,
        rope_theta=1e4,
        # Jamba block: 8 layers, 1 attention : 7 mamba (attn at position 3).
        block_pattern=(MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA, MAMBA),
        moe=MoEConfig(n_experts=16, top_k=2, period=2),  # MoE every 2nd layer
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
        source="arXiv:2403.19887; hf",
    )
