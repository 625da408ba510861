"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8. [hf:xai-org/grok-1; unverified]"""

from repro_torch.configs.base import ARCHS, ModelConfig, MoEConfig


@ARCHS.register("grok-1-314b")
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab=131072,
        rope_theta=1e4,
        moe=MoEConfig(n_experts=8, top_k=2, period=1),
        source="hf:xai-org/grok-1; unverified",
    )
