"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ARCHS, ModelConfig, MoEConfig


@ARCHS.register("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        rope_theta=1e6,
        swa_window=4096,          # per assigned config note: SWA
        moe=MoEConfig(n_experts=8, top_k=2, period=1),
        source="arXiv:2401.04088; hf",
    )
