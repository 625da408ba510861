"""qwen3-4b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,            # qwen3 uses explicit head_dim=128 (> d_model/H)
        d_ff=9728,
        vocab=151936,
        rope_theta=1e6,
        qk_norm=True,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B; hf",
    )
