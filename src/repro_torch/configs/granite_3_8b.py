"""granite-3-8b [dense] — GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab=49155,
        rope_theta=1e4,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
    )
