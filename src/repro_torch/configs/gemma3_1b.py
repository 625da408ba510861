"""gemma3-1b [dense] — 5:1 local:global attention, MQA (kv=1), 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import ARCHS, ATTN, ATTN_LOCAL, ModelConfig


@ARCHS.register("gemma3-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        rope_theta=1e6,
        qk_norm=True,
        swa_window=512,
        # 5 local : 1 global, repeating.
        block_pattern=(ATTN_LOCAL,) * 5 + (ATTN,),
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt; unverified",
    )
