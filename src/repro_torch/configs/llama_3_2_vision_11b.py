"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th layer;
vision frontend is a STUB (precomputed patch embeddings from input_specs()).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""

from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=128256,
        rope_theta=5e5,
        cross_attn_period=5,          # a cross-attn layer after every 5th layer
        n_vision_tokens=1601,         # one 560px tile -> 1600 patches + CLS
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )
