"""whisper-small [audio] — encoder-decoder transformer backbone; conv audio
frontend is a STUB (input_specs() supplies precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]

Adaptation note (DESIGN.md §Arch-applicability): the backbone uses RoPE in
place of Whisper's learned absolute positions so the assigned 32k-decoder
shapes are well-defined; parameter counts are otherwise faithful.
"""

from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,                  # decoder layers
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        enc_dec=True,
        n_enc_layers=12,
        n_audio_frames=1500,
        tie_embeddings=True,
        source="arXiv:2212.04356; unverified",
    )
