"""Architecture and simulator configs.

Importing this package registers every architecture of the JAX package
into ``repro_torch.configs.base.ARCHS``; select one with ``--arch <id>``.
The perf model counts all of them, and the port builds and serves every
one.
"""

from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    SMOKE_DECODE_SHAPE,
    SMOKE_SHAPE,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    arch_names,
    get_arch,
    reduced,
    shape_applicable,
)

# Register the architectures (one module per arch id).
from repro_torch.configs import (  # noqa: F401  (import side effects)
    gemma3_1b,
    granite_3_8b,
    grok_1_314b,
    internlm2_20b,
    jamba_1_5_large_398b,
    llama_3_2_vision_11b,
    mixtral_8x22b,
    qwen3_4b,
    whisper_small,
    xlstm_125m,
)
from repro_torch.configs.sim import (
    NodeType,
    SimConfig,
    partition_type_indices,
    tiny_cluster,
    tx_gaia,
)
