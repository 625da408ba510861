"""Architecture and simulator configs.

Importing this package registers the architectures the port serves (the
dense ones and the jamba hybrid) into ``repro_torch.configs.base.ARCHS``;
select one with ``--arch <id>``.
"""

from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_arch,
    reduced,
)

# Register the architectures (one module per arch id).
from repro_torch.configs import (  # noqa: F401  (import side effects)
    gemma3_1b,
    granite_3_8b,
    internlm2_20b,
    jamba_1_5_large_398b,
    qwen3_4b,
)
from repro_torch.configs.sim import (
    NodeType,
    SimConfig,
    partition_type_indices,
    tiny_cluster,
    tx_gaia,
)
