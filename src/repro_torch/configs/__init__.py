from repro_torch.configs.sim import (
    NodeType,
    SimConfig,
    partition_type_indices,
    tiny_cluster,
    tx_gaia,
)
