"""The port's sharding (the JAX package's ``repro.sharding``): how the
fleet trees split across the ranks of a fleet mesh, the LM's specs of
parameters, batches, caches and train states and their DTensor placements
(``specs``), and the logical-axis context of the LM code (``ctx``)."""

from repro_torch.sharding.ctx import UNSHARDED, ShardCtx, make_ctx
from repro_torch.sharding.specs import (
    FLEET_AXIS,
    NamedSharding,
    batch_pspecs,
    cache_pspecs,
    distribute,
    fleet_block,
    gather_fleet,
    named_shardings,
    param_pspecs,
    placements,
    train_state_pspecs,
)
