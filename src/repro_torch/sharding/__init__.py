"""The port's sharding: how the fleet trees split across the ranks of a
fleet mesh (the fleet half of the JAX package's ``repro.sharding``), and
the one-card context of the LM training path (``ctx``)."""

from repro_torch.sharding.ctx import UNSHARDED, ShardCtx
from repro_torch.sharding.specs import FLEET_AXIS, fleet_block, gather_fleet
