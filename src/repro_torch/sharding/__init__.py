"""How the port's fleet trees split across the ranks of a fleet mesh (the
fleet half of the JAX package's ``repro.sharding``)."""

from repro_torch.sharding.specs import FLEET_AXIS, fleet_block, gather_fleet
