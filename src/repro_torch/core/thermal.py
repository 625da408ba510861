"""Rack thermal twin: only ``supply_temp``, which ``init_state`` needs for
the racks' initial outlet temperature. The RC loop, COP(wetbulb, load),
throttle and trip gate (and the ``rack_thermal`` kernel) arrive with the
thermal slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs.sim import SimConfig


def supply_temp(cfg: SimConfig, wetbulb_c: torch.Tensor) -> torch.Tensor:
    """Cooling supply-air temperature: wetbulb + tower/CDU approach,
    floored at the plant's minimum supply setpoint."""
    return torch.clamp(wetbulb_c + cfg.cooling_approach_c,
                       min=cfg.cooling_supply_min_c)
