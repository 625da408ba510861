"""Scenario = the grid context a datacenter runs under.

Bundles the three environmental signals (carbon intensity [gCO2/kWh],
electricity price [$/kWh], wetbulb temperature [degC]) with a
demand-response power-cap schedule. ``Statics`` carries it into the step.

``default_scenario(cfg)`` is the legacy diurnal grid. The other presets,
``stack_scenarios`` and ``sample_scenarios`` arrive with the fleets
slice; the outage, traffic and burst fields with the faults and serving
slices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.configs.sim import SimConfig
from repro_torch.scenarios.events import CapSchedule, no_cap
from repro_torch.scenarios.signals import Signal, sinusoid


class Scenario(NamedTuple):
    carbon: Signal        # grid carbon intensity [gCO2/kWh]
    price: Signal         # electricity price [$/kWh]
    wetbulb: Signal       # outdoor wetbulb [degC] (drives cooling COP)
    power_cap: CapSchedule


def default_scenario(cfg: SimConfig) -> Scenario:
    """The legacy diurnal grid: carbon peaks at midnight (no solar),
    wetbulb peaks mid-afternoon, price peaks in the evening; standing power
    cap from ``cfg.power_cap_w``."""
    return Scenario(
        carbon=sinusoid(cfg.carbon_mean, cfg.carbon_amp, cfg.day_seconds,
                        phase=math.pi / 2),
        # evening peak at ~18:00
        price=sinusoid(cfg.price_mean_usd_kwh, cfg.price_amp_usd_kwh,
                       cfg.day_seconds, phase=-math.pi),
        wetbulb=sinusoid(cfg.wetbulb_mean_c, cfg.wetbulb_amp_c,
                         cfg.day_seconds, phase=-math.pi / 2),
        power_cap=no_cap(cfg.power_cap_w),
    )
