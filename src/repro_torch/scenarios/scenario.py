"""Scenario = the grid context a datacenter runs under.

Bundles the three environmental signals (carbon intensity [gCO2/kWh],
electricity price [$/kWh], wetbulb temperature [degC]) with a
demand-response power-cap schedule. ``Statics`` carries it into the step.

``default_scenario(cfg)`` is the legacy diurnal grid; ``solar_heavy``,
``demand_response``, ``heatwave``, ``thermal_stress`` and
``carbon_trace`` are the single-replica presets (``heatwave`` and
``thermal_stress`` are the weather the thermal twin is studied under).
``stack_scenarios`` and ``sample_scenarios`` arrive with the fleets
slice; the outage, traffic and burst fields and their presets with the
faults and serving slices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.configs.sim import SimConfig
from repro_torch.scenarios.events import CapSchedule, cap_events, no_cap
from repro_torch.scenarios.signals import Signal, from_trace, sinusoid


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


def solar_heavy(cfg: SimConfig, *, depth: float = 0.75) -> Scenario:
    """Deep midday solar trough: large carbon swing + duck-curve pricing."""
    base = default_scenario(cfg)
    return base._replace(
        carbon=sinusoid(cfg.carbon_mean, cfg.carbon_mean * depth * 0.9,
                        cfg.day_seconds, phase=math.pi / 2, noise_amp=12.0),
        price=sinusoid(cfg.price_mean_usd_kwh, cfg.price_mean_usd_kwh * 0.7,
                       cfg.day_seconds, phase=-math.pi, noise_amp=0.004),
    )


def demand_response(
    cfg: SimConfig,
    *,
    cap_w: float,
    event_start_s: float = 17.0 * 3600.0,
    event_len_s: float = 3.0 * 3600.0,
    n_days: int = 1,
    n_events: int | None = None,
) -> Scenario:
    """Default grid + a daily evening-peak curtailment window."""
    starts = [event_start_s + d * cfg.day_seconds for d in range(n_days)]
    ends = [s + event_len_s for s in starts]
    return default_scenario(cfg)._replace(
        power_cap=cap_events(starts, ends, [cap_w] * n_days,
                             base_cap_w=cfg.power_cap_w, n_events=n_events),
    )


def heatwave(cfg: SimConfig, *, delta_c: float = 8.0) -> Scenario:
    """Elevated wetbulb (worse cooling COP) + stressed-grid carbon/price."""
    base = default_scenario(cfg)
    return base._replace(
        wetbulb=sinusoid(cfg.wetbulb_mean_c + delta_c, cfg.wetbulb_amp_c,
                         cfg.day_seconds, phase=-math.pi / 2, noise_amp=0.8),
        carbon=sinusoid(cfg.carbon_mean * 1.2, cfg.carbon_amp,
                        cfg.day_seconds, phase=math.pi / 2),
        price=sinusoid(cfg.price_mean_usd_kwh * 1.5, cfg.price_amp_usd_kwh * 2,
                       cfg.day_seconds, phase=-math.pi),
    )


def thermal_stress(
    cfg: SimConfig,
    *,
    delta_c: float = 10.0,
    cap_frac: float = 0.7,
    event_start_s: float = 13.0 * 3600.0,
    event_len_s: float = 4.0 * 3600.0,
) -> Scenario:
    """A heatwave (high wetbulb -> high supply temperature -> racks ride
    the throttle and trip thresholds) plus an afternoon demand-response
    window on the wetbulb peak. ``cfg.thermal_enabled`` turns the rack RC
    loop on; this scenario supplies the weather and grid that exercise it.
    """
    base = heatwave(cfg, delta_c=delta_c)
    cap_w = cfg.nameplate_it_w * 1.3 * cap_frac
    return base._replace(
        power_cap=cap_events([event_start_s],
                             [event_start_s + event_len_s], [cap_w],
                             base_cap_w=cfg.power_cap_w),
    )


def carbon_trace(cfg: SimConfig, values, dt: float,
                 t0: float = 0.0) -> Scenario:
    """Default grid with carbon replaced by a sampled trace (e.g. a grid
    operator's 5-minute marginal-intensity feed)."""
    return default_scenario(cfg)._replace(carbon=from_trace(values, dt, t0))
