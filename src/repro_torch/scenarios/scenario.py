"""Scenario = the grid context a datacenter runs under.

Bundles the three environmental signals (carbon intensity [gCO2/kWh],
electricity price [$/kWh], wetbulb temperature [degC]) with a
demand-response power-cap schedule, the outage / maintenance windows of
the fault engine, and the serving twin's request-rate signal and
flash-crowd windows. ``Statics`` carries it into the step.

``default_scenario(cfg)`` is the legacy diurnal grid; ``solar_heavy``,
``demand_response``, ``heatwave``, ``thermal_stress``,
``resilience_drill`` and ``carbon_trace`` are the single-replica presets
(``heatwave`` and ``thermal_stress`` are the weather the thermal twin is
studied under, ``resilience_drill`` the outages the fault engine is, and
``diurnal_serving`` the traffic the serving twin is); ``SCENARIOS``
names them. ``stack_scenarios`` batches scenarios for a fleet (a leading
replica axis on every leaf) and ``sample_scenarios`` draws a randomized
batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.scenarios.events import (
    BurstSchedule,
    CapSchedule,
    OutageSchedule,
    burst_events,
    cap_events,
    no_bursts,
    no_cap,
    no_outages,
    outage_events,
)
from repro_torch.scenarios.signals import Signal, constant, from_trace, sinusoid


class Scenario(NamedTuple):
    carbon: Signal        # grid carbon intensity [gCO2/kWh]
    price: Signal         # electricity price [$/kWh]
    wetbulb: Signal       # outdoor wetbulb [degC] (drives cooling COP)
    power_cap: CapSchedule
    outages: OutageSchedule = no_outages()   # read with cfg.outages_enabled
    # read with cfg.serving_on: request rate [req/s] and its flash crowds
    traffic: Signal = constant(0.0)
    bursts: BurstSchedule = no_bursts()


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


def resilience_drill(
    cfg: SimConfig,
    *,
    maint_rack: int = 0,
    maint_start_s: float = 2.0 * 3600.0,
    maint_len_s: float = 1.0 * 3600.0,
    brownout_start_s: float = 17.0 * 3600.0,
    brownout_len_s: float = 2.0 * 3600.0,
    brownout_level: int = 2,
) -> Scenario:
    """The fault-engine drill: a maintenance window taking one rack down
    (a correlated PDU / cooling-loop outage) plus a grid brownout forcing
    the degradation ladder to ``brownout_level`` (default 2 = dispatch
    gate). Pair with ``cfg.outages_enabled=True`` (and nonzero MTBFs for
    random faults on top)."""
    return default_scenario(cfg)._replace(
        outages=outage_events(
            [maint_start_s, brownout_start_s],
            [maint_start_s + maint_len_s, brownout_start_s + brownout_len_s],
            levels=[0, brownout_level],
            down_racks=[maint_rack, -1],
        ),
    )


def diurnal_serving(
    cfg: SimConfig,
    *,
    peak_rps: float = 40.0,
    base_frac: float = 0.25,
    burst_mult: float = 2.5,
    burst_start_s: float = 13.0 * 3600.0,
    burst_len_s: float = 1.0 * 3600.0,
    period_s: float | None = None,
) -> Scenario:
    """Online-inference traffic for the serving twin: a diurnal
    request-rate sinusoid (night trough at ``base_frac * peak_rps``, peak
    mid-cycle, on the wetbulb peak) plus one flash-crowd window
    multiplying the rate by ``burst_mult``. Pair with
    ``cfg.serving_enabled=True`` and a nonzero ``serving_nodes`` pool;
    ``period_s`` shrinks the cycle for short episodes."""
    period = cfg.day_seconds if period_s is None else period_s
    mean = 0.5 * (1.0 + base_frac) * peak_rps
    amp = 0.5 * (1.0 - base_frac) * peak_rps
    return default_scenario(cfg)._replace(
        # mean - amp*cos(2*pi*t/period): trough at t=0, peak mid-cycle
        traffic=sinusoid(mean, amp, period, phase=-math.pi / 2),
        bursts=burst_events([burst_start_s],
                            [burst_start_s + burst_len_s], [burst_mult]),
    )


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "default": default_scenario,
    "solar_heavy": solar_heavy,
    "demand_response": demand_response,
    "heatwave": heatwave,
    "thermal_stress": thermal_stress,
    "resilience_drill": resilience_drill,
    "diurnal_serving": diurnal_serving,
}


def _nonneg_price(mean: float, amp: float, period_s: float,
                  phase: float) -> Signal:
    """Price sinusoid with the trough clamped non-negative (no paying the
    agent to burn energy unless a trace says so explicitly)."""
    return sinusoid(mean, min(amp, 0.95 * mean), period_s, phase)


# ------------------------------------------------------------- fleet utils
def _pad_trace(sig: Signal, T: int) -> Signal:
    t = sig.values.shape[0]
    if t == T:
        return sig
    pad = sig.values[-1:].expand(T - t)  # edge-hold
    return sig._replace(values=torch.cat([sig.values, pad]))


def _pad_events(sched: CapSchedule, n: int) -> CapSchedule:
    e = sched.start_t.shape[0]
    if e == n:
        return sched
    z = torch.zeros((n - e,), dtype=torch.float32,
                    device=sched.start_t.device)
    return CapSchedule(
        start_t=torch.cat([sched.start_t, z]),
        end_t=torch.cat([sched.end_t, z]),
        cap_w=torch.cat([sched.cap_w, z]),
        base_cap_w=sched.base_cap_w,
    )


def _pad_outages(sched: OutageSchedule, n: int) -> OutageSchedule:
    e = sched.start_t.shape[0]
    if e == n:
        return sched
    dev = sched.start_t.device
    z = torch.zeros((n - e,), dtype=torch.float32, device=dev)
    return OutageSchedule(
        start_t=torch.cat([sched.start_t, z]),
        end_t=torch.cat([sched.end_t, z]),
        force_level=torch.cat([sched.force_level, torch.zeros(
            (n - e,), dtype=torch.int32, device=dev)]),
        down_rack=torch.cat([sched.down_rack, torch.full(
            (n - e,), -1, dtype=torch.int32, device=dev)]),
    )


def _pad_bursts(sched: BurstSchedule, n: int) -> BurstSchedule:
    e = sched.start_t.shape[0]
    if e == n:
        return sched
    z = torch.zeros((n - e,), dtype=torch.float32,
                    device=sched.start_t.device)
    return BurstSchedule(
        start_t=torch.cat([sched.start_t, z]),
        end_t=torch.cat([sched.end_t, z]),
        mult=torch.cat([sched.mult, z]),
    )


def _stack(items):
    """Stack NamedTuples of tensors leaf-wise along a new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return type(first)(*(_stack([getattr(it, f) for it in items])
                         for f in first._fields))


def stack_scenarios(scenarios: Sequence[Scenario]) -> Scenario:
    """Stack scenarios into one batched Scenario (leading replica axis).

    Trace arrays are edge-hold padded to a common length and cap, outage
    and burst schedules to a common event count, so heterogeneous
    scenarios share one shape.
    """
    if not scenarios:
        raise ValueError("need at least one scenario")
    T = max(s.values.shape[0] for sc in scenarios
            for s in (sc.carbon, sc.price, sc.wetbulb, sc.traffic))
    n = max(sc.power_cap.start_t.shape[0] for sc in scenarios)
    no = max(sc.outages.start_t.shape[0] for sc in scenarios)
    nb = max(sc.bursts.start_t.shape[0] for sc in scenarios)
    norm = [
        Scenario(
            carbon=_pad_trace(sc.carbon, T),
            price=_pad_trace(sc.price, T),
            wetbulb=_pad_trace(sc.wetbulb, T),
            power_cap=_pad_events(sc.power_cap, n),
            outages=_pad_outages(sc.outages, no),
            traffic=_pad_trace(sc.traffic, T),
            bursts=_pad_bursts(sc.bursts, nb),
        )
        for sc in scenarios
    ]
    return _stack(norm)


def n_replicas(scenarios: Scenario) -> int:
    """Replica count of a batched (stacked) Scenario."""
    return int(scenarios.carbon.mean.shape[0])


def sample_scenarios(
    cfg: SimConfig,
    n: int,
    seed: int = 0,
    *,
    p_demand_response: float = 0.3,
    cap_frac_range=(0.5, 0.9),
) -> Scenario:
    """Randomized scenario sweep: jittered carbon/price/wetbulb parameters,
    a fraction of replicas with an evening demand-response event. Returns a
    batched Scenario for ``run_fleet``. Host-side numpy randomness, drawn
    in the JAX package's order, so a seed gives the same scenarios."""
    rng = np.random.default_rng(seed)
    # rough facility scale for cap sizing: nameplate IT + overheads
    nameplate = cfg.nameplate_it_w * 1.3
    out = []
    for i in range(n):
        sc = default_scenario(cfg)._replace(
            carbon=sinusoid(
                cfg.carbon_mean * rng.uniform(0.7, 1.3),
                cfg.carbon_amp * rng.uniform(0.5, 1.8),
                cfg.day_seconds, phase=math.pi / 2 + rng.uniform(-0.4, 0.4),
                noise_amp=rng.uniform(0.0, 25.0), noise_seed=float(i + 1),
            ),
            price=_nonneg_price(
                cfg.price_mean_usd_kwh * rng.uniform(0.6, 1.6),
                cfg.price_amp_usd_kwh * rng.uniform(0.5, 2.0),
                cfg.day_seconds, phase=-math.pi + rng.uniform(-0.5, 0.5),
            ),
            wetbulb=sinusoid(
                cfg.wetbulb_mean_c + rng.uniform(-4.0, 8.0),
                cfg.wetbulb_amp_c * rng.uniform(0.5, 1.5),
                cfg.day_seconds, phase=-math.pi / 2,
            ),
        )
        if rng.random() < p_demand_response:
            start = rng.uniform(0.5, 20.0) * 3600.0
            sc = sc._replace(power_cap=cap_events(
                [start], [start + rng.uniform(0.5, 4.0) * 3600.0],
                [nameplate * rng.uniform(*cap_frac_range)],
                base_cap_w=cfg.power_cap_w,
            ))
        out.append(sc)
    return stack_scenarios(out)
