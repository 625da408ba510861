"""Rack thermal twin: the cooling loop as simulation state.

Per rack one outlet temperature with a first-order RC lag:

    T[k+1] = T[k] + alpha * (T_ss - T[k]),  alpha = 1 - exp(-dt / tau)
    T_ss   = supply + R_th * heat_w
    supply = max(wetbulb + approach, supply_min)

``heat_w`` is the rack's total input power. Feedback into the schedule,
both from the PREVIOUS tick's outlet temperatures (a one-tick control
lag): a continuous DVFS derate (``rack_throttle``) of node dynamic power
and job progress, and a binary dispatch trip (``node_trip_ok``): racks
at or above ``thermal_trip_c`` accept no new placements. The cooling COP
depends on wetbulb and IT load (``cooling_cop``).

The tick's thermal tail is ``rack_tick``: one launch of the
``rack_thermal`` kernel's fused entry over the racks' static CSR (its
plain version on the CPU). ``rack_thermal_update`` runs the kernel's
plain-signature entry the same way; the device decides. Nothing here
reads a tensor on the host. ``thermal_crossing_horizon`` bounds the ticks
before any rack can cross the trip, for the macro-stepping engine.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Tuple

import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.kernels import rack_thermal as prt
from repro_torch.kernels.throttle import Throttle, throttle_curve
from repro_torch.scenarios.signals import signal_bounds
from repro_torch.utils.device import full

if TYPE_CHECKING:  # type hints only: state.py imports supply_temp
    from repro_torch.core.state import SimState, Statics


def thermal_alpha(cfg: SimConfig) -> float:
    """Per-tick RC relaxation factor, as a Python float that every path
    rounds to f32 once."""
    return float(-math.expm1(-cfg.dt / max(cfg.rack_tau_s, 1e-6)))


def supply_temp(cfg: SimConfig, wetbulb_c: torch.Tensor) -> torch.Tensor:
    """Cooling supply-air temperature: wetbulb + tower/CDU approach,
    floored at the plant's minimum supply setpoint."""
    return torch.clamp(wetbulb_c + cfg.cooling_approach_c,
                       min=cfg.cooling_supply_min_c)


def cooling_cop(cfg: SimConfig, wetbulb_c: torch.Tensor,
                load_frac: torch.Tensor) -> torch.Tensor:
    """COP(wetbulb, IT load): linear wetbulb derate plus a part-load
    penalty, floored at ``cop_min``."""
    return torch.clamp(
        cfg.cop_base
        + cfg.cop_wetbulb_coef * (wetbulb_c - cfg.wetbulb_ref_c)
        + cfg.cop_load_coef * (load_frac - cfg.cop_load_ref),
        min=cfg.cop_min)


def rack_throttle(cfg: SimConfig, rack_outlet_c: torch.Tensor) -> torch.Tensor:
    """(R,) DVFS clock fraction per rack: 1 below ``throttle_start_c``,
    linear ramp to ``thermal_throttle_floor`` at ``throttle_full_c``.
    Monotone non-increasing in outlet temperature."""
    return throttle_curve(rack_outlet_c, throttle_params(cfg))


def throttle_params(cfg: SimConfig) -> Throttle:
    """``rack_throttle``'s ramp as ``throttle_curve`` and the kernels take
    it."""
    return Throttle(cfg.throttle_start_c,
                    max(cfg.throttle_full_c - cfg.throttle_start_c, 1e-6),
                    1.0 - cfg.thermal_throttle_floor,
                    cfg.thermal_throttle_floor)


def job_thermal_rate(state: "SimState", statics: "Statics",
                     node_th: torch.Tensor) -> torch.Tensor:
    """(..., J) progress factor per job: the MIN clock over the job's
    placed nodes (synchronous ranks run at the slowest one). Unplaced
    slots contribute 1, so queued and finished jobs are unaffected."""
    place = state.placement                                   # (..., J, K)
    valid = place >= 0
    safe = torch.where(valid, place, 0).long()
    slot_th = torch.gather(node_th, -1, safe.flatten(-2)).view(place.shape)
    return torch.amin(torch.where(valid, slot_th, 1.0), dim=-1)


def node_trip_ok(cfg: SimConfig, state: "SimState",
                 statics: "Statics") -> torch.Tensor:
    """(..., N) bool: nodes whose rack is below the dispatch trip
    threshold — the thermal half of placement eligibility."""
    rack_ok = state.rack_outlet_c < cfg.thermal_trip_c
    return rack_ok.index_select(-1, statics.node_rack.long())


def rack_thermal_update(
    cfg: SimConfig,
    statics: "Statics",
    rack_outlet_c: torch.Tensor,     # (..., R)
    node_heat_w: torch.Tensor,       # (..., N) post-throttle input power
    supply_c: torch.Tensor,          # (...)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RC step of every rack of one replica (``supply_c`` 0-d) or of E
    (a leading E on every argument): scatter node heat onto racks and relax
    toward the steady state. Returns (new_outlet_c, rack_heat_w), each
    (..., R)."""
    lead = tuple(supply_c.shape)
    new_t, heat = prt.rack_thermal(
        node_heat_w.reshape((-1,) + node_heat_w.shape[-1:]).contiguous(),
        statics.node_rack,
        rack_outlet_c.reshape((-1,) + rack_outlet_c.shape[-1:]).contiguous(),
        supply_c.reshape(-1).contiguous(), statics.rack_r_th,
        alpha=thermal_alpha(cfg))
    return (new_t.view(lead + new_t.shape[-1:]),
            heat.view(lead + heat.shape[-1:]))


def rack_tick_statics(cfg: SimConfig, statics: "Statics") -> prt.RackStatics:
    """``rack_tick``'s fixed inputs, checked (and on the card packed) once
    per ``make_step``."""
    return prt.rack_statics(
        statics.rack_ptr, statics.rack_nodes, statics.node_rack,
        statics.rack_r_th, consts=prt.RackConsts(
            cfg.cooling_approach_c, cfg.cooling_supply_min_c,
            thermal_alpha(cfg), cfg.dt, throttle_params(cfg)))


def rack_tick(rs: prt.RackStatics, state: "SimState",
              node_input_w: torch.Tensor, r: torch.Tensor,
              wetbulb_c: torch.Tensor
              ) -> Tuple["SimState", torch.Tensor, torch.Tensor]:
    """The tick's last act with thermals on: the racks' RC step on the
    post-cap input power ``node_input_w * r`` (all of it room heat),
    committed after the derate used the pre-update temperatures; one
    launch for one state or a fleet's (E, ...) fields as they are. Returns
    the state with the new outlets, throttled seconds and peak, and the
    tick's (throttled seconds, hottest rack)."""
    new_t, th_step, rack_max, peak = prt.rack_tick(
        rs, node_input_w, r, wetbulb_c, state.rack_outlet_c,
        state.peak_rack_c)
    state = state._replace(
        rack_outlet_c=new_t,
        thermal_throttle_s=state.thermal_throttle_s + th_step,
        peak_rack_c=peak)
    return state, th_step, rack_max


def thermal_crossing_horizon(cfg: SimConfig, statics: "Statics",
                             state: "SimState",
                             max_ticks: int) -> torch.Tensor:
    """Conservative tick count free of dispatch-trip crossings, int32, one
    per replica.

    The RC update is a contraction: every rack temperature stays inside
    the box [min(T, ss_lo), max(T, ss_hi)] spanned by its current value
    and the extreme steady states (the wetbulb's ``signal_bounds`` x zero
    to nameplate heat through the worst-case chain: load clip 1.2,
    rectifier efficiency floor 0.5), and moves at most ``alpha * width``
    a tick. A rack whose trip lies outside its box never crosses;
    otherwise it needs at least ``distance / (alpha * width)`` ticks, less
    a margin for float drift. Divisions by a config number divide by a
    device tensor, so they are true divisions on every device."""
    dev = state.rack_outlet_c.device
    kf = float(max_ticks)
    wb_lo, wb_hi = signal_bounds(statics.scenario.wetbulb)
    sup_lo = supply_temp(cfg, wb_lo)[..., None]
    sup_hi = supply_temp(cfg, wb_hi)[..., None]
    heat_hi = statics.rack_cap_w * 1.2 / full(0.5 * cfg.conv_eff,
                                              torch.float32, dev)
    ss_hi = sup_hi + heat_hi * statics.rack_r_th                 # (..., R)
    T = state.rack_outlet_c
    lo = torch.minimum(T, sup_lo)
    hi = torch.maximum(T, ss_hi)
    width = torch.clamp(hi - lo, min=1e-6)
    trip = cfg.thermal_trip_c
    reachable = (trip >= lo) & (trip <= hi)
    ticks = torch.floor(torch.abs(T - trip) / (thermal_alpha(cfg) * width)
                        - 1e-3)
    ticks = torch.where(reachable, ticks, kf)
    return torch.clamp(torch.amin(ticks, -1), 0.0, kf).to(torch.int32)
