"""The RAPS trace-replay / rescheduling simulator step and episode runner.

``make_step(cfg, statics, scheduler)`` closes over the static datacenter
description and returns ``step(state, action) -> (state, StepOut)``; an
episode is a Python loop over steps (the JAX package's ``lax.scan``).

Scheduling is a two-stage engine: job *selection* (``core.schedulers``:
replay/fcfs/sjf/priority/easy, or the external RL action) x node
*placement* (``core.placement``: first_fit/best_fit/spread/partition/
green), named by strings or given as data: a ``placement.Policy`` of
per-replica (select, place) ids.

One step serves one state and a fleet's: every function below takes the
state's fields with or without a leading replica axis E (each reduction
runs over the last axes, each index is per replica), and a fleet's
``Statics.scenario`` is batched the same way. The kernels take E as
their grid. ``core.fleet.run_fleet`` builds the fleet.

Step order (matches RAPS' fixed-dt loop):
  1. job completions -> free resources, stats
  2. scheduling: ``starts_per_step`` dispatch attempts via the policy
  3. grid signals at t, then the power chain (``power_tick``: one
     kernel launch on the card)
  4. progress running jobs (network-congestion-aware rate)
  5. energy/carbon/stat accumulation

With ``cfg.thermal_enabled`` the rack thermal twin (``core.thermal``)
derates the power chain and job progress from the previous tick's rack
temperatures (inside ``power_tick``), closes the plant with the dynamic
COP, gates new dispatch on the racks' trip, and commits the racks' RC
update (``rack_tick``, one launch of the ``rack_thermal`` kernel on the
card) last in the tick.

With ``cfg.resilience_on`` the fault engine (``core.faults``) runs first
in the tick: due fault clocks fire, outage windows take racks down and
force ladder levels, nodes are repaired, and jobs on newly-downed nodes
are killed (rewound to their last checkpoint, requeued or failed for
good); the ladder gates new dispatch from ``LVL_GATE`` up and scales the
power chain and progress in the tail, and the checkpoint write drags
progress.

With ``cfg.serving_on`` the serving twin (``core.serving``) runs its
overload ladder right after the fault engine (autoscale, retries,
shedding, admission); in the tail the pool's power joins the plant
before the DVFS cap, and its request mass flows after the energy
accumulators, with the SLO term in the reward.

The step never reads a tensor on the host (no ``.item()``, no Python
branch on a tensor value), so on the card the ticks queue work without a
single sync.

Macro-stepping (``make_macro_step``, ``run_episode(macro=True)``) runs
one full event tick, then fast-forwards the quiet ticks after it: ticks
that change no machine state, so only time, work left, the accumulators
and (with thermals) the racks move. A fast tick runs the grid signals,
``power_tick`` and the step's own tail on the frozen segment, so it
gives the per-tick path's numbers. How far to go depends on the data:
the host reads it through ``utils.device.host_read``, once after the
event tick and once per chunk of ``chunk_ticks`` fast ticks; no other
read is made.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.sim import SimConfig
from repro_torch.core import faults as flt
from repro_torch.core import placement as plc
from repro_torch.core import schedulers as sched
from repro_torch.core import serving as srv
from repro_torch.core import thermal as thm
from repro_torch.core.faults import release_jobs as _release
from repro_torch.core.network import congestion_slowdown
from repro_torch.core.power import PowerOut, power_tick, tick_statics
from repro_torch.core.placement import Policy
from repro_torch.core.state import (
    DONE,
    QUEUED,
    RUNNING,
    SimState,
    Statics,
)
from repro_torch.scenarios.events import next_cap_event, power_cap_at
from repro_torch.scenarios.signals import eval_signal
from repro_torch.utils.device import full, host_read, put, take, to_device
from repro_torch.utils.errors import ConfigError


class StepOut(NamedTuple):
    facility_w: torch.Tensor
    it_w: torch.Tensor
    pue: torch.Tensor
    util: torch.Tensor            # fraction of up-node cores busy
    queue_len: torch.Tensor
    running: torch.Tensor
    completed_now: torch.Tensor
    energy_kwh_step: torch.Tensor
    carbon_kg_step: torch.Tensor
    net_load: torch.Tensor
    reward: torch.Tensor
    carbon_gkwh: torch.Tensor     # instantaneous grid carbon intensity
    price_usd_kwh: torch.Tensor   # instantaneous electricity price
    power_cap_w: torch.Tensor     # effective facility cap (0 = uncapped)
    cost_usd_step: torch.Tensor   # electricity cost of this step
    throttle: torch.Tensor        # DVFS clock fraction applied [floor, 1]
    # thermal telemetry: the static plant while the thermal twin is off
    rack_max_c: torch.Tensor
    cop: torch.Tensor
    thermal_throttle_s_step: torch.Tensor
    # resilience telemetry: zeros while the fault engine is off
    # (degrade_level: the ladder level in force, as f32)
    killed_now: torch.Tensor
    lost_node_s_step: torch.Tensor
    degrade_level: torch.Tensor
    # serving telemetry: None while the serving twin is off
    srv_arrived_step: torch.Tensor | None = None
    srv_completed_step: torch.Tensor | None = None
    srv_shed_step: torch.Tensor | None = None
    srv_dropped_step: torch.Tensor | None = None
    srv_retried_step: torch.Tensor | None = None
    srv_slo_viol_step: torch.Tensor | None = None
    srv_latency_s: torch.Tensor | None = None
    srv_queue_len: torch.Tensor | None = None
    srv_active_nodes: torch.Tensor | None = None
    srv_lat_hist_step: torch.Tensor | None = None


def _parse_weights(reward_weights) -> Tuple[float, ...]:
    """(w_thr, w_en, w_co2, w_q, w_cost, w_lost, w_slo); the trailing
    three default to 0."""
    if len(reward_weights) not in (4, 5, 6, 7):
        raise ConfigError(
            "reward_weights must have 4 to 7 entries "
            "(w_thr, w_en, w_co2, w_q[, w_cost[, w_lost[, w_slo]]]); got "
            f"{len(reward_weights)}")
    return tuple(reward_weights) + (0.0,) * (7 - len(reward_weights))


def _grid_signals(statics: Statics, t: torch.Tensor):
    """(carbon gCO2/kWh, price $/kWh, facility cap W (0 = uncapped),
    wetbulb degC) of the scenario at ``t``: each (E,) for a fleet's
    batched scenario and clocks."""
    scn = statics.scenario
    return (eval_signal(scn.carbon, t), eval_signal(scn.price, t),
            power_cap_at(scn.power_cap, t), eval_signal(scn.wetbulb, t))


def _make_tail(cfg: SimConfig, statics: Statics, reward_weights):
    """The per-tick accounting tail after the power chain (which, with
    ``cfg.thermal_enabled``, already carries the thermal derate): the
    jobs' thermal clock, the degradation ladder and the checkpoint drag
    (``cfg.resilience_on``), the serving pool's power
    (``cfg.serving_on``), the DVFS throttle to the power cap, job
    progress, energy/carbon/cost accumulation, the serving request flow,
    the rack RC update (``rack_tick``), reward and ``StepOut``.
    ``killed_now``/``lost_now`` are the fault engine's per-tick kills and
    lost node-seconds, ``shed_now``/``dropped_now``/``retried_now`` the
    serving ladder's mass: the full step passes them, fast ticks pass
    nothing (both fire only on event ticks, so zeros are exact)."""
    (w_thr, w_en, w_co2, w_q, w_cost, w_lost,
     w_slo) = _parse_weights(reward_weights)
    dev = statics.capacity.device
    zeros = {}     # the off models' telemetry, one tensor per replica shape
    racks = (thm.rack_tick_statics(cfg, statics) if cfg.thermal_enabled
             else None)
    dt_h = cfg.dt / 3600.0
    en_scale = max(cfg.n_nodes * 0.4 * dt_h, 1e-9)
    co2_scale = max(cfg.n_nodes * 0.15 * dt_h, 1e-9)
    cost_scale = max(cfg.n_nodes * 0.4 * dt_h * cfg.price_mean_usd_kwh, 1e-9)
    # the lost-work penalty's node-second budget of a tick: a true
    # division on every device (a device tensor divisor)
    lost_scale = full(max(cfg.n_nodes * cfg.dt, 1e-9), torch.float32, dev)
    # the SLO penalty's scale: the pool's full-rate request budget a tick
    srv_scale = full(max(cfg.serving_nodes * cfg.serving_concurrency
                         / max(cfg.serving_service_s, 1e-9) * cfg.dt, 1e-9),
                     torch.float32, dev)

    def tail(
        state: SimState,
        signals: Tuple[torch.Tensor, ...],   # _grid_signals at state.t
        p: PowerOut,
        cop: torch.Tensor,
        idle_total: torch.Tensor,  # idle power of the up nodes
        job_th: torch.Tensor | None,  # per-job thermal clock (thermals on)
        rate: torch.Tensor,        # pre-throttle per-job progress rate (..., J)
        net_load: torch.Tensor,
        n_done: torch.Tensor,      # int32 completions this tick
        queued: torch.Tensor,
        running: torch.Tensor,
        util: torch.Tensor,
        killed_now: torch.Tensor | None = None,
        lost_now: torch.Tensor | None = None,
        shed_now: torch.Tensor | None = None,
        dropped_now: torch.Tensor | None = None,
        retried_now: torch.Tensor | None = None,
    ) -> Tuple[SimState, StepOut]:
        carbon_g, price, cap_w, wb = signals
        lead = tuple(state.t.shape)
        if lead not in zeros:
            zeros[lead] = torch.zeros(lead, dtype=torch.float32, device=dev)
        zero = zeros[lead]
        killed_now = zero if killed_now is None else killed_now
        lost_now = zero if lost_now is None else lost_now
        if shed_now is None:
            shed_now = dropped_now = retried_now = zero
        if cfg.thermal_enabled:
            # synchronous ranks run at the slowest clock over a job's nodes
            rate = rate * job_th

        if cfg.resilience_on:
            # --- the degradation ladder: from THROTTLE up it throttles
            # dynamic power and progress as the DVFS cap does (idle power
            # burns at any clock); the checkpoint write drags progress.
            # Constant across a quiet macro segment, so fast ticks re-run
            # it exactly
            dg_lvl = flt.effective_level(cfg, state, statics)
            dg = flt.degrade_clock(cfg, dg_lvl)
            dg_on = dg_lvl >= flt.LVL_THROTTLE
            dyn_dg = torch.clamp(p.it_w - idle_total, min=0.0)
            r_dg = (idle_total + dg * dyn_dg) / torch.clamp(p.it_w, min=1.0)
            r_dg = torch.where(dg_on, r_dg, 1.0)
            dg = torch.where(dg_on, dg, 1.0)
            p = p._replace(
                it_w=p.it_w * r_dg, input_w=p.input_w * r_dg,
                cooling_w=p.cooling_w * r_dg,
                facility_w=p.facility_w * r_dg, gflops=p.gflops * dg)
            rate = rate * dg[..., None]
            if cfg.ckpt_overhead_s > 0:
                rate = rate * flt.ckpt_drag(cfg, state)
            dg_level = dg_lvl.to(torch.float32)
        else:
            dg_level = zero

        if cfg.serving_on:
            # --- the serving pool's power joins the plant before the cap,
            # so the cap throttles batch and serving dynamic power
            # together, and its idle floor joins the unthrottleable base;
            # it rides the plant's COP but heats no batch rack
            srv_it, srv_in, srv_cool, srv_idle = srv.serving_power(
                cfg, state, cop)
            it2 = p.it_w + srv_it
            fac2 = p.facility_w + srv_in + srv_cool
            p = p._replace(
                it_w=it2, input_w=p.input_w + srv_in,
                cooling_w=p.cooling_w + srv_cool, facility_w=fac2,
                pue=torch.where(it2 > 1.0, fac2 / torch.clamp(it2, min=1.0),
                                1.0))
            idle_total = idle_total + srv_idle

        # --- demand response: DVFS-throttle to the facility power cap;
        # `capped` gates the rescale exactly off when uncapped
        capped = cap_w > 0.0
        dyn = torch.clamp(p.it_w - idle_total, min=0.0)
        overhead = p.facility_w / torch.clamp(p.it_w, min=1.0)
        cap_it = cap_w / torch.clamp(overhead, min=1e-6)
        throttle = torch.clamp(
            (cap_it - idle_total) / torch.clamp(dyn, min=1.0),
            cfg.throttle_floor, 1.0)
        throttle = torch.where(capped, throttle, 1.0)
        r = (idle_total + throttle * dyn) / torch.clamp(p.it_w, min=1.0)
        r = torch.where(capped, r, 1.0)
        p = p._replace(
            it_w=p.it_w * r, input_w=p.input_w * r,
            cooling_w=p.cooling_w * r, facility_w=p.facility_w * r,
            gflops=p.gflops * throttle,
        )

        # --- progress (congestion- and throttle-aware)
        rate = rate * throttle[..., None]
        state = state._replace(work_left=state.work_left - rate * cfg.dt)
        e_step = p.facility_w * dt_h / 1000.0                # kWh
        it_step = p.it_w * dt_h / 1000.0
        loss_step = (p.input_w - p.it_w) * dt_h / 1000.0
        cool_step = p.cooling_w * dt_h / 1000.0
        co2_step = e_step * carbon_g / 1000.0                # kg
        cost_step = e_step * price                           # $

        state = state._replace(
            energy_kwh=state.energy_kwh + e_step,
            it_energy_kwh=state.it_energy_kwh + it_step,
            loss_energy_kwh=state.loss_energy_kwh + loss_step,
            cool_energy_kwh=state.cool_energy_kwh + cool_step,
            carbon_kg=state.carbon_kg + co2_step,
            elec_cost_usd=state.elec_cost_usd + cost_step,
            flops_integral=state.flops_integral + p.gflops * cfg.dt,
            sum_power_w=state.sum_power_w + p.facility_w,
            n_steps=state.n_steps + 1.0,
        )

        srv_out = {}
        if cfg.serving_on:
            # --- the continuous request-mass flow, every tick (shared by
            # fast ticks): arrivals, admission, completions, SLO ledger
            (state, srv_arr, srv_comp, srv_viol, srv_w, srv_q,
             srv_hist) = srv.serving_flow(cfg, state, statics, throttle)
            srv_out = dict(
                srv_arrived_step=srv_arr, srv_completed_step=srv_comp,
                srv_shed_step=shed_now, srv_dropped_step=dropped_now,
                srv_retried_step=retried_now, srv_slo_viol_step=srv_viol,
                srv_latency_s=srv_w, srv_queue_len=srv_q,
                srv_active_nodes=state.srv_active,
                srv_lat_hist_step=srv_hist)

        if cfg.thermal_enabled:
            # --- rack RC update on the post-cap per-node input power,
            # committed LAST so this tick's derate used the pre-update temps
            state, th_step, rack_max = thm.rack_tick(
                racks, state, p.node_input_w, r, wb)
        else:
            rack_max = torch.amax(state.rack_outlet_c, -1)
            th_step = zero

        # reward: throughput-positive, energy/carbon/queue-negative,
        # normalized to O(1) per step; with the fault engine on, the
        # lost-work penalty charges the node-seconds a kill destroyed
        # against the tick's node-second budget
        reward = (
            w_thr * n_done
            - w_en * e_step / en_scale * 0.1
            - w_co2 * co2_step / co2_scale * 0.1
            - w_q * queued * 0.01
            - w_cost * cost_step / cost_scale * 0.1
        )
        if cfg.resilience_on:
            reward = reward - w_lost * lost_now / lost_scale
        if cfg.serving_on:
            # the SLO penalty: shed and dropped mass counts as violated,
            # so shedding out of latency trouble still pays
            reward = reward - w_slo * (
                srv_out["srv_slo_viol_step"] + shed_now + dropped_now
            ) / srv_scale

        out = StepOut(
            facility_w=p.facility_w, it_w=p.it_w, pue=p.pue, util=util,
            queue_len=queued, running=running, completed_now=n_done,
            energy_kwh_step=e_step, carbon_kg_step=co2_step,
            net_load=net_load, reward=reward,
            carbon_gkwh=carbon_g, price_usd_kwh=price, power_cap_w=cap_w,
            cost_usd_step=cost_step, throttle=throttle,
            rack_max_c=rack_max, cop=cop, thermal_throttle_s_step=th_step,
            killed_now=killed_now, lost_node_s_step=lost_now,
            degrade_level=dg_level, **srv_out,
        )
        return state, out

    return tail


def _counts_and_util(state: SimState, statics: Statics):
    """(queued, running, util) telemetry, one per replica."""
    running = torch.sum(state.jstate == RUNNING, -1).to(torch.float32)
    queued = torch.sum(sched.queued_mask(state), -1).to(torch.float32)
    up = torch.clamp(torch.sum(state.node_up, -1), min=1.0)
    busy = torch.sum(
        (statics.capacity[0] - state.free[..., 0, :])
        / torch.clamp(statics.capacity[0], min=1e-6) * state.node_up, -1)
    return queued, running, busy / up


def _complete_jobs(cfg: SimConfig,
                   state: SimState) -> Tuple[SimState, torch.Tensor]:
    done_now = (state.jstate == RUNNING) & (state.work_left <= 0.0)
    free = _release(state.free, state, done_now)
    t = state.t[..., None]
    wait = torch.clamp(state.start_t - state.submit_t, min=0.0)
    run = torch.clamp(t - state.start_t, min=cfg.dt)
    slowdown = torch.clamp((wait + run) / run, min=1.0)
    n_done = torch.sum(done_now, -1).to(torch.int32)
    state = state._replace(
        free=free,
        jstate=torch.where(done_now, DONE, state.jstate).to(torch.int32),
        end_t=torch.where(done_now, t, state.end_t),
        placement=torch.where(done_now[..., None], -1, state.placement),
        n_completed=state.n_completed + n_done,
        sum_wait=state.sum_wait
        + torch.sum(torch.where(done_now, wait, 0.0), -1),
        sum_slowdown=state.sum_slowdown
        + torch.sum(torch.where(done_now, slowdown, 0.0), -1),
    )
    return state, n_done


def _try_start(cfg: SimConfig, state: SimState, job: torch.Tensor,
               place_fn) -> SimState:
    """Attempt to place & start each replica's `job` via the placement
    stage `place_fn` (state, job) -> (row, ok); no-op where job < 0 or
    infeasible."""
    j = torch.clamp(job, min=0)
    row, ok = place_fn(state, j)
    js = take(state.jstate, j)
    ok = ok & (job >= 0) & (js == QUEUED)
    valid = (row >= 0) & ok[..., None]                      # (..., K)
    safe = torch.where(valid, row, 0).long()
    amounts = (take(state.req, j, dim=-1)[..., None]
               * valid[..., None, :])                        # (..., R, K)
    # scatter_add accumulates duplicate ids (invalid slots all point at
    # node 0 with a zero amount); a job's own nodes are distinct, so the
    # sum is exact in any order
    free = state.free.scatter_add(
        -1, safe[..., None, :].expand(amounts.shape), -amounts)
    return state._replace(
        free=torch.where(ok[..., None, None], free, state.free),
        jstate=put(state.jstate, j, torch.where(ok, RUNNING, js)),
        start_t=put(state.start_t, j,
                    torch.where(ok, state.t, take(state.start_t, j))),
        placement=put(state.placement, j, torch.where(
            ok[..., None], torch.where(valid, row, -1),
            take(state.placement, j))),
    )


def _policy_use(ids_host: np.ndarray, ids: dict, dev: torch.device) -> dict:
    """{strategy name: replicas that run it} for the strategies that a
    Policy's host-side ids name (``None`` for a lone one, which needs no
    select); the masks go to ``dev`` once, without a sync."""
    names = [n for n, i in ids.items() if (ids_host == i).any()]
    if len(names) == 1:
        return {names[0]: None}
    return {n: to_device(torch.from_numpy(ids_host == ids[n]), dev)
            for n in names}


def make_step(
    cfg: SimConfig,
    statics: Statics,
    scheduler: str | Policy = "fcfs",
    *,
    placement: str | None = None,
    starts_per_step: int = 2,
    reward_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.05),
):
    """Returns step(state, action) -> (state, StepOut), for one state or a
    fleet's (a leading replica axis E; ``statics.scenario`` batched alike).

    ``scheduler``: a selection name ('replay'|'fcfs'|'sjf'|'priority'|
    'easy'), 'rl' (external action-driven selection: one action per
    replica), 'none' (no dispatch at all), or a ``placement.Policy`` of
    host-side (select, place) ids, one per replica: the step runs the
    strategies those ids name on every replica and keeps each replica's
    own result (the Policy carries the placement, so combining it with
    ``placement=`` is an error). ``placement``: node-placement strategy name
    (``core.placement``) for the string modes; default 'first_fit'.
    ``action``: for 'rl', an int index into ``rl_candidates`` (k = no-op),
    a Python int or an integer tensor of the state's replica shape (0-d
    or (E,)); ignored otherwise.
    """
    dev = statics.capacity.device
    policy_mode = isinstance(scheduler, Policy)
    if policy_mode:
        if placement is not None:
            raise ConfigError(
                f"both a Policy scheduler and placement={placement!r} given "
                "— the Policy carries the placement id, so the string would "
                "be silently ignored; pass exactly one")
        if scheduler.select.device.type != "cpu":
            raise ConfigError(
                "a Policy's ids are host data: keep them on the CPU "
                "(make_policy, stack_policies, policy_grid)")
        select_use = _policy_use(scheduler.select.numpy(), sched.SELECT_IDS,
                                 dev)
        place_use = _policy_use(scheduler.place.numpy(), plc.PLACE_IDS, dev)
    else:
        if scheduler not in ("rl", "none") \
                and scheduler not in sched.SCHEDULERS:
            raise KeyError(f"unknown scheduler {scheduler}")
        if placement is None:
            placement = "first_fit"
        if placement not in plc.PLACEMENTS:
            raise KeyError(f"unknown placement {placement}")
        select_use = ({} if scheduler in ("rl", "none")
                      else {scheduler: None})
        place_use = {placement: None}
    tail = _make_tail(cfg, statics, reward_weights)
    power_statics = tick_statics(cfg, statics)
    dispatch = policy_mode or scheduler != "none"

    def step(state: SimState, action) -> Tuple[SimState, StepOut]:
        state = state._replace(t=state.t + cfg.dt)
        killed_now = lost_now = shed_now = dropped_now = retried_now = None
        if cfg.resilience_on:
            state, killed_now, lost_now = flt.apply_faults(cfg, state,
                                                           statics)
        if cfg.serving_on:
            # the serving overload ladder (a bitwise fixpoint on a quiet
            # tick)
            state, shed_now, dropped_now, retried_now = srv.apply_serving(
                cfg, state, statics)
        state, n_done = _complete_jobs(cfg, state)

        # --- dispatch. Selection and placement see tripped racks' nodes
        # as down, and every node as down while the ladder is at GATE or
        # above (no NEW jobs there); candidates, eligibility masks, power
        # and progress read the raw state. Dispatch moves neither the
        # racks' temperatures nor the ladder, so both are read once per
        # tick.
        if (cfg.thermal_enabled or cfg.resilience_on) and dispatch:
            trip_ok = (thm.node_trip_ok(cfg, state, statics)
                       if cfg.thermal_enabled else None)
            gated = ((flt.effective_level(cfg, state, statics)
                      >= flt.LVL_GATE)[..., None]
                     if cfg.resilience_on else None)

            def view(s: SimState) -> SimState:
                nu = s.node_up
                if trip_ok is not None:
                    nu = torch.where(trip_ok, nu, 0.0)
                if gated is not None:
                    nu = torch.where(gated, 0.0, nu)
                return s._replace(node_up=nu)
        else:
            def view(s: SimState) -> SimState:
                return s

        def place_fn(s: SimState, j: torch.Tensor):
            return plc.place_job(view(s), statics, j, place_use)

        if not policy_mode and scheduler == "rl":
            # each replica dispatches its own candidate (action >= k: none)
            cands = sched.rl_candidates(cfg, state)          # (..., k)
            k = cands.shape[-1]
            if not isinstance(action, torch.Tensor):
                action = full(int(action), torch.int64, dev)
            job = torch.where(
                action < k, take(cands, torch.clamp(action, 0, k - 1)),
                -1).long()
            state = _try_start(cfg, state, job, place_fn)
        elif dispatch:
            # eligibility depends only on part/node_type, so it is
            # computed once per step, not per dispatch attempt
            node_mask = plc.placement_node_mask(state, statics, place_use)
            for _ in range(starts_per_step):
                job = sched.select_job(cfg, view(state), statics,
                                       select_use, node_mask)
                state = _try_start(cfg, state, job, place_fn)

        # --- grid signals at t (dispatch does not move t), the power
        # chain (pre-cap; with thermals derated), progress rate and
        # telemetry counts
        signals = _grid_signals(statics, state.t)
        p, cop, idle_total, job_th = power_tick(power_statics, state,
                                                signals[3])
        rate, net_load = congestion_slowdown(cfg, state, statics)
        queued, running, util = _counts_and_util(state, statics)
        return tail(state, signals, p, cop, idle_total, job_th, rate,
                    net_load, n_done, queued, running, util, killed_now,
                    lost_now, shed_now, dropped_now, retried_now)

    return step


class TelemetrySummary(NamedTuple):
    """Windowed reductions of ``StepOut``: constant-memory telemetry.

    Totals are sums over the window; ``mean_*`` are per-step means and
    ``max_*`` maxima. ``n_steps`` is the window length.
    """

    completed: torch.Tensor
    energy_kwh: torch.Tensor
    carbon_kg: torch.Tensor
    cost_usd: torch.Tensor
    reward: torch.Tensor
    thermal_throttle_s: torch.Tensor
    killed: torch.Tensor
    lost_node_s: torch.Tensor
    srv_arrived: torch.Tensor
    srv_completed: torch.Tensor
    srv_shed: torch.Tensor
    srv_dropped: torch.Tensor
    srv_retried: torch.Tensor
    srv_slo_viol: torch.Tensor
    srv_lat_sum: torch.Tensor
    srv_lat_hist: torch.Tensor    # (8,)
    mean_facility_w: torch.Tensor
    mean_it_w: torch.Tensor
    mean_pue: torch.Tensor
    mean_util: torch.Tensor
    mean_queue_len: torch.Tensor
    mean_running: torch.Tensor
    mean_net_load: torch.Tensor
    mean_carbon_gkwh: torch.Tensor
    mean_price_usd_kwh: torch.Tensor
    mean_throttle: torch.Tensor
    mean_cop: torch.Tensor
    max_facility_w: torch.Tensor
    max_queue_len: torch.Tensor
    max_rack_c: torch.Tensor
    n_steps: torch.Tensor
    macro_steps: torch.Tensor


_SRV_TELEM = ("srv_arrived", "srv_completed", "srv_shed", "srv_dropped",
              "srv_retried", "srv_slo_viol", "srv_lat_sum", "srv_lat_hist")
_FAULT_TELEM = ("killed", "lost_node_s")


def _telem_zero(device: torch.device, lead=(), resilience_on: bool = False,
                serving_on: bool = False) -> TelemetrySummary:
    """Zero accumulator, one per replica (``lead``: the state's replica
    shape); the fault and serving fields, while their models are off,
    ride as ``None`` (restored to zeros by ``_telem_finalize``)."""
    z = torch.zeros(lead, dtype=torch.float32, device=device)
    acc = TelemetrySummary(*([z] * len(TelemetrySummary._fields)))
    off = ((() if serving_on else _SRV_TELEM)
           + (() if resilience_on else _FAULT_TELEM))
    if serving_on:
        acc = acc._replace(srv_lat_hist=torch.zeros(
            lead + (8,), dtype=torch.float32, device=device))
    return acc._replace(**{f: None for f in off})


def _telem_update(acc: TelemetrySummary, out: StepOut,
                  macro_inc: float = 1.0) -> TelemetrySummary:
    # mean_* fields hold running sums until _telem_finalize divides by n;
    # ``macro_inc`` is 1 for a full (event) tick and 0 for a fast tick;
    # the kills and lost work accumulate where the fault engine runs, the
    # request mass where the serving twin does
    if acc.killed is not None:
        acc = acc._replace(
            killed=acc.killed + out.killed_now,
            lost_node_s=acc.lost_node_s + out.lost_node_s_step)
    if acc.srv_arrived is not None:
        acc = acc._replace(
            srv_arrived=acc.srv_arrived + out.srv_arrived_step,
            srv_completed=acc.srv_completed + out.srv_completed_step,
            srv_shed=acc.srv_shed + out.srv_shed_step,
            srv_dropped=acc.srv_dropped + out.srv_dropped_step,
            srv_retried=acc.srv_retried + out.srv_retried_step,
            srv_slo_viol=acc.srv_slo_viol + out.srv_slo_viol_step,
            srv_lat_sum=acc.srv_lat_sum
            + out.srv_completed_step * out.srv_latency_s,
            srv_lat_hist=acc.srv_lat_hist + out.srv_lat_hist_step)
    return acc._replace(
        completed=acc.completed + out.completed_now,
        energy_kwh=acc.energy_kwh + out.energy_kwh_step,
        carbon_kg=acc.carbon_kg + out.carbon_kg_step,
        cost_usd=acc.cost_usd + out.cost_usd_step,
        reward=acc.reward + out.reward,
        thermal_throttle_s=acc.thermal_throttle_s
        + out.thermal_throttle_s_step,
        mean_facility_w=acc.mean_facility_w + out.facility_w,
        mean_it_w=acc.mean_it_w + out.it_w,
        mean_pue=acc.mean_pue + out.pue,
        mean_util=acc.mean_util + out.util,
        mean_queue_len=acc.mean_queue_len + out.queue_len,
        mean_running=acc.mean_running + out.running,
        mean_net_load=acc.mean_net_load + out.net_load,
        mean_carbon_gkwh=acc.mean_carbon_gkwh + out.carbon_gkwh,
        mean_price_usd_kwh=acc.mean_price_usd_kwh + out.price_usd_kwh,
        mean_throttle=acc.mean_throttle + out.throttle,
        mean_cop=acc.mean_cop + out.cop,
        max_facility_w=torch.maximum(acc.max_facility_w, out.facility_w),
        max_queue_len=torch.maximum(acc.max_queue_len, out.queue_len),
        max_rack_c=torch.maximum(acc.max_rack_c, out.rack_max_c),
        n_steps=acc.n_steps + 1.0,
        macro_steps=acc.macro_steps + macro_inc,
    )


def _telem_finalize(acc: TelemetrySummary) -> TelemetrySummary:
    n = torch.clamp(acc.n_steps, min=1.0)
    acc = acc._replace(**{
        f: getattr(acc, f) / n
        for f in TelemetrySummary._fields if f.startswith("mean_")
    })
    z = torch.zeros_like(acc.n_steps)
    off = {f: z for f in _FAULT_TELEM + _SRV_TELEM[:-1]
           if getattr(acc, f) is None}
    if acc.srv_lat_hist is None:
        off["srv_lat_hist"] = torch.zeros(z.shape + (8,),
                                          dtype=torch.float32,
                                          device=z.device)
    return acc._replace(**off)


def _stack(items: List[NamedTuple], dim: int = 0):
    """Stack a list of NamedTuples leaf-wise along a new axis ``dim``
    (after a fleet's replica axis)."""
    first = items[0]
    return type(first)(*(
        None if v is None else torch.stack([getattr(it, f) for it in items],
                                           dim)
        for f, v in zip(first._fields, first)))


# ---------------------------------------------------------------------------
# Macro-stepping: fast-forward quiet ticks with exact segment accounting.
#
# A tick is QUIET when advancing it changes no machine state: no queued job
# becomes newly visible or eligible to selection, no running job completes,
# no node returns from repair, no cap-schedule breakpoint is crossed, and
# the last dispatch attempt proved the current queue unservable. Across a
# quiet segment the running set, placement, free pool and congestion rate
# are constant; only time, work left, the accumulators and the racks move.
# A fast tick re-runs the grid signals, ``power_tick`` and the step's tail
# on the frozen segment and skips completions, dispatch and the telemetry
# counts.

_BIG_T = float("inf")

# SimState fields a fast tick may change; every other keeps its
# segment-start value, so the commit touches only these
_FAST_FIELDS = (
    "t", "work_left", "energy_kwh", "it_energy_kwh", "loss_energy_kwh",
    "cool_energy_kwh", "carbon_kg", "elec_cost_usd", "flops_integral",
    "sum_power_w", "n_steps",
)

# how many event and fast ticks the macro engine issued (host counts: a
# fast tick is issued for every replica, and commits only where its mask
# is open), like ``kernels.LAUNCHES``
MACRO_TICKS: dict[str, int] = {"event": 0, "fast": 0}
# the profiler range each kind of tick runs in, so the tick tools
# (``tools/profile_tick.py``, ``tools/tick_ops.py``) count them apart
TICK_RANGES = {"event": "macro::event tick", "fast": "macro::fast tick"}


def reset_macro_ticks() -> None:
    for k in MACRO_TICKS:
        MACRO_TICKS[k] = 0


def _fast_fields(cfg: SimConfig) -> tuple:
    """Fast-tick-mutable SimState fields for this config: the thermal
    carry joins when the cooling loop is on, the serving flow's when the
    serving twin is."""
    ff = _FAST_FIELDS
    if cfg.thermal_enabled:
        ff = ff + ("rack_outlet_c", "thermal_throttle_s", "peak_rack_c")
    if cfg.serving_on:
        ff = ff + ("srv_queue", "srv_inflight", "srv_arrived",
                   "srv_completed", "srv_slo_viol", "srv_lat_sum",
                   "srv_lat_hist")
    return ff


def _horizon_parts(cfg: SimConfig, state: SimState, statics: Statics,
                   rate: torch.Tensor | None, dispatch_on: bool,
                   replay_gated: bool, eligibility_vis: bool,
                   max_ticks: int):
    """(next_event_t, visible_now, k_time, k_complete), one each per
    replica: the earliest deterministic breakpoint strictly after
    ``state.t``, whether a dispatch-visible queued job exists now, and the
    conservative quiet-tick counts from time events and from completions
    (``None`` without ``rate``). With the fault engine on, the next fault
    clock crossing or outage-window edge (``faults.next_fault_event``)
    joins the time events, and with the serving twin on the wake
    completion, the retry re-injections and the burst edges
    (``serving.next_serving_event``)."""
    t = state.t
    tt = t[..., None]
    dev = t.device
    q = state.jstate == QUEUED
    # arrivals: the queued count (telemetry and reward) changes when a
    # submit time is crossed; selection visibility changes with it
    next_t = torch.amin(torch.where(q & (state.submit_t > tt),
                                    state.submit_t, _BIG_T), -1)
    visible_now = torch.zeros(t.shape, dtype=torch.bool, device=dev)
    if dispatch_on:
        vis_t = state.submit_t
        if eligibility_vis:
            # eager replay: a queued job is only dispatchable once both
            # its submit and its recorded start (priority) are crossed
            vis_t = torch.maximum(state.submit_t, state.priority)
        visible_now = torch.any(q & (vis_t <= tt), -1)
    if dispatch_on and replay_gated:
        # replay eligibility: a queued job becomes dispatchable when its
        # recorded start (carried in ``priority``) is crossed
        next_t = torch.minimum(next_t, torch.amin(torch.where(
            q & (state.priority > tt), state.priority, _BIG_T), -1))
    # node repairs return capacity at recorded times
    next_t = torch.minimum(next_t, torch.amin(torch.where(
        state.node_up < 0.5, state.repair_t, _BIG_T), -1))
    # demand-response cap windows open and close at schedule breakpoints
    next_t = torch.minimum(next_t,
                           next_cap_event(statics.scenario.power_cap, t))
    if cfg.resilience_on:
        # event-sampled fault clocks and outage-window edges are exact
        # breakpoints (core.faults keeps every clock strictly future)
        next_t = torch.minimum(
            next_t, flt.next_fault_event(cfg, state, statics, t))
    if cfg.serving_on:
        # the serving clocks: the ladder runs on full ticks only
        next_t = torch.minimum(
            next_t, srv.next_serving_event(cfg, state, statics, t))

    kf = float(max_ticks)
    # true divisions by the tick length (a device tensor divisor)
    dt = full(cfg.dt, torch.float32, dev)
    k_time = torch.where(torch.isfinite(next_t),
                         torch.floor((next_t - t) / dt - 1e-6), kf)
    k_time = torch.clamp(k_time, 0.0, kf).to(torch.int32)
    if rate is None:
        return next_t, visible_now, k_time, None
    # completions: per-tick progress never exceeds rate * dt (throttle <=
    # 1), so floor(work / (rate * dt)) - 1 ticks can never cross zero
    ticks_c = torch.where(
        state.jstate == RUNNING,
        torch.floor(state.work_left / (torch.clamp(rate, min=1e-9) * dt))
        - 1.0, kf)
    k_complete = torch.clamp(torch.amin(ticks_c, -1), 0.0, kf)
    return next_t, visible_now, k_time, k_complete.to(torch.int32)


def _modes(scheduler) -> Tuple[bool, bool, bool]:
    """(dispatch_on, replay_gated, eligibility_vis) of a scheduler."""
    policy_mode = isinstance(scheduler, Policy)
    return (policy_mode or scheduler != "none",
            policy_mode or scheduler == "replay",
            (not policy_mode) and scheduler == "replay")


def quiet_horizon(
    cfg: SimConfig,
    statics: Statics,
    state: SimState,
    scheduler: str | Policy = "fcfs",
    *,
    max_ticks: int = 4096,
    assume_undispatchable: bool | torch.Tensor = False,
) -> torch.Tensor:
    """Ticks after ``state.t`` guaranteed quiet (int32 >= 0, one per
    replica): the min over the next arrival, the next replay-eligibility
    crossing, the next completion (conservative: full-rate progress less
    one tick of float margin), the next node repair, the next
    cap-schedule breakpoint and, with the fault engine on, the next fault
    clock crossing or outage-window edge, clamped to ``max_ticks``.

    A visible queued job forces 0 (selection might start one any tick)
    unless ``assume_undispatchable``: the caller has just run a dispatch
    tick that started nothing, which proves the visible queue unservable
    for a frozen machine state. With ``cfg.thermal_enabled`` and dispatch
    on, ``thermal.thermal_crossing_horizon`` joins the min (the trip gate
    makes dispatch depend on rack temperatures). With ``cfg.serving_on``
    so does ``serving.serving_crossing_horizon``, and a queue already over
    an overload threshold (``serving.serving_trigger``) forces 0."""
    dispatch_on, replay_gated, eligibility_vis = _modes(scheduler)
    rate, _ = congestion_slowdown(cfg, state, statics)
    _, visible_now, k_time, k_complete = _horizon_parts(
        cfg, state, statics, rate, dispatch_on, replay_gated,
        eligibility_vis, max_ticks)
    blocked = visible_now & ~torch.as_tensor(assume_undispatchable,
                                             device=state.t.device)
    horizon = torch.where(blocked, 0, torch.minimum(k_time, k_complete))
    if cfg.thermal_enabled and dispatch_on:
        horizon = torch.minimum(horizon, thm.thermal_crossing_horizon(
            cfg, statics, state, max_ticks))
    if cfg.serving_on:
        horizon = torch.minimum(horizon, srv.serving_crossing_horizon(
            cfg, state, statics, max_ticks))
        horizon = torch.where(srv.serving_trigger(cfg, state), 0, horizon)
    return horizon.to(torch.int32)


def _where_leaf(pred: torch.Tensor, old: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """``old`` where ``pred`` (one per replica), else ``new``."""
    return torch.where(pred.reshape(pred.shape + (1,) * (old.dim()
                                                         - pred.dim())),
                       old, new)


def _where_tree(pred: torch.Tensor, old, new):
    """``_where_leaf`` over a NamedTuple or dict of tensors (``None``
    leaves stay ``None``)."""
    if isinstance(old, dict):
        return {k: _where_tree(pred, v, new[k]) for k, v in old.items()}
    if old is None:
        return None
    if isinstance(old, torch.Tensor):
        return _where_leaf(pred, old, new)
    return type(old)(*(_where_tree(pred, a, b) for a, b in zip(old, new)))


def make_macro_step(
    cfg: SimConfig,
    statics: Statics,
    scheduler: str | Policy = "fcfs",
    *,
    placement: str | None = None,
    starts_per_step: int = 2,
    reward_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.05),
    horizon_cap: int = 4096,
    chunk_ticks: int = 16,
    update=None,
):
    """Returns ``macro_step(state, acc, max_ticks) -> (state, acc, ticks)``:
    one full event tick (``make_step``'s, with action -1), then the quiet
    segment after it fast-forwarded, never past ``max_ticks`` ticks (an
    int, or one per replica); ``ticks`` (int32, one per replica) counts
    both. ``macro_step.run(state, acc, n)`` drives macro steps until every
    replica has taken ``n`` ticks, and returns (state, acc).

    For one state or a fleet's, in lockstep: each macro step runs the
    event tick on every replica that has ticks left (masked for the
    rest), then fast ticks under a per-replica ``go`` mask, which closes
    where that replica's segment ends. The host reads, through
    ``utils.device.host_read``, the largest budget and the ticks left
    after the event tick, then issues fast ticks in chunks of
    ``chunk_ticks``, reading after each whether any replica goes on: at
    most 1 + ceil(segment / chunk_ticks) reads a macro step. Ticks issued
    after a replica stopped change nothing of it.

    A fast tick evaluates the grid signals at its time, runs
    ``power_tick`` and the step's tail with the segment's rate, network
    load and telemetry counts, and commits only the fast fields, where
    its replica goes on. It stops (uncommitted) where a running job has
    finished or the next event time is reached; with thermals and
    dispatch on, the segment also ends on the tick a rack crosses the
    trip, and its budget is capped by ``thermal_crossing_horizon``. With
    the serving twin on, a segment ends on the tick its committed queue
    crosses an overload threshold (``serving_trigger``; the next full
    tick's ladder moves mass), its budget is capped by
    ``serving_crossing_horizon``, and an event tick that leaves the queue
    over a threshold allows no fast tick. Job and queue state equal the
    per-tick path's, and so do the accumulators: a fast tick runs the
    same ``power_tick`` and tail.

    ``update(acc, out, macro_inc)`` folds each tick's ``StepOut`` into the
    caller's accumulator (default: the ``TelemetrySummary`` update;
    ``SchedEnv`` passes its info reducer); ``macro_inc`` is 1.0 for the
    event tick and 0.0 for fast ticks."""
    step = make_step(cfg, statics, scheduler, placement=placement,
                     starts_per_step=starts_per_step,
                     reward_weights=reward_weights)
    tail = _make_tail(cfg, statics, reward_weights)
    power_statics = tick_statics(cfg, statics)
    dispatch_on, replay_gated, eligibility_vis = _modes(scheduler)
    # the trip gate makes dispatch depend on rack temperatures, which keep
    # moving across fast ticks: a segment ends on the tick a rack crosses
    # the trip (either way). Stopping after the crossing tick is exact: a
    # tick's dispatch reads the temperatures its predecessor committed.
    # Without dispatch nothing reads the trip.
    thermal_gate = cfg.thermal_enabled and dispatch_on
    trip_c = cfg.thermal_trip_c
    fast_fields = _fast_fields(cfg)
    chunk = max(int(chunk_ticks), 1)
    dev = statics.capacity.device
    action = full(-1, torch.int64, dev)
    if update is None:
        update = _telem_update

    def event(state, acc, left, active):
        """The event tick and the segment's constants: (state, acc, left
        after the tick, budget, frozen inputs of the fast ticks)."""
        new, out = step(state, action)
        new_acc = update(acc, out, 1.0)
        MACRO_TICKS["event"] += 1
        if active is None:
            state, acc, left = new, new_acc, left - 1
        else:
            state = _where_tree(~active, state, new)
            acc = _where_tree(~active, acc, new_acc)
            left = left - active.to(torch.int32)
        # a start is a running job whose start time is this tick's: with
        # the fault engine on, a job killed (and requeued) by this tick's
        # faults can restart in its dispatch, which a "queued before the
        # tick" test would miss
        started = torch.any((state.jstate == RUNNING)
                            & (state.start_t == state.t[..., None]), -1)
        # the segment's frozen inputs: the event tick's own telemetry
        # counts and network load (its tail moved none of their inputs)
        # and the pre-throttle progress rate
        rate, _ = congestion_slowdown(cfg, state, statics)
        next_t, visible_now, k_time, _ = _horizon_parts(
            cfg, state, statics, None, dispatch_on, replay_gated,
            eligibility_vis, horizon_cap)
        # dispatch gate: a start with jobs still visible may have made the
        # leftovers servable, so step on per tick; a start that drained
        # the queue, or no start with a visible queue (proven unservable),
        # both allow fast-forward. Completions are peeked per fast tick,
        # so the budget carries only the time events (and the thermal
        # horizon) and the ticks left (``left`` counts this event tick).
        k_quiet = torch.minimum(k_time, left)
        if thermal_gate:
            k_quiet = torch.minimum(k_quiet, thm.thermal_crossing_horizon(
                cfg, statics, state, horizon_cap))
        blocked = started & visible_now
        if cfg.serving_on:
            # the arrival envelope's bound on a queue crossing, and per
            # tick while the queue sits over a threshold (the next tick's
            # ladder moves mass): overload is the event
            k_quiet = torch.minimum(k_quiet, srv.serving_crossing_horizon(
                cfg, state, statics, horizon_cap))
            blocked = blocked | srv.serving_trigger(cfg, state)
        budget = torch.where(blocked, 0, k_quiet)
        if active is not None:
            budget = torch.where(active, budget, 0)
        budget = torch.clamp(budget, min=0)
        zero_done = torch.zeros(state.t.shape, dtype=torch.int32, device=dev)
        seg = (rate, out.net_load, out.queue_len, out.running, out.util,
               next_t, budget, zero_done)
        return state, acc, left, budget, seg

    def fast(state, acc, seg, go, took):
        """One fast tick, committed where ``go`` and no stop is peeked."""
        rate, net_load, queued, running, util, next_t, budget, zero = seg
        t_next = state.t + cfg.dt
        # authoritative and side-effect free: a finished job or the next
        # event time leaves the tick to the next event tick
        stop = (~go | torch.any((state.jstate == RUNNING)
                                & (state.work_left <= 0.0), -1)
                | (t_next >= next_t))
        sn = state._replace(t=t_next)
        signals = _grid_signals(statics, t_next)
        p, cop, idle_total, job_th = power_tick(power_statics, sn,
                                                signals[3])
        ns, out = tail(sn, signals, p, cop, idle_total, job_th, rate,
                       net_load, zero, queued, running, util)
        MACRO_TICKS["fast"] += 1
        was_hot = state.rack_outlet_c >= trip_c if thermal_gate else None
        state = state._replace(**{
            f: _where_leaf(stop, getattr(state, f), getattr(ns, f))
            for f in fast_fields})
        acc = _where_tree(stop, acc, update(acc, out, 0.0))
        took = took + (~stop).to(torch.int32)
        go = ~stop & (took < budget)
        if thermal_gate:       # authoritative trip-crossing breakpoint
            go = go & ~torch.any((state.rack_outlet_c >= trip_c) != was_hot,
                                 -1)
        if cfg.serving_on:     # authoritative overload breakpoint
            go = go & ~srv.serving_trigger(cfg, state)
        return state, acc, go, took

    def advance(state, acc, left, active):
        """One macro step for the replicas with ``left`` > 0 (all of them
        when ``active`` is None): returns (state, acc, ticks taken, ticks
        left, and the host's (min, max) of the ticks left)."""
        with record_function(TICK_RANGES["event"]):
            state, acc, left, budget, seg = event(state, acc, left, active)
        ticks = (torch.ones_like(left) if active is None
                 else active.to(torch.int32))
        bmax, lo, hi = (int(v) for v in host_read(torch.stack(
            [torch.amax(budget), torch.amin(left), torch.amax(left)])))
        if bmax > 0:
            go = budget > 0
            took = torch.zeros_like(budget)
            issued = 0
            while True:
                n = min(chunk, bmax - issued)
                for _ in range(n):
                    with record_function(TICK_RANGES["fast"]):
                        state, acc, go, took = fast(state, acc, seg, go,
                                                    took)
                issued += n
                rest = left - took
                any_go, lo, hi = (int(v) for v in host_read(torch.stack(
                    [torch.any(go).to(torch.int32), torch.amin(rest),
                     torch.amax(rest)])))
                if not any_go or issued >= bmax:
                    break
            left, ticks = left - took, ticks + took
        return state, acc, ticks, left, lo, hi

    def macro_step(state, acc, max_ticks):
        shape = tuple(state.t.shape)
        if isinstance(max_ticks, torch.Tensor):
            left = max_ticks.to(device=dev, dtype=torch.int32).expand(
                shape).clone()
        else:
            left = torch.full(shape, int(max_ticks), dtype=torch.int32,
                              device=dev)
        state, acc, ticks, _, _, _ = advance(state, acc, left, None)
        return state, acc, ticks

    def run(state, acc, n: int):
        left = torch.full(tuple(state.t.shape), n, dtype=torch.int32,
                          device=dev)
        lo = hi = n
        while hi > 0:
            # replicas with no ticks left sit out the event tick
            active = None if lo > 0 else left > 0
            state, acc, _, left, lo, hi = advance(state, acc, left, active)
        return state, acc

    macro_step.run = run
    return macro_step


def run_episode(
    cfg: SimConfig,
    statics: Statics,
    state: SimState,
    n_steps: int,
    scheduler: str = "fcfs",
    *,
    telemetry_every: int = 1,
    summary_only: bool = False,
    macro: bool = False,
    snapshot_every_s: float | None = None,
    snapshot_dir: str | None = None,
    resume_from: str | None = None,
    snapshot_keep: int = 3,
    **kw,
):
    """Run ``n_steps`` ticks of the twin under a non-RL policy (a name or
    a ``placement.Policy``), for one state or a fleet's (a leading replica
    axis E on the state and on ``statics.scenario``; ``core.fleet``
    builds them).

    Telemetry modes:
      - default: stacked per-step ``StepOut`` ((n_steps,) per field, (E,
        n_steps) for a fleet);
      - ``telemetry_every=k``: one ``TelemetrySummary`` per k-step window,
        stacked ((n_steps // k,) per field, after the replica axis);
      - ``summary_only=True``: a single episode-wide ``TelemetrySummary``
        accumulated tick by tick — constant memory in ``n_steps``.

    ``macro=True`` drives the episode with ``make_macro_step`` (its
    ``horizon_cap`` and ``chunk_ticks`` pass through ``**kw``): quiet
    ticks are fast-forwarded. Ticks can no longer be stacked one by one,
    so telemetry is episode-wide (``summary_only`` is implied) or windowed
    by ``telemetry_every``, whose window edges clamp the fast-forward, so
    windows stay tick-aligned with the per-tick path.

    The per-tick ticks never synchronise with the host; the macro engine
    reads how far to go through ``utils.device.host_read`` alone. The
    snapshot arguments arrive with the durable slice and raise here.
    """
    if snapshot_every_s is not None or resume_from is not None \
            or snapshot_dir is not None:
        raise NotImplementedError(
            "snapshot/resume arrives with the durable slice (ROADMAP queue "
            "1, item 9)")
    if summary_only and telemetry_every > 1:
        raise ConfigError(
            "summary_only=True is episode-wide; it conflicts with "
            f"telemetry_every={telemetry_every} (pick one)")
    if telemetry_every > 1 and n_steps % telemetry_every:
        raise ConfigError(
            f"n_steps={n_steps} not divisible by "
            f"telemetry_every={telemetry_every}")
    dev = state.t.device
    lead = tuple(state.t.shape)

    def zero():
        return _telem_zero(dev, lead, cfg.resilience_on, cfg.serving_on)

    if macro:
        run = make_macro_step(cfg, statics, scheduler, **kw).run
        if telemetry_every <= 1:
            state, acc = run(state, zero(), n_steps)
            return state, _telem_finalize(acc)
        windows = []
        for _ in range(n_steps // telemetry_every):
            state, acc = run(state, zero(), telemetry_every)
            windows.append(_telem_finalize(acc))
        return state, _stack(windows, len(lead))
    step = make_step(cfg, statics, scheduler, **kw)
    action = full(-1, torch.int64, dev)

    if summary_only:
        acc = zero()
        for _ in range(n_steps):
            state, out = step(state, action)
            acc = _telem_update(acc, out)
        return state, _telem_finalize(acc)
    if telemetry_every > 1:
        windows = []
        for _ in range(n_steps // telemetry_every):
            acc = zero()
            for _ in range(telemetry_every):
                state, out = step(state, action)
                acc = _telem_update(acc, out)
            windows.append(_telem_finalize(acc))
        return state, _stack(windows, len(lead))
    outs = []
    for _ in range(n_steps):
        state, out = step(state, action)
        outs.append(out)
    return state, _stack(outs, len(lead))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def summary_columns(state: SimState,
                    telemetry: TelemetrySummary | None = None) -> dict:
    """Column-wise ``summary``: a dict of float64 numpy arrays with one
    entry per replica for replica-batched states (leading replica axis on
    every field), or 0-d arrays for one state — ``summary`` is that case."""
    s = type(state)(*(None if v is None else _host(v) for v in state))
    batched = np.ndim(s.t) == 1

    def f(a):
        return np.asarray(a, np.float64)

    def reduce_tail(a, op=np.sum):
        # reduce every axis except the replica axis (all when unbatched)
        x = f(a)
        return op(x, axis=tuple(range(1, x.ndim)) if batched else None)

    n = np.maximum(f(s.n_completed), 1.0)
    cols = {
        "t_end_s": f(s.t),
        "completed": f(s.n_completed),
        "killed_by_failures": f(s.n_killed),
        "energy_kwh": f(s.energy_kwh),
        "it_energy_kwh": f(s.it_energy_kwh),
        "loss_energy_kwh": f(s.loss_energy_kwh),
        "cooling_energy_kwh": f(s.cool_energy_kwh),
        "carbon_kg": f(s.carbon_kg),
        "elec_cost_usd": f(s.elec_cost_usd),
        "mean_power_w": f(s.sum_power_w) / np.maximum(f(s.n_steps), 1.0),
        "mean_wait_s": f(s.sum_wait) / n,
        "mean_slowdown": f(s.sum_slowdown) / n,
        "gflops_per_watt": (
            f(s.flops_integral) / 3600.0 / 1000.0
            / np.maximum(f(s.energy_kwh), 1e-9)
        ),
        "avg_pue": f(s.energy_kwh) / np.maximum(f(s.it_energy_kwh), 1e-9),
        "peak_rack_outlet_c": f(s.peak_rack_c),
        "thermal_throttle_s": f(s.thermal_throttle_s),
    }
    # goodput vs throughput: "useful" work is the node-seconds of
    # completed jobs; lost_node_seconds is what kills destroyed
    useful = reduce_tail(
        (np.asarray(s.jstate) == DONE) * f(s.dur_est) * f(s.n_nodes))
    lost = f(s.lost_node_s)
    cols["lost_node_seconds"] = lost
    cols["jobs_failed_terminal"] = f(s.n_failed)
    cols["goodput_node_s"] = useful
    cols["goodput_frac"] = useful / np.maximum(useful + lost, 1e-9)
    # serving ledger (zeros while the serving twin is off)
    n_req = np.maximum(f(s.srv_completed), 1e-9)
    cols["srv_arrived"] = f(s.srv_arrived)
    cols["srv_completed"] = f(s.srv_completed)
    cols["srv_shed"] = f(s.srv_shed)
    cols["srv_dropped"] = f(s.srv_dropped)
    cols["srv_retried"] = f(s.srv_retried)
    cols["srv_mean_latency_s"] = f(s.srv_lat_sum) / n_req
    cols["srv_slo_violation_frac"] = f(s.srv_slo_viol) / n_req
    cols["srv_goodput_requests"] = f(s.srv_completed) - f(s.srv_slo_viol)
    hist = f(s.srv_lat_hist)                    # (..., 8)
    tot = np.maximum(hist.sum(-1, keepdims=True), 1e-9)
    c = np.cumsum(hist, -1) / tot
    # bucket i spans serving_slo_s * [2^(i-4), 2^(i-3)); quantiles at the
    # upper edge in SLO units
    edge = 2.0 ** (np.arange(8, dtype=np.float64) - 3.0)
    any_req = hist.sum(-1) > 0.0
    cols["srv_p50_latency_x_slo"] = np.where(
        any_req, edge[np.argmax(c >= 0.5, axis=-1)], 0.0)
    cols["srv_p99_latency_x_slo"] = np.where(
        any_req, edge[np.argmax(c >= 0.99, axis=-1)], 0.0)
    if telemetry is not None:
        tl = type(telemetry)(*(None if v is None else _host(v)
                               for v in telemetry))
        ticks = reduce_tail(tl.n_steps)
        full_steps = reduce_tail(tl.macro_steps)
        cols["ticks_simulated"] = ticks
        cols["macro_steps_taken"] = full_steps
        cols["macro_skip_ratio"] = ticks / np.maximum(full_steps, 1.0)
        cols["mean_cop"] = (
            reduce_tail(f(tl.mean_cop) * f(tl.n_steps))
            / np.maximum(ticks, 1.0))
        cols["max_rack_outlet_c"] = reduce_tail(tl.max_rack_c, op=np.max)
    return cols


def summary(state: SimState,
            telemetry: TelemetrySummary | None = None) -> dict:
    """Scalar episode summary of one (unbatched) final state."""
    return {k: float(v)
            for k, v in summary_columns(state, telemetry).items()}
