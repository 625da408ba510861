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

The step never reads a tensor on the host (no ``.item()``, no Python
branch on a tensor value), so on the card the ticks queue work without a
single sync. This slice runs with the fault and serving models off and
per-tick stepping; their flags raise ``NotImplementedError`` naming the
ROADMAP slice that brings them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core import placement as plc
from repro_torch.core import schedulers as sched
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
    check_slice,
)
from repro_torch.scenarios.events import power_cap_at
from repro_torch.scenarios.signals import eval_signal
from repro_torch.utils.device import full, put, take, to_device
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


def _parse_weights(reward_weights) -> Tuple[float, float, float, float, float]:
    """(w_thr, w_en, w_co2, w_q, w_cost). The lost-work and SLO weights
    (6th and 7th) belong to the faults and serving slices."""
    if len(reward_weights) not in (4, 5):
        if len(reward_weights) in (6, 7):
            raise NotImplementedError(
                "reward weights w_lost / w_slo arrive with the resilience "
                "and serving slices (ROADMAP queue 1, items 7-8)")
        raise ConfigError(
            "reward_weights must have 4 to 7 entries "
            "(w_thr, w_en, w_co2, w_q[, w_cost[, w_lost[, w_slo]]]); got "
            f"{len(reward_weights)}")
    w_thr, w_en, w_co2, w_q = reward_weights[:4]
    w_cost = reward_weights[4] if len(reward_weights) == 5 else 0.0
    return w_thr, w_en, w_co2, w_q, w_cost


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
    jobs' thermal clock, the DVFS throttle to the power cap, job progress,
    energy/carbon/cost accumulation, the rack RC update (``rack_tick``),
    reward and ``StepOut``. The fault and serving branches arrive with
    their slices."""
    w_thr, w_en, w_co2, w_q, w_cost = _parse_weights(reward_weights)
    dev = statics.capacity.device
    zeros = {}     # the off models' telemetry, one tensor per replica shape
    racks = (thm.rack_tick_statics(cfg, statics) if cfg.thermal_enabled
             else None)
    dt_h = cfg.dt / 3600.0
    en_scale = max(cfg.n_nodes * 0.4 * dt_h, 1e-9)
    co2_scale = max(cfg.n_nodes * 0.15 * dt_h, 1e-9)
    cost_scale = max(cfg.n_nodes * 0.4 * dt_h * cfg.price_mean_usd_kwh, 1e-9)

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
    ) -> Tuple[SimState, StepOut]:
        carbon_g, price, cap_w, wb = signals
        lead = tuple(state.t.shape)
        if lead not in zeros:
            zeros[lead] = torch.zeros(lead, dtype=torch.float32, device=dev)
        zero = zeros[lead]
        if cfg.thermal_enabled:
            # synchronous ranks run at the slowest clock over a job's nodes
            rate = rate * job_th

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

        if cfg.thermal_enabled:
            # --- rack RC update on the post-cap per-node input power,
            # committed LAST so this tick's derate used the pre-update temps
            state, th_step, rack_max = thm.rack_tick(
                racks, state, p.node_input_w, r, wb)
        else:
            rack_max = torch.amax(state.rack_outlet_c, -1)
            th_step = zero

        # reward: throughput-positive, energy/carbon/queue-negative,
        # normalized to O(1) per step
        reward = (
            w_thr * n_done
            - w_en * e_step / en_scale * 0.1
            - w_co2 * co2_step / co2_scale * 0.1
            - w_q * queued * 0.01
            - w_cost * cost_step / cost_scale * 0.1
        )

        out = StepOut(
            facility_w=p.facility_w, it_w=p.it_w, pue=p.pue, util=util,
            queue_len=queued, running=running, completed_now=n_done,
            energy_kwh_step=e_step, carbon_kg_step=co2_step,
            net_load=net_load, reward=reward,
            carbon_gkwh=carbon_g, price_usd_kwh=price, power_cap_w=cap_w,
            cost_usd_step=cost_step, throttle=throttle,
            rack_max_c=rack_max, cop=cop, thermal_throttle_s_step=th_step,
            killed_now=zero, lost_node_s_step=zero, degrade_level=zero,
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
    'easy'), 'rl' (external action-driven selection, one state only),
    'none' (no dispatch at all), or a ``placement.Policy`` of host-side
    (select, place) ids, one per replica: the step runs the strategies
    those ids name on every replica and keeps each replica's own result
    (the Policy carries the placement, so combining it with ``placement=``
    is an error). ``placement``: node-placement strategy name
    (``core.placement``) for the string modes; default 'first_fit'.
    ``action``: for 'rl', an int index into ``rl_candidates`` (k = no-op);
    ignored otherwise.
    """
    check_slice(cfg)
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
        state, n_done = _complete_jobs(cfg, state)

        # --- dispatch. Selection and placement see tripped racks' nodes
        # as down (no NEW jobs there); candidates, eligibility masks, power
        # and progress read the raw state. Dispatch moves no rack
        # temperature, so the trip is read once per tick.
        if cfg.thermal_enabled and dispatch:
            trip_ok = thm.node_trip_ok(cfg, state, statics)

            def view(s: SimState) -> SimState:
                return s._replace(node_up=torch.where(trip_ok, s.node_up, 0.0))
        else:
            def view(s: SimState) -> SimState:
                return s

        def place_fn(s: SimState, j: torch.Tensor):
            return plc.place_job(view(s), statics, j, place_use)

        if not policy_mode and scheduler == "rl":
            if state.t.dim():
                raise NotImplementedError(
                    "scheduler='rl' on a fleet's state: batched RL "
                    "environments arrive with the RL slice (ROADMAP queue "
                    "1, item 4)")
            cands = sched.rl_candidates(cfg, state)          # (k,)
            k = cands.shape[0]
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
                    net_load, n_done, queued, running, util)

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
# accumulated while the fault engine and the serving twin are off
_OFF = ("killed", "lost_node_s") + _SRV_TELEM


def _telem_zero(device: torch.device, lead=()) -> TelemetrySummary:
    """Zero accumulator, one per replica (``lead``: the state's replica
    shape); the fault and serving fields ride as ``None`` (restored to
    zeros by ``_telem_finalize``) while those models are off."""
    z = torch.zeros(lead, dtype=torch.float32, device=device)
    acc = TelemetrySummary(*([z] * len(TelemetrySummary._fields)))
    return acc._replace(**{f: None for f in _OFF})


def _telem_update(acc: TelemetrySummary, out: StepOut) -> TelemetrySummary:
    # mean_* fields hold running sums until _telem_finalize divides by n
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
        macro_steps=acc.macro_steps + 1.0,   # every tick is a full step
    )


def _telem_finalize(acc: TelemetrySummary) -> TelemetrySummary:
    n = torch.clamp(acc.n_steps, min=1.0)
    acc = acc._replace(**{
        f: getattr(acc, f) / n
        for f in TelemetrySummary._fields if f.startswith("mean_")
    })
    z = torch.zeros_like(acc.n_steps)
    return acc._replace(
        **{f: z for f in _OFF[:-1]},
        srv_lat_hist=torch.zeros(z.shape + (8,), dtype=torch.float32,
                                 device=z.device))


def _stack(items: List[NamedTuple], dim: int = 0):
    """Stack a list of NamedTuples leaf-wise along a new axis ``dim``
    (after a fleet's replica axis)."""
    first = items[0]
    return type(first)(*(
        None if v is None else torch.stack([getattr(it, f) for it in items],
                                           dim)
        for f, v in zip(first._fields, first)))


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

    The ticks run on the device of ``state`` and never synchronise with
    the host. ``macro`` and the snapshot arguments arrive with the macro
    and durable slices and raise here.
    """
    if macro:
        raise NotImplementedError(
            "macro=True: macro-stepping arrives with the macro slice "
            "(ROADMAP queue 1, item 5)")
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
    step = make_step(cfg, statics, scheduler, **kw)
    dev = state.t.device
    lead = tuple(state.t.shape)
    action = full(-1, torch.int64, dev)

    if summary_only:
        acc = _telem_zero(dev, lead)
        for _ in range(n_steps):
            state, out = step(state, action)
            acc = _telem_update(acc, out)
        return state, _telem_finalize(acc)
    if telemetry_every > 1:
        windows = []
        for _ in range(n_steps // telemetry_every):
            acc = _telem_zero(dev, lead)
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
