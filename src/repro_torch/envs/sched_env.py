"""Gym-style (functional) scheduling environment over the twin.

Action space: Discrete(k+1) — dispatch queue-candidate i in [0, k), or
k = no-op; with ``cfg.degrade_enabled`` five more, k + 1 + r setting the
degradation ladder's rung r (held until changed; the decision dispatches
nothing); with ``cfg.serving_on`` four more after those, scaling the
serving pool's autoscale target down / up by ``serving_scale_step`` and
nudging its admission threshold down / up by 0.05 (held until changed;
the decision dispatches nothing). Observations: a fixed-size f32 vector
of global datacenter features (with the thermal, resilience and serving
blocks when those models are on) + per-candidate job features. Reward:
the sim's energy / carbon / throughput mix, with the fault engine the
lost-work penalty, and with the serving twin the SLO penalty.

``reset(key)`` and ``step(state, action)`` work on one environment or on
E at once: key words (2,) give one, (E, 2) give E, and every field of
the ``EnvState`` then carries a leading replica axis E. The E
environments are the replicas of one batched ``SimState`` (the JAX
package's ``vmap`` over envs), so one tick's launches serve all of them:
``power_tick`` once per tick, and ``rack_tick`` once per tick with the
thermal twin on.

As in the JAX package, ``EnvState`` is sim state only: the trace bank,
node tables and scenario live in ONE shared ``Statics`` ((W, J, Q) bank),
and each environment reads its workload through ``sim.workload``. A step
runs ONE ``"rl"`` sub-step (the agent's action) and then
``sim_steps_per_action - 1`` steps of ``make_step(..., "none")``.

With ``macro=True`` (the default, as in the JAX package) the idle
sub-steps are one macro advance instead (``core.sim.make_macro_step``
with ``"none"``, clamped to the decision boundary): event ticks run in
full, quiet ticks are fast-forwarded, and the result equals the per-tick
idle path (``macro=False``, the oracle).

``EnvState.host_steps`` is the host's own copy of the step counters
(numpy, or ``None`` when unknown): ``reset`` and ``step`` keep it without
reading the device, so a rollout knows which environments are done
without a host sync. With ``macro=False`` nothing here reads a tensor on
the host; the macro advance reads how far to go through
``utils.device.host_read``, its only reads.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core import faults as flt
from repro_torch.core import placement as plc
from repro_torch.core import schedulers as sched
from repro_torch.core import thermal
from repro_torch.core.sim import make_macro_step, make_step
from repro_torch.core.state import (
    QUEUED,
    RUNNING,
    SimState,
    Statics,
    build_statics,
    init_state,
)
from repro_torch.data.bank import stack_workloads
from repro_torch.scenarios.events import power_cap_at
from repro_torch.scenarios.scenario import Scenario
from repro_torch.scenarios.signals import eval_signal
from repro_torch.utils import prng
from repro_torch.utils.device import full, resolve_device

# The observation layout, the JAX package's word for word: ``observe`` and
# ``obs_dim`` are both derived from it.
GLOBAL_FEATURES = (
    "sin_day", "cos_day", "carbon", "price", "cap_frac",
    "queued_frac", "running_frac", "nodes_up_frac", "day_frac",
    "episode_progress",
)
# appended to the globals only when ``cfg.thermal_enabled``
THERMAL_FEATURES = ("rack_hot_frac", "rack_mean_frac",
                    "throttle_min", "tripped_frac")
# appended only when ``cfg.resilience_on``: the ladder rung in force, the
# fault kills and terminal failures as fractions of the job table, and the
# lost node-seconds over a node-day of the cluster
RESILIENCE_FEATURES = ("degrade_frac", "killed_frac",
                       "failed_frac", "lost_frac")
# appended only when ``cfg.serving_on``: the pool's load, queue and
# latency estimate against its bounds, the awake and waking shares, and
# the admission threshold in force
SERVING_FEATURES = ("srv_util", "srv_queue_frac", "srv_latency_slo",
                    "srv_active_frac", "srv_waking_frac",
                    "srv_admit_thresh")
# per-node-type features: free fraction of each resource
TYPE_FEATURES = ("cpu_free", "gpu_free", "mem_free")
CANDIDATE_FEATURES = (
    "valid", "wait_h", "dur_h", "n_nodes",
    "req_cpu", "req_gpu", "energy_proxy", "feasible_frac",
)


class EnvState(NamedTuple):
    """Per-env rollout state: the sim (which carries the workload id), the
    episode step counter, and the host's copy of that counter (numpy, or
    ``None`` when the host does not know it)."""

    sim: SimState
    step_count: torch.Tensor
    host_steps: np.ndarray | None = None


def where_state(done: torch.Tensor, fresh: EnvState,
                st: EnvState) -> EnvState:
    """Field by field, ``fresh`` where ``done`` (E,) and ``st`` elsewhere."""
    def pick(f, s):
        return torch.where(done.reshape(done.shape + (1,) * (s.dim() - 1)),
                           f, s)

    sim = type(st.sim)(*(pick(f, s) for f, s in zip(fresh.sim, st.sim)))
    return EnvState(sim, pick(fresh.step_count, st.step_count))


class SchedEnv:
    """Constructed from a *bank* of workloads (numpy); reset samples one."""

    def __init__(
        self,
        cfg: SimConfig,
        workloads,                    # list of (jobs, bank) tuples
        *,
        episode_steps: int = 512,
        sim_steps_per_action: int = 15,
        reward_weights=(1.0, 1.0, 1.0, 0.05),
        scenario: Scenario | None = None,
        placement: str = "first_fit",
        macro: bool = True,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.reward_weights = tuple(reward_weights)
        if placement not in plc.PLACEMENTS:
            raise KeyError(f"unknown placement {placement}")
        self.placement = placement
        dev = resolve_device(device)
        self.device = dev
        self._place_onehot = torch.zeros(len(plc.PLACEMENTS),
                                         dtype=torch.float32, device=dev)
        self._place_onehot[plc.PLACE_IDS[placement]] = 1.0
        self.episode_steps = episode_steps
        self.k = cfg.sched_max_candidates
        # k dispatches, k = no-op, then with the ladder schedulable k+1+r
        # = "set rung r", then with serving on its 4 actions
        self.n_actions = (self.k + 1 + (5 if cfg.degrade_enabled else 0)
                          + (4 if cfg.serving_on else 0))
        self.sim_steps_per_action = sim_steps_per_action

        # ONE shared Statics: stacked (W, J, Q) trace bank + stacked job
        # tables; envs select their workload via sim.workload
        jobs, bank = stack_workloads(cfg, workloads)
        self._jobs = {name: torch.tensor(np.asarray(a), device=dev)
                      for name, a in jobs.items()}
        self.n_workloads = len(workloads)
        self._statics = build_statics(cfg, bank, scenario=scenario,
                                      device=dev)
        self._step_rl = make_step(cfg, self._statics, "rl",
                                  placement=placement,
                                  reward_weights=reward_weights)
        self._step_idle = make_step(cfg, self._statics, "none",
                                    reward_weights=reward_weights)
        # macro idle advance: one event-driven fast-forward between agent
        # decisions instead of the per-tick idle sub-steps
        self.macro = macro
        self._macro_idle = make_macro_step(
            cfg, self._statics, "none", reward_weights=reward_weights,
            update=lambda acc, out, _inc: self._acc_of(acc, out),
        ) if macro else None

        # observation invariants (constant per env instance)
        st = self._statics
        self._nameplate = torch.clamp(torch.sum(st.node_max_w), min=1.0)
        self._cap_max = torch.clamp(
            torch.amax(st.capacity, 1, keepdim=True), min=1e-6)  # (NRES, 1)
        self._type_onehot = (
            st.node_type[None, :]
            == torch.arange(cfg.n_types, device=dev)[:, None]
        ).to(torch.float32)                                      # (T, N)
        self._cap_type = torch.sum(
            st.capacity[:, None, :] * self._type_onehot[None], -1
        )                                                        # (NRES, T)
        self._mask_fn = plc.PLACEMENT_MASKS[placement]
        self.obs_dim = int(self._obs_spec())

    @property
    def statics(self) -> Statics:
        """The single shared Statics (banked trace, node tables, scenario)."""
        return self._statics

    # ------------------------------------------------------------------ api
    def _pick(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """Each env's row ``w`` of a stacked job field (leading W axis)."""
        a = self._jobs[name]
        return a.index_select(0, w.reshape(-1).long()).reshape(
            tuple(w.shape) + tuple(a.shape[1:]))

    def reset(self, key) -> Tuple[EnvState, torch.Tensor]:
        """Fresh environments from key words: (2,) for one, (E, 2) for E.
        Each draws its workload id as the JAX package's ``reset`` does."""
        words = (key if isinstance(key, torch.Tensor)
                 else torch.from_numpy(np.asarray(key, np.int64)))
        words = words.to(device=self.device, dtype=torch.int64)
        pair = prng.split(words, 2)
        kw, ks = pair[..., 0, :], pair[..., 1, :]
        w = prng.randint(kw, (), 0, self.n_workloads)
        sim = init_state(self.cfg, self._statics, ks)
        n = self._pick("n_valid", w)
        J = self.cfg.max_jobs
        idx = torch.arange(J, device=self.device)
        valid = idx < n[..., None]
        part = (sim.part if "part" not in self._jobs else torch.where(
            valid, self._pick("part", w), -1).to(torch.int32))
        sim = sim._replace(
            workload=w,
            jstate=torch.where(valid, QUEUED, 0).to(torch.int32),
            submit_t=self._pick("submit_t", w),
            dur_est=self._pick("dur", w),
            work_left=self._pick("dur", w),
            n_nodes=torch.where(valid, self._pick("n_nodes", w),
                                0).to(torch.int32),
            req=self._pick("req", w),
            part=part,
            priority=self._pick("priority", w),
        )
        lead = tuple(w.shape)
        st = EnvState(sim=sim,
                      step_count=torch.zeros(lead, dtype=torch.int32,
                                             device=self.device),
                      host_steps=np.zeros(lead, np.int64))
        return st, self.observe(st)

    @staticmethod
    def _acc_of(acc, out):
        return {
            "reward": acc["reward"] + out.reward,
            "completed": acc["completed"] + out.completed_now,
            "energy_kwh": acc["energy_kwh"] + out.energy_kwh_step,
            "carbon_kg": acc["carbon_kg"] + out.carbon_kg_step,
            "facility_w": out.facility_w,
            "queue_len": out.queue_len,
        }

    def step(
        self, st: EnvState, action
    ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor,
               Dict[str, torch.Tensor]]:
        """One agent decision: the ``"rl"`` sub-step dispatches ``action``
        (an int, or an integer tensor of the env shape), then
        ``sim_steps_per_action - 1`` idle sub-steps advance the twin (one
        macro advance with ``macro``). Returns (state, obs, reward, done,
        info). With the ladder schedulable, an action in (k, k + 5] sets
        the rung ``action - k - 1`` (held until changed) and dispatches
        nothing; with serving on, the 4 actions after those (code 0..3)
        scale the pool target down / up and nudge the admission threshold
        down / up, and dispatch nothing."""
        cfg = self.cfg
        sim0 = st.sim
        if (cfg.degrade_enabled or cfg.serving_on) \
                and not isinstance(action, torch.Tensor):
            action = full(int(action), torch.int64, self.device)
        if cfg.degrade_enabled:
            is_lvl = action > self.k
            if cfg.serving_on:
                is_lvl = is_lvl & (action <= self.k + 5)
            rung = torch.clamp(action - self.k - 1, 0, flt.LVL_EVICT)
            sim0 = sim0._replace(degrade_level=torch.where(
                is_lvl, rung, sim0.degrade_level).to(torch.int32))
            action = torch.where(is_lvl, self.k, action)
        if cfg.serving_on:
            # held until changed; a non-serving action leaves both fields
            # as they are
            base = self.k + (5 if cfg.degrade_enabled else 0)
            is_srv = action > base
            code = action - base - 1
            stepn = float(np.float32(cfg.serving_scale_step))
            tgt = torch.clamp(
                sim0.srv_target + torch.where(code == 1, stepn, 0.0)
                - torch.where(code == 0, stepn, 0.0),
                0.0, float(cfg.serving_nodes))
            thresh = torch.clamp(
                sim0.srv_admit_thresh
                + 0.05 * (torch.where(code == 3, 1.0, 0.0)
                          - torch.where(code == 2, 1.0, 0.0)), 0.05, 1.0)
            sim0 = sim0._replace(
                srv_target=torch.where(is_srv, tgt, sim0.srv_target),
                srv_admit_thresh=torch.where(is_srv, thresh,
                                             sim0.srv_admit_thresh))
            action = torch.where(is_srv, self.k, action)
        sim, out = self._step_rl(sim0, action)
        lead = tuple(st.step_count.shape)
        z = torch.zeros(lead, dtype=torch.float32, device=self.device)
        acc = self._acc_of({"reward": z, "completed": z, "energy_kwh": z,
                            "carbon_kg": z, "facility_w": z,
                            "queue_len": z}, out)
        n_idle = self.sim_steps_per_action - 1
        if self.macro and n_idle > 0:
            sim, acc = self._macro_idle.run(sim, acc, n_idle)
        else:
            idle = full(-1, torch.int64, self.device)
            for _ in range(n_idle):
                sim, out = self._step_idle(sim, idle)
                acc = self._acc_of(acc, out)
        host = None if st.host_steps is None else st.host_steps + 1
        st = EnvState(sim=sim, step_count=st.step_count + 1, host_steps=host)
        done = st.step_count >= self.episode_steps
        info = {k: acc[k] for k in ("facility_w", "queue_len", "completed",
                                    "energy_kwh", "carbon_kg")}
        return st, self.observe(st), acc["reward"], done, info

    # ------------------------------------------------------------ features
    def _obs_spec(self) -> int:
        th = len(THERMAL_FEATURES) if self.cfg.thermal_enabled else 0
        resil = len(RESILIENCE_FEATURES) if self.cfg.resilience_on else 0
        srv = len(SERVING_FEATURES) if self.cfg.serving_on else 0
        return (len(GLOBAL_FEATURES) + th + resil + srv
                + len(plc.PLACEMENTS)
                + len(TYPE_FEATURES) * self.cfg.n_types
                + len(CANDIDATE_FEATURES) * self.k)

    def observe(self, st: EnvState) -> torch.Tensor:
        """(obs_dim,) f32 for one env, (E, obs_dim) for E."""
        cfg, sim, statics = self.cfg, st.sim, self._statics
        lead = tuple(sim.t.shape)
        day = 2 * math.pi * sim.t / cfg.day_seconds
        queued = torch.sum(sched.queued_mask(sim), -1).to(torch.float32)
        running = torch.sum(sim.jstate == RUNNING, -1).to(torch.float32)
        scn = statics.scenario
        co2 = eval_signal(scn.carbon, sim.t) / max(cfg.carbon_mean, 1.0)
        price = (eval_signal(scn.price, sim.t)
                 / max(cfg.price_mean_usd_kwh, 1e-6))
        # cap as a fraction of nameplate node power; 1 = effectively uncapped
        cap_w = power_cap_at(scn.power_cap, sim.t)
        cap_frac = torch.where(
            cap_w > 0, torch.clamp(cap_w / self._nameplate, max=1.0), 1.0)
        glob = dict(
            sin_day=torch.sin(day), cos_day=torch.cos(day), carbon=co2,
            price=price, cap_frac=cap_frac,
            queued_frac=queued / cfg.max_jobs,
            running_frac=running / cfg.max_jobs,
            nodes_up_frac=torch.sum(sim.node_up, -1) / cfg.n_nodes,
            day_frac=sim.t / cfg.day_seconds,
            episode_progress=(st.step_count.to(torch.float32)
                              / max(self.episode_steps, 1)),
        )
        assert tuple(glob) == GLOBAL_FEATURES
        parts = [torch.stack([glob[n] for n in GLOBAL_FEATURES], -1)]

        if cfg.thermal_enabled:
            # rack temps + throttle state, so the policy can learn
            # thermally-aware dispatch
            trip = max(cfg.thermal_trip_c, 1e-6)
            th_r = thermal.rack_throttle(cfg, sim.rack_outlet_c)   # (..., R)
            therm = dict(
                rack_hot_frac=torch.amax(sim.rack_outlet_c, -1) / trip,
                rack_mean_frac=torch.mean(sim.rack_outlet_c, -1) / trip,
                throttle_min=torch.amin(th_r, -1),
                tripped_frac=torch.mean(
                    (sim.rack_outlet_c >= cfg.thermal_trip_c
                     ).to(torch.float32), -1),
            )
            assert tuple(therm) == THERMAL_FEATURES
            parts.append(torch.stack([therm[n] for n in THERMAL_FEATURES],
                                     -1))

        if cfg.resilience_on:
            # fault and lost-work state, so the policy can learn
            # resilience-aware control (drain ahead of maintenance, hold a
            # rung through a brownout, requeue-aware dispatch)
            resil = dict(
                degrade_frac=(flt.effective_level(cfg, sim, statics)
                              .to(torch.float32) / float(flt.LVL_EVICT)),
                killed_frac=sim.n_killed / cfg.max_jobs,
                failed_frac=sim.n_failed / cfg.max_jobs,
                lost_frac=sim.lost_node_s / (cfg.n_nodes * cfg.day_seconds),
            )
            assert tuple(resil) == RESILIENCE_FEATURES
            parts.append(torch.stack(
                [resil[n] for n in RESILIENCE_FEATURES], -1))

        if cfg.serving_on:
            # serving-pool state, so the policy can learn overload control
            # (wake capacity ahead of the peak, tighten admission under
            # backlog, sleep the pool through the trough)
            conc_cap = sim.srv_active * cfg.serving_concurrency
            q_tot = torch.sum(sim.srv_queue, -1)
            svc = max(cfg.serving_service_s, 1e-9)
            w_est = q_tot / torch.clamp(conc_cap / svc, min=1e-9) + svc
            srv = dict(
                srv_util=(sim.srv_inflight + q_tot) / torch.clamp(
                    conc_cap + cfg.serving_queue_cap, min=1e-9),
                srv_queue_frac=q_tot / max(cfg.serving_queue_cap, 1e-9),
                srv_latency_slo=torch.clamp(
                    w_est / max(cfg.serving_slo_s, 1e-9), max=10.0),
                srv_active_frac=sim.srv_active / max(cfg.serving_nodes, 1),
                srv_waking_frac=sim.srv_wake_n / max(cfg.serving_nodes, 1),
                srv_admit_thresh=sim.srv_admit_thresh,
            )
            assert tuple(srv) == SERVING_FEATURES
            parts.append(torch.stack([srv[n] for n in SERVING_FEATURES],
                                     -1))
        parts.append(self._place_onehot.expand(
            lead + tuple(self._place_onehot.shape)))

        # per-node-type free fractions as one one-hot contraction
        free_up = sim.free * sim.node_up[..., None, :]           # (..., R, N)
        free_type = torch.sum(
            free_up[..., :, None, :] * self._type_onehot, -1)   # (..., R, T)
        per_type = (free_type / torch.clamp(self._cap_type, min=1e-6))
        parts.append(per_type.transpose(-1, -2).reshape(lead + (-1,)))

        cands = sched.rl_candidates(cfg, sim)                   # (..., k)
        safe = torch.clamp(cands, min=0).long()
        valid = (cands >= 0).to(torch.float32)
        wait = torch.clamp(
            sim.t[..., None] - torch.gather(sim.submit_t, -1, safe),
            min=0.0) / 3600.0
        dur = torch.gather(sim.dur_est, -1, safe) / 3600.0
        nn = (torch.gather(sim.n_nodes, -1, safe).to(torch.float32)
              / cfg.max_nodes_per_job)
        req = torch.gather(sim.req, -1, safe[..., None, :].expand(
            lead + (sim.req.shape[-2], safe.shape[-1])))        # (..., R, k)
        reqf = req / self._cap_max
        # estimated energy proxy: nodes * dur
        eproxy = nn * dur
        # feasibility under the ACTIVE placement backend (and, with
        # thermals, the racks' trip), resolved once per observation
        ok = torch.all(sim.free[..., :, None, :] >= req[..., None],
                       dim=-3)                                  # (..., k, N)
        ok = ok & (sim.node_up > 0.5)[..., None, :]
        if self._mask_fn is not None:
            m = self._mask_fn(sim, statics)                     # (..., J, N)
            ok = ok & torch.gather(m, -2, safe[..., None].expand(
                lead + (safe.shape[-1], m.shape[-1])))
        if cfg.thermal_enabled:
            ok = ok & thermal.node_trip_ok(cfg, sim, statics)[..., None, :]
        feasible = torch.sum(ok, -1).to(torch.float32) / cfg.n_nodes
        cand = dict(
            valid=valid, wait_h=wait * valid, dur_h=dur * valid,
            n_nodes=nn * valid, req_cpu=reqf[..., 0, :] * valid,
            req_gpu=reqf[..., 1, :] * valid, energy_proxy=eproxy * valid,
            feasible_frac=feasible * valid,
        )
        assert tuple(cand) == CANDIDATE_FEATURES
        parts += [cand[n] for n in CANDIDATE_FEATURES]
        return torch.cat(parts, -1).to(torch.float32)
