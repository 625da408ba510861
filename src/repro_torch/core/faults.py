"""The resilience twin's fault engine: event-sampled fault clocks, forced
outages, checkpoint-restart and the graceful-degradation ladder.

``SimState.next_fail_t`` (per node) and ``SimState.rack_fail_t`` (per
rack: a cooling-loop / PDU fault downs the whole rack) hold ABSOLUTE
exponential next-failure times, redrawn only when they fire. Scenario
outage windows (``scenarios.events.OutageSchedule``) add deterministic
forced outages and ladder levels on top. Every fault is therefore an
exact breakpoint (``next_fault_event``) for the macro-stepping engine,
and the key words advance only on a tick where a clock fires, so quiet
ticks draw nothing.

On a kill (``apply_faults``) a running job rewinds to its last
checkpoint (``ckpt_kept``); the periodic checkpoint write drags its
progress (``ckpt_drag``, read by the accounting tail); a job killed more
than ``cfg.max_job_retries`` times goes terminal ``FAILED`` (0 =
unbounded); a retried job waits ``requeue_backoff_s * mult**(n-1)``
(its ``submit_t`` moves); ``lost_node_s`` integrates the node-seconds of
progress the kills destroyed.

The ladder (throttle -> dispatch gate -> drain -> checkpoint-evict) is
one level per replica: the max of the schedulable
``SimState.degrade_level`` and any active outage window's forced level.

Every function takes one state or a fleet's (a leading replica axis E on
every field, a batched ``statics.scenario``), as the step does, and never
reads a tensor on the host: the clocks are drawn on every tick with
faults on and kept only where one fired (``torch.where`` on the key
words), as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core.state import FAILED, QUEUED, RUNNING, SimState, Statics
from repro_torch.scenarios.events import (
    next_outage_event,
    outage_down,
    outage_level_at,
)
from repro_torch.utils import prng
from repro_torch.utils.device import full

# graceful-degradation ladder levels (ordered: each includes the previous)
LVL_NORMAL, LVL_THROTTLE, LVL_GATE, LVL_DRAIN, LVL_EVICT = 0, 1, 2, 3, 4

_INF = float("inf")


def effective_level(cfg: SimConfig, state: SimState,
                    statics: Statics) -> torch.Tensor:
    """Current ladder level (int32, one per replica): the max of the
    schedulable ``state.degrade_level`` and any active outage window's
    forced level. Constant within a quiet macro segment: outage edges are
    breakpoints and ``degrade_level`` changes only at decisions."""
    lvl = (state.degrade_level if cfg.degrade_enabled
           else torch.zeros_like(state.degrade_level))
    if cfg.outages_enabled:
        lvl = torch.maximum(
            lvl, outage_level_at(statics.scenario.outages, state.t))
    return lvl


def degrade_clock(cfg: SimConfig, lvl: torch.Tensor) -> torch.Tensor:
    """Clock fraction the ladder imposes on dynamic power and progress:
    1.0 below THROTTLE, ``degrade_throttle_frac`` at THROTTLE and GATE,
    the DVFS floor from DRAIN up."""
    return torch.where(
        lvl >= LVL_DRAIN, float(np.float32(cfg.throttle_floor)),
        torch.where(lvl >= LVL_THROTTLE,
                    float(np.float32(cfg.degrade_throttle_frac)), 1.0))


def ckpt_kept(state: SimState, prog: torch.Tensor) -> torch.Tensor:
    """(..., J) work surviving a kill: progress floored to the job's
    checkpoint grid (0 when the job never checkpoints)."""
    iv = state.ckpt_interval
    return torch.where(
        iv > 0.0, torch.floor(prog / torch.clamp(iv, min=1e-9)) * iv, 0.0)


def ckpt_drag(cfg: SimConfig, state: SimState) -> torch.Tensor:
    """(..., J) progress-rate factor charging the periodic checkpoint
    write: of every ``interval + overhead`` seconds only ``interval``
    advance the job, while power keeps burning."""
    iv = state.ckpt_interval
    ov = full(float(np.float32(cfg.ckpt_overhead_s)), torch.float32,
              iv.device)
    return torch.where(iv > 0.0, iv / (iv + ov), 1.0)


def release_jobs(free: torch.Tensor, state: SimState,
                 mask: torch.Tensor) -> torch.Tensor:
    """Add back the resources of the jobs in ``mask`` (..., J) to the free
    pool (..., NRES, N).

    Deterministic on every device: several jobs may hand back non-integer
    ``mem_gb`` on one node in the same tick, and a float scatter-add on
    CUDA sums in a different order on every run, which could flip a later
    ``free >= req`` test. So the node membership of each job is built
    first, as a (..., J, N) 0/1 matrix (a scatter-add of exact small
    integers, which any order gets right), and the per-node release is its
    product with the released amounts (..., NRES, J): a fixed reduction
    over jobs, the same bits on every run of one device.
    """
    place = state.placement.long()                         # (..., J, K)
    valid = place >= 0
    member = torch.zeros(place.shape[:-1] + free.shape[-1:],
                         dtype=free.dtype, device=free.device)
    member.scatter_add_(-1, torch.where(valid, place, 0),
                        valid.to(free.dtype))
    amounts = state.req * mask[..., None, :].to(free.dtype)   # (..., R, J)
    return free + torch.matmul(amounts, member)


def next_fault_event(cfg: SimConfig, state: SimState, statics: Statics,
                     t: torch.Tensor) -> torch.Tensor:
    """Earliest fault breakpoint strictly after ``t`` (``inf`` when none),
    one per replica: the next node or rack clock crossing or outage-window
    edge. ``apply_faults`` keeps every clock strictly in the future, so
    the ``> t`` guard hides no pending event."""
    nxt = torch.full(t.shape, _INF, dtype=torch.float32, device=t.device)
    tt = t[..., None]
    if cfg.node_mtbf_hours > 0:
        nxt = torch.minimum(nxt, torch.amin(torch.where(
            state.next_fail_t > tt, state.next_fail_t, _INF), -1))
    if cfg.rack_mtbf_hours > 0:
        nxt = torch.minimum(nxt, torch.amin(torch.where(
            state.rack_fail_t > tt, state.rack_fail_t, _INF), -1))
    if cfg.outages_enabled:
        nxt = torch.minimum(
            nxt, next_outage_event(statics.scenario.outages, t))
    return nxt


def _scale(hours: float, dev: torch.device) -> torch.Tensor:
    """``hours`` in seconds as an f32 device tensor (so a draw times it is
    the product of two f32 values on every device)."""
    return full(float(np.float32(hours * 3600.0)), torch.float32, dev)


def apply_faults(cfg: SimConfig, state: SimState, statics: Statics
                 ) -> Tuple[SimState, torch.Tensor, torch.Tensor]:
    """One fault tick: fire due clocks, apply forced outages, repair,
    kill / evict / requeue jobs. Returns ``(state, killed_now,
    lost_now)``, one each per replica: the jobs killed by node loss this
    tick and the node-seconds of progress destroyed.

    As in the JAX package: every clock in the returned state is strictly
    future (fires redraw past their repair, absorbed fires on nodes
    already down included); the key advances only where a clock fires;
    and a tick with no crossing, no repair due and no window edge is a
    fixpoint, which is what lets the macro engine fast-forward past it.
    """
    t = state.t
    tt = t[..., None]
    dev = t.device
    f32 = torch.float32
    N = state.node_up.shape[-1]
    R = state.rack_fail_t.shape[-1]
    lead = tuple(t.shape)
    up = state.node_up > 0.5
    node_on = cfg.node_mtbf_hours > 0
    rack_on = cfg.rack_mtbf_hours > 0
    node_rack = statics.node_rack.long()

    # --- deterministic outage context (no draws)
    if cfg.outages_enabled:
        forced, forced_end = outage_down(statics.scenario.outages, t,
                                         statics.node_rack)
    else:
        forced = torch.zeros(lead + (N,), dtype=torch.bool, device=dev)
        forced_end = torch.zeros(lead + (N,), dtype=f32, device=dev)
    lvl = effective_level(cfg, state, statics)

    # --- clock crossings and redraws; fires on nodes already down are
    # absorbed (the node stays down, its repair may extend) and redraw too
    no_node = torch.zeros(lead + (N,), dtype=torch.bool, device=dev)
    node_cross = (tt >= state.next_fail_t) if node_on else no_node
    rack_fire = ((tt >= state.rack_fail_t) if rack_on else
                 torch.zeros(lead + (R,), dtype=torch.bool, device=dev))
    key = state.key
    next_fail_t, rack_fail_t = state.next_fail_t, state.rack_fail_t
    if node_on or rack_on:
        any_fire = torch.any(node_cross, -1) | torch.any(rack_fire, -1)
        ks = prng.split(state.key, 1 + 2 * (int(node_on) + int(rack_on)))
        nk = ks[..., 0, :]
        # every draw in one pass: a draw's value at index i depends only
        # on its key and i, so a rack draw is the first R of an N-wide one
        draws = iter(prng.exponential(ks[..., 1:, :],
                                      (N if node_on else R,)).unbind(-2))
        if node_on:
            repair_e, repair_s = next(draws), _scale(cfg.node_repair_hours,
                                                     dev)
            fail_e, fail_s = next(draws), _scale(cfg.node_mtbf_hours, dev)
            # t + repair + fail, each draw (an exponential times its
            # scale) fused into the sum that reads it, as XLA's CPU code
            # computes it: one rounding per add
            node_repair_at = prng.fma_f32(repair_e, repair_s, tt)
            next_fail_t = torch.where(
                node_cross, prng.fma_f32(fail_e, fail_s, node_repair_at),
                state.next_fail_t)
        if rack_on:
            rack_repair_e, rack_repair_s = (next(draws)[..., :R],
                                            _scale(cfg.rack_repair_hours, dev))
            rack_fail_e, rack_fail_s = (next(draws)[..., :R],
                                        _scale(cfg.rack_mtbf_hours, dev))
            rack_fail_t = torch.where(
                rack_fire, prng.fma_f32(rack_fail_e, rack_fail_s,
                                        prng.fma_f32(rack_repair_e,
                                                     rack_repair_s, tt)),
                state.rack_fail_t)
        key = torch.where(any_fire[..., None], nk, state.key)

    member_fire = (rack_fire.index_select(-1, node_rack) if rack_on
                   else no_node)

    # --- repair times: the max over the firing causes, merged with the
    # node's standing repair if it is already down; forced windows extend
    # every down member to at least the window end (no flapping up
    # inside a window)
    old_eff = torch.where(up, 0.0, state.repair_t)
    cand = torch.zeros(lead + (N,), dtype=f32, device=dev)
    if node_on:
        cand = torch.where(node_cross, node_repair_at, cand)
    if rack_on:
        cand = torch.maximum(cand, torch.where(
            member_fire, prng.fma_f32(
                rack_repair_e.index_select(-1, node_rack), rack_repair_s,
                tt), 0.0))
    if cfg.outages_enabled:
        cand = torch.maximum(cand, torch.where(forced, forced_end, 0.0))
    repair_t = torch.where(cand > 0.0, torch.maximum(old_eff, cand),
                           state.repair_t)

    # --- downs first, then repairs
    down_mask = node_cross | member_fire | forced
    newly_down = down_mask & up
    node_up = torch.where(down_mask, 0.0, state.node_up)
    repaired = (node_up < 0.5) & (tt >= repair_t)
    node_up = torch.where(repaired, 1.0, node_up)

    # --- kill running jobs touching newly-downed nodes; checkpoint-evict
    # the rest where the ladder says so
    place = state.placement
    valid = place >= 0
    safe = torch.where(valid, place, 0).long()
    slot_down = torch.gather(newly_down, -1,
                             safe.flatten(-2)).view(place.shape)
    running = state.jstate == RUNNING
    on_down = torch.any(valid & slot_down, -1) & running
    if cfg.degrade_enabled or cfg.outages_enabled:
        evict = running & ~on_down & (lvl >= LVL_EVICT)[..., None]
    else:
        evict = torch.zeros_like(on_down)
    free = release_jobs(state.free, state, on_down | evict)

    # --- checkpoint-restart: killed jobs rewind to their last checkpoint
    # (the since-checkpoint slice is lost work); evicted jobs take a final
    # checkpoint and keep all progress
    prog = torch.clamp(state.dur_est - state.work_left, min=0.0)
    kept = ckpt_kept(state, prog)
    work_left = torch.where(on_down, state.dur_est - kept, state.work_left)

    # --- retry budget and terminal FAILED
    n_fail_new = state.n_failures + on_down.to(torch.int32)
    if cfg.max_job_retries > 0:
        exhausted = on_down & (n_fail_new > cfg.max_job_retries)
    else:
        exhausted = torch.zeros_like(on_down)
    requeue = (on_down & ~exhausted) | evict
    jstate = torch.where(exhausted, FAILED, torch.where(
        requeue, QUEUED, state.jstate)).to(torch.int32)

    # --- requeue backoff: a later submit_t reuses the arrival machinery
    submit_t = state.submit_t
    if cfg.requeue_backoff_s > 0:
        # t + backoff_s * mult**(n - 1), the product fused into the sum
        power = torch.pow(
            full(float(np.float32(cfg.requeue_backoff_mult)), f32, dev),
            torch.clamp(n_fail_new - 1, min=0).to(f32))
        due = prng.fma_f32(full(float(np.float32(cfg.requeue_backoff_s)),
                                f32, dev), power, tt)
        submit_t = torch.where(on_down & ~exhausted, due, submit_t)

    # --- scrub the per-job fields, so a requeued job is a fresh one
    start_t = torch.where(requeue | exhausted, 0.0, state.start_t)
    end_t = torch.where(exhausted, tt, state.end_t)
    placement = torch.where((on_down | evict | exhausted)[..., None], -1,
                            place)

    # --- lost work (goodput against throughput): retries lose the
    # since-checkpoint slice, terminal failures the whole job, graceful
    # evictions nothing
    lost = torch.where(on_down, prog - kept, 0.0)
    lost = torch.where(exhausted, prog, lost)
    lost_now = torch.sum(lost * state.n_nodes.to(f32), -1)
    killed_now = torch.sum(on_down, -1).to(f32)

    state = state._replace(
        key=key, node_up=node_up, repair_t=repair_t, free=free,
        jstate=jstate, submit_t=submit_t, start_t=start_t, end_t=end_t,
        work_left=work_left, placement=placement, n_failures=n_fail_new,
        next_fail_t=next_fail_t, rack_fail_t=rack_fail_t,
        n_killed=state.n_killed + killed_now,
        n_failed=state.n_failed + torch.sum(exhausted, -1).to(f32),
        lost_node_s=state.lost_node_s + lost_now,
    )
    return state, killed_now, lost_now
