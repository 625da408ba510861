"""Job-selection policies — stage (a) of the two-stage policy engine.

Each policy looks at the job table and returns the index of the queued job
to attempt next (or -1) as an int64 tensor on the state's device: 0-d for
one state, (E,) for a fleet's state (a leading replica axis on every
field; every reduction runs over the last axis, replica by replica).
Node placement is the second, independent stage (``core.placement``).
The RL policy is external: its action picks among the top
``sched_max_candidates`` FCFS-ordered queue candidates (or no-op).

Policies mirror RAPS' production-Slurm-matching set:
replay | fcfs | sjf | priority | easy (FCFS + EASY backfill).

No policy reads a tensor on the host. Where the JAX package branches
with ``lax.cond`` (EASY's head-or-backfill choice), both sides are
computed and one is picked with ``torch.where``. Ties break by lowest
index everywhere (stable sorts, first-occurrence argmin/argmax), as the
JAX package's ``argsort``/``top_k`` do.

Policy-as-data: every selection carries an int32 id (``SELECT_IDS``);
``select_job`` resolves each replica's id, where the JAX package's
``lax.switch`` runs under ``vmap``, as a select over the strategies the
fleet names: each of them runs on every replica, and ``torch.where``
keeps each replica's own pick.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core.state import QUEUED, RUNNING, SimState, Statics
from repro_torch.utils.device import take

BIG = 1e18


def queued_mask(state: SimState) -> torch.Tensor:
    return (state.jstate == QUEUED) & (state.submit_t <= state.t[..., None])


def feasible_nodes(state: SimState, job: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: nodes that can host one rank of `job` right now."""
    req = take(state.req, job, dim=-1)                  # (..., NRES)
    ok = torch.all(state.free >= req[..., None], dim=-2)
    return ok & (state.node_up > 0.5)


def capacity_feasible_nodes(state: SimState, statics: Statics,
                            job: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: up nodes whose *total* capacity can host one rank of
    `job` — nodes that could host it once their current tenants leave."""
    req = take(state.req, job, dim=-1)
    ok = torch.all(statics.capacity >= req[..., None], dim=-2)
    return ok & (state.node_up > 0.5)


def partition_ok(part: torch.Tensor, node_type: torch.Tensor) -> torch.Tensor:
    """The TX-GAIA partition rule: tag -1 = any node; otherwise the node
    type must match. Broadcasts."""
    return (part < 0) | (node_type == part)


def partition_mask_all(state: SimState, statics: Statics) -> torch.Tensor:
    """(..., J, N) bool: per-job node eligibility under partition
    semantics."""
    return partition_ok(state.part[..., None], statics.node_type)


def fits_now_mask(state: SimState,
                  node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., J) bool: jobs whose whole-node request is satisfiable against
    the current free pool (optionally restricted to ``node_mask``
    (..., J, N))."""
    ok = torch.all(state.free[..., None, :] >= state.req[..., None],
                   dim=-3)                                   # (..., J, N)
    ok = ok & (state.node_up > 0.5)[..., None, :]
    if node_mask is not None:
        ok = ok & node_mask
    return torch.sum(ok, dim=-1) >= state.n_nodes


def first_fit(state: SimState, job: torch.Tensor,
              K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Choose `n_nodes[job]` lowest-index feasible nodes, sort-free: the
    node filling slot ``s`` is the first index where the running count of
    feasible nodes reaches ``s + 1`` (``searchsorted``, left side).

    Returns (placement_row (..., K) int32, feasible (...) bool)."""
    ok = feasible_nodes(state, job)
    n_req = take(state.n_nodes, job)
    csum = torch.cumsum(ok, -1)                      # int64
    slots = torch.arange(K, device=ok.device)
    want = slots + 1
    if csum.dim() > 1:      # one row of slots per replica
        want = want.expand(csum.shape[:-1] + (K,)).contiguous()
    idx = torch.searchsorted(csum, want).to(torch.int32)
    row = torch.where(slots < n_req[..., None], idx, -1)
    enough = csum[..., -1] >= n_req
    return torch.where(enough[..., None], row, -1), enough


# ---------------------------------------------------------------------------
# candidate orderings — uniform signature (cfg, state, statics[, node_mask])
# -> job id. ``node_mask`` (..., J, N) is the placement backend's node
# eligibility (None = every node): only EASY consults it.
def _masked_argmin(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.where(mask, score, BIG)
    idx = torch.argmin(s, -1)
    return torch.where(torch.any(mask, -1), idx, -1)


def select_fcfs(cfg: SimConfig, state: SimState, statics: Statics,
                node_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_argmin(state.submit_t, queued_mask(state))


def select_sjf(cfg: SimConfig, state: SimState, statics: Statics,
               node_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_argmin(state.dur_est, queued_mask(state))


def select_priority(cfg: SimConfig, state: SimState, statics: Statics,
                    node_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_argmin(-state.priority, queued_mask(state))


def select_replay(cfg: SimConfig, state: SimState, statics: Statics,
                  node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Replay: dispatch in recorded start order — priority carries the
    recorded start time; a job becomes eligible once t >= recorded start."""
    m = queued_mask(state) & (state.priority <= state.t[..., None])
    return _masked_argmin(state.priority, m)


def shadow_time(cfg: SimConfig, state: SimState, statics: Statics,
                head: torch.Tensor,
                node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """EASY reservation: earliest time the head job could start, assuming
    running jobs release their nodes at their walltime estimates. Only
    releases of head-feasible nodes count."""
    running = state.jstate == RUNNING
    est_end = torch.where(running, state.start_t + state.dur_est, BIG)
    head_ok = capacity_feasible_nodes(state, statics, head)   # (..., N)
    free_ok = feasible_nodes(state, head)
    if node_mask is not None:
        head_mask = take(node_mask, head, dim=-2)
        head_ok = head_ok & head_mask
        free_ok = free_ok & head_mask
    # nodes each running job will release that could host the head
    valid = state.placement >= 0                              # (..., J, K)
    safe = torch.where(valid, state.placement, 0).long()
    rel_ok = torch.gather(head_ok, -1, safe.flatten(-2)).view(safe.shape)
    rel_nodes = torch.sum(valid & rel_ok, dim=-1).to(torch.float32)
    rel_nodes = torch.where(running, rel_nodes, 0.0)
    order = torch.sort(est_end, dim=-1, stable=True).indices
    cum = torch.cumsum(torch.gather(rel_nodes, -1, order), -1)
    free_now = torch.sum(free_ok, -1)
    need = torch.clamp(
        take(state.n_nodes, head).to(torch.float32) - free_now, min=0.0)
    reached = cum >= need[..., None]
    first = torch.argmax(reached.to(torch.int32), -1)
    t_shadow = torch.where(torch.any(reached, -1),
                           take(est_end, take(order, first)), BIG)
    return torch.where(need > 0, t_shadow, state.t)


def select_easy(cfg: SimConfig, state: SimState, statics: Statics,
                node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """FCFS head first; if the head does not fit, backfill any queued job
    that (a) fits now and (b) finishes before the head's shadow time.
    Every feasibility check honors ``node_mask``. Both the head and the
    backfill pick are computed; ``torch.where`` chooses."""
    head = select_fcfs(cfg, state, statics)
    h = torch.clamp(head, min=0)
    head_ok = feasible_nodes(state, h)
    if node_mask is not None:
        head_ok = head_ok & take(node_mask, h, dim=-2)
    head_fits = torch.sum(head_ok, -1) >= take(state.n_nodes, h)

    t_sh = shadow_time(cfg, state, statics, h, node_mask)
    # candidate must be currently feasible, fit before the reservation,
    # and not be the head
    m = queued_mask(state) & fits_now_mask(state, node_mask)
    fits_window = (state.t[..., None] + state.dur_est) <= t_sh[..., None]
    not_head = (torch.arange(m.shape[-1], device=m.device)
                != h[..., None])
    cand = _masked_argmin(state.submit_t, m & fits_window & not_head)

    pick = torch.where(head_fits, h, cand)
    return torch.where(head >= 0, pick, -1)


SCHEDULERS = {
    "replay": select_replay,
    "fcfs": select_fcfs,
    "sjf": select_sjf,
    "priority": select_priority,
    "easy": select_easy,
}

# policy-as-data ids: position in SCHEDULERS (insertion-ordered), the
# JAX package's branch order
SELECT_IDS = {name: i for i, name in enumerate(SCHEDULERS)}


def select_job(cfg: SimConfig, state: SimState, statics: Statics,
               use: Dict[str, torch.Tensor | None],
               node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Each replica's pick under its own selection id. ``use`` maps every
    strategy the fleet names to the replicas that run it (a bool tensor of
    the state's leading shape; ``None`` for the only strategy named): each
    named strategy runs on every replica and ``torch.where`` keeps each
    replica's own pick. ``node_mask`` is the placement stage's eligibility
    (or None)."""
    job = None
    for name, mask in use.items():
        pick = SCHEDULERS[name](cfg, state, statics, node_mask)
        job = pick if job is None or mask is None else torch.where(
            mask, pick, job)
    return job


def rl_candidates(cfg: SimConfig, state: SimState) -> torch.Tensor:
    """Top-k FCFS-ordered queued jobs the RL agent chooses among: (..., k)
    int32, -1 where fewer than k are queued. A stable sort keeps the
    lowest index first among equal submit times."""
    k = cfg.sched_max_candidates
    m = queued_mask(state)
    score = torch.where(m, state.submit_t, BIG)
    idx = torch.sort(score, dim=-1, stable=True).indices[..., :k]
    ok = torch.gather(m, -1, idx)
    return torch.where(ok, idx.to(torch.int32), -1)
