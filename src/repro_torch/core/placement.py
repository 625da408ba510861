"""Node-placement strategies — stage (b) of the two-stage policy engine.

Selection (``core.schedulers``) answers *which job* to dispatch;
placement answers *which nodes* host it. Every strategy shares one
signature::

    place(state, statics, job) -> (row (K,) int32 node ids, feasible bool)

- ``first_fit``  lowest-index feasible nodes (the sort-free cumsum path).
- ``best_fit``   feasible nodes with the LEAST remaining free capacity.
- ``spread``     feasible nodes with the MOST remaining free capacity.
- ``partition``  a job tagged with node type ``state.part[job]`` lands
                 only on nodes of that type (tag -1 = any); first-fit
                 order within the partition.
- ``green``      nodes by full-load watts per peak GFLOP/s.

Score-based strategies take the lowest scores through a stable sort, so
ties go to the lowest index and every strategy degenerates to
``first_fit`` ordering when its scores are constant (the JAX package gets
this from ``lax.top_k``; ``torch.topk`` makes no such promise). Every
strategy takes a fleet's state (a leading replica axis E, one job id per
replica) as well as one state.

Policy-as-data: a ``Policy`` is a (selection id, placement id) pair of
int32 tensors, (E,) for a fleet (``stack_policies``, ``policy_grid``).
Its ids are host data: ``make_step`` reads them once to run only the
strategies the fleet names (``place_job``, ``placement_node_mask``), each
on every replica, keeping each replica's own result.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import schedulers as sched
from repro_torch.core.state import SimState, Statics
from repro_torch.utils.device import take


def partition_mask(state: SimState, statics: Statics,
                   job: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: nodes whose type matches the job's partition tag."""
    return sched.partition_ok(take(state.part, job)[..., None],
                              statics.node_type)


def _score_place(
    state: SimState,
    job: torch.Tensor,
    score: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Choose `n_nodes[job]` feasible nodes with the LOWEST score, ties by
    lowest index."""
    K = state.placement.shape[-1]
    N = state.free.shape[-1]
    ok = sched.feasible_nodes(state, job)
    if mask is not None:
        ok = ok & mask
    n_req = take(state.n_nodes, job)
    key = torch.where(ok, score, float("inf"))
    kk = min(K, N)
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :kk].to(
        torch.int32)
    if kk < K:
        idx = torch.cat([idx, torch.full(idx.shape[:-1] + (K - kk,), -1,
                                         dtype=torch.int32,
                                         device=idx.device)], -1)
    slots = torch.arange(K, device=idx.device)
    row = torch.where(slots < n_req[..., None], idx, -1)
    enough = torch.sum(ok, -1) >= n_req
    return torch.where(enough[..., None], row, -1), enough


def _free_frac(state: SimState, statics: Statics) -> torch.Tensor:
    """(..., N) mean free fraction across resources — the
    remaining-capacity score shared by best_fit (ascending) and spread
    (descending). The three resources are summed in order, then divided,
    as a mean is."""
    ff = state.free / torch.clamp(statics.capacity, min=1e-6)
    return (ff[..., 0, :] + ff[..., 1, :] + ff[..., 2, :]) / 3.0


def watts_per_gflop(statics: Statics) -> torch.Tensor:
    """(N,) full-load watts per peak GFLOP/s — the `green` node score."""
    return statics.node_max_w / torch.clamp(statics.peak_gflops, min=1.0)


def place_first_fit(state: SimState, statics: Statics, job: torch.Tensor):
    return sched.first_fit(state, job, state.placement.shape[-1])


def place_best_fit(state: SimState, statics: Statics, job: torch.Tensor):
    return _score_place(state, job, _free_frac(state, statics))


def place_spread(state: SimState, statics: Statics, job: torch.Tensor):
    return _score_place(state, job, -_free_frac(state, statics))


def place_partition(state: SimState, statics: Statics, job: torch.Tensor):
    return _score_place(state, job, torch.zeros_like(statics.idle_w),
                        mask=partition_mask(state, statics, job))


def place_green(state: SimState, statics: Statics, job: torch.Tensor):
    return _score_place(state, job, watts_per_gflop(statics))


PLACEMENTS: Dict[str, object] = {
    "first_fit": place_first_fit,
    "best_fit": place_best_fit,
    "spread": place_spread,
    "partition": place_partition,
    "green": place_green,
}

# policy-as-data ids: position in PLACEMENTS (insertion-ordered), the JAX
# package's branch order
PLACE_IDS = {name: i for i, name in enumerate(PLACEMENTS)}

# Per-strategy node-eligibility masks beyond the free pool, as batched
# (state, statics) -> (..., J, N) functions; None = every node eligible.
# Selection (EASY's no-doomed-pick guarantee) resolves masking here.
PLACEMENT_MASKS: Dict[str, object] = {
    "first_fit": None,
    "best_fit": None,
    "spread": None,
    "partition": sched.partition_mask_all,
    "green": None,
}
assert set(PLACEMENT_MASKS) == set(PLACEMENTS)


Use = Dict[str, "torch.Tensor | None"]


def placement_node_mask(state: SimState, statics: Statics,
                        use: Use) -> torch.Tensor | None:
    """(..., J, N) node eligibility of each replica's placement: the mask
    of every masking strategy in ``use`` (the strategies a fleet names,
    each with the replicas that run it; ``None`` for the only one), on the
    replicas that run it; ``None`` when no named strategy masks."""
    mask = None
    for name, rows in use.items():
        fn = PLACEMENT_MASKS[name]
        if fn is None:
            continue
        m = fn(state, statics)
        if rows is not None:
            m = m | ~rows[..., None, None]
        mask = m if mask is None else mask & m
    return mask


def place_job(state: SimState, statics: Statics, job: torch.Tensor,
              use: Use) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each replica's (row, ok) under its own placement: every strategy in
    ``use`` runs on every replica, ``torch.where`` keeps each replica's."""
    row = ok = None
    for name, rows in use.items():
        r, o = PLACEMENTS[name](state, statics, job)
        if row is None or rows is None:
            row, ok = r, o
        else:
            row = torch.where(rows[..., None], r, row)
            ok = torch.where(rows, o, ok)
    return row, ok


# --------------------------------------------------------------- policies
class Policy(NamedTuple):
    """Policy-as-data: a (selection, placement) pair of int32 ids, 0-d for
    one policy or (E,) for a fleet's, on the host."""

    select: torch.Tensor       # int32 id into schedulers.SELECT_IDS
    place: torch.Tensor        # int32 id into PLACE_IDS


def make_policy(select: str = "fcfs", place: str = "first_fit") -> Policy:
    if select not in sched.SELECT_IDS:
        raise KeyError(f"unknown selection {select!r}; "
                       f"one of {list(sched.SELECT_IDS)}")
    if place not in PLACE_IDS:
        raise KeyError(f"unknown placement {place!r}; "
                       f"one of {list(PLACE_IDS)}")
    return Policy(
        select=torch.tensor(sched.SELECT_IDS[select], dtype=torch.int32),
        place=torch.tensor(PLACE_IDS[place], dtype=torch.int32))


def stack_policies(policies: Sequence[Policy]) -> Policy:
    """Stack Policies leaf-wise -> leading replica axis (the policy analog
    of ``scenarios.stack_scenarios``)."""
    return Policy(*(torch.stack([getattr(p, f) for p in policies])
                    for f in Policy._fields))


def policy_grid(
    selects: Sequence[str], places: Sequence[str]
) -> Tuple[Sequence[str], Policy]:
    """Cross selections x placements -> (names, batched Policy)."""
    names = [f"{s}+{p}" for s in selects for p in places]
    pols = [make_policy(s, p) for s in selects for p in places]
    return names, stack_policies(pols)
