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
this from ``lax.top_k``; ``torch.topk`` makes no such promise). The
traced ``Policy`` ids arrive with the fleets slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import schedulers as sched
from repro_torch.core.state import SimState, Statics
from repro_torch.utils.device import take


def partition_mask(state: SimState, statics: Statics,
                   job: torch.Tensor) -> torch.Tensor:
    """(N,) bool: nodes whose type matches the job's partition tag."""
    return sched.partition_ok(take(state.part, job), statics.node_type)


def _score_place(
    state: SimState,
    job: torch.Tensor,
    score: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Choose `n_nodes[job]` feasible nodes with the LOWEST score, ties by
    lowest index."""
    K = state.placement.shape[1]
    N = state.free.shape[1]
    ok = sched.feasible_nodes(state, job)
    if mask is not None:
        ok = ok & mask
    n_req = take(state.n_nodes, job)
    key = torch.where(ok, score, float("inf"))
    kk = min(K, N)
    idx = torch.sort(key, stable=True).indices[:kk].to(torch.int32)
    if kk < K:
        idx = torch.cat([idx, torch.full((K - kk,), -1, dtype=torch.int32,
                                         device=idx.device)])
    slots = torch.arange(K, device=idx.device)
    row = torch.where(slots < n_req, idx, -1)
    enough = torch.sum(ok) >= n_req
    return torch.where(enough, row, -1), enough


def _free_frac(state: SimState, statics: Statics) -> torch.Tensor:
    """(N,) mean free fraction across resources — the remaining-capacity
    score shared by best_fit (ascending) and spread (descending). The
    three resources are summed in order, then divided, as a mean is."""
    ff = state.free / torch.clamp(statics.capacity, min=1e-6)
    return (ff[0] + ff[1] + ff[2]) / 3.0


def watts_per_gflop(statics: Statics) -> torch.Tensor:
    """(N,) full-load watts per peak GFLOP/s — the `green` node score."""
    return statics.node_max_w / torch.clamp(statics.peak_gflops, min=1.0)


def place_first_fit(state: SimState, statics: Statics, job: torch.Tensor):
    return sched.first_fit(state, job, state.placement.shape[1])


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

# Per-strategy node-eligibility masks beyond the free pool, as batched
# (state, statics) -> (J, N) functions; None = every node eligible.
# Selection (EASY's no-doomed-pick guarantee) resolves masking here.
PLACEMENT_MASKS: Dict[str, object] = {
    "first_fit": None,
    "best_fit": None,
    "spread": None,
    "partition": sched.partition_mask_all,
    "green": None,
}
assert set(PLACEMENT_MASKS) == set(PLACEMENTS)
