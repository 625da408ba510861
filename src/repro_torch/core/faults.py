"""Fault engine: only ``release_jobs``, the resource-return routine that
completions and dispatch share with the fault engine's kill path. The
fault clocks, checkpoint/retry rules and the degradation ladder arrive
with the resilience slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import SimState


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
    over jobs, exact in any order while at most two jobs release on one
    node in a tick.
    """
    place = state.placement.long()                         # (..., J, K)
    valid = place >= 0
    member = torch.zeros(place.shape[:-1] + free.shape[-1:],
                         dtype=free.dtype, device=free.device)
    member.scatter_add_(-1, torch.where(valid, place, 0),
                        valid.to(free.dtype))
    amounts = state.req * mask[..., None, :].to(free.dtype)   # (..., R, J)
    return free + torch.matmul(amounts, member)
