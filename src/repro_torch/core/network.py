"""Inter-job network congestion model (Lassen-style bytes-in/out coupling):
aggregate running-job traffic vs. bisection bandwidth gives a global
contention factor that slows every communicating job's progress.
"""

from __future__ import annotations

import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core.state import RUNNING, SimState, Statics
from repro_torch.utils.device import full


def job_net_tx(state: SimState, statics: Statics) -> torch.Tensor:
    """(..., J) GB/s per job node: the single bank's row, or each
    replica's row of a banked (W, J) table through its workload id."""
    if statics.net_tx.dim() == 1:
        return statics.net_tx
    ids = state.workload.reshape(-1).long()
    return statics.net_tx.index_select(0, ids).view(
        state.workload.shape + statics.net_tx.shape[-1:])


def congestion_slowdown(cfg: SimConfig, state: SimState, statics: Statics):
    """Returns (per-job progress rate in (0,1], network load fraction)."""
    running = (state.jstate == RUNNING).to(torch.float32)
    net_tx = job_net_tx(state, statics)
    # jobs spanning n nodes inject n * net_tx GB/s into the fabric
    tx = net_tx * state.n_nodes.to(torch.float32) * running
    # a device-tensor divisor: true division on every device (the load is
    # compared with the knee, and the rate decides completion ticks)
    bisection = full(max(cfg.bisection_gbps, 1e-6), torch.float32,
                     tx.device)
    load = torch.sum(tx, -1) / bisection
    over = torch.clamp(load - cfg.congestion_knee, min=0.0)
    factor = 1.0 + over ** cfg.congestion_exp
    # only network-active jobs are slowed; CPU-bound jobs keep full rate
    slowed = 1.0 / factor
    rate = torch.where(net_tx > 0, slowed[..., None], 1.0)
    return torch.where(running > 0, rate, 0.0), load
