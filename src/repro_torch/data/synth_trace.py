"""Synthetic MIT-SuperCloud-like workloads.

The real dataset cannot be downloaded offline, so we synthesize workloads
with its statistical character (paper §: heterogeneity + multi-tenancy):
Poisson arrivals; lognormal durations; a GPU partition (1-2 GPU jobs,
fractional-node CPU usage) and a CPU partition (multi-tenant, fractional
cores); per-job utilization profiles quantized at the trace quanta (10 s
CPU / 100 ms GPU in the dataset; we band-average onto the sim quanta as
RAPS does); per-job network traffic for the congestion model.

``synth_workload`` returns (jobs dict for ``load_jobs``, trace bank for
``build_statics``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.sim import SimConfig, partition_type_indices


def synth_workload(
    cfg: SimConfig,
    n_jobs: int,
    horizon_s: float,
    seed: int = 0,
    *,
    gpu_fraction: float = 0.55,
    mean_dur_s: float = 1200.0,
    arrival: str = "poisson",      # 'poisson' | 'burst'
    net_heavy_fraction: float = 0.2,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    assert n_jobs <= cfg.max_jobs
    rng = np.random.default_rng(seed)
    J = n_jobs

    if arrival == "poisson":
        gaps = rng.exponential(horizon_s / max(n_jobs, 1), J)
        submit = np.clip(np.cumsum(gaps) - gaps[0], 0, horizon_s * 0.9)
    else:  # bursty: jobs arrive in waves (shift-change pattern)
        waves = rng.integers(0, 4, J) * (horizon_s / 4)
        submit = np.sort(waves + rng.exponential(60.0, J))

    dur = np.clip(rng.lognormal(np.log(mean_dur_s), 0.9, J), 30.0, horizon_s)
    is_gpu = rng.random(J) < gpu_fraction

    # derive the partition types from the config (first GPU-bearing type,
    # first CPU-only type) instead of assuming a gpu-first ordering;
    # -1 tags = any node when the config lacks that kind
    gpu_ti, cpu_ti = partition_type_indices(cfg)
    gpu_type = cfg.node_types[gpu_ti if gpu_ti >= 0 else 0]
    cpu_type = cfg.node_types[cpu_ti if cpu_ti >= 0 else -1]
    n_nodes = np.where(
        is_gpu,
        np.minimum(2 ** rng.integers(0, 3, J), cfg.max_nodes_per_job),
        1,
    ).astype(np.int32)

    # per-node demand: GPU jobs take 1..gpus GPUs + some cores; CPU jobs are
    # multi-tenant fractional (cores only)
    gpus_req = np.where(is_gpu, rng.integers(1, gpu_type.gpus + 1, J), 0)
    cores_req = np.where(
        is_gpu,
        rng.integers(4, max(gpu_type.cpu_cores // 2, 5), J),
        rng.integers(1, max(cpu_type.cpu_cores // 2, 2), J),
    )
    mem_req = np.where(
        is_gpu,
        rng.uniform(16, gpu_type.mem_gb / 2, J),
        rng.uniform(2, cpu_type.mem_gb / 4, J),
    )
    req = np.stack([cores_req, gpus_req, mem_req]).astype(np.float32)

    # utilization profiles at sim quanta
    Q = max(int(np.ceil(dur.max() / cfg.trace_quanta)) + 1, 8)
    tgrid = np.arange(Q)[None, :] * cfg.trace_quanta
    base_cpu = rng.uniform(0.25, 0.95, J)[:, None]
    base_gpu = np.where(is_gpu, rng.uniform(0.35, 0.98, J), 0.0)[:, None]
    wob = 0.08 * np.sin(2 * np.pi * tgrid / rng.uniform(120, 900, J)[:, None])
    noise = rng.normal(0, 0.03, (J, Q))
    ramp = np.clip(tgrid / 60.0, 0, 1)   # 1-minute startup ramp
    cpu_trace = np.clip((base_cpu + wob + noise) * ramp, 0, 1).astype(np.float32)
    gpu_trace = np.clip((base_gpu + wob + noise) * ramp, 0, 1).astype(np.float32)

    net_tx = np.where(
        rng.random(J) < net_heavy_fraction,
        rng.uniform(5.0, 40.0, J),     # GB/s per node: comm-heavy (training)
        rng.uniform(0.0, 0.5, J),
    ).astype(np.float32)

    jobs = {
        "submit_t": submit.astype(np.float32),
        "dur": dur.astype(np.float32),
        "n_nodes": n_nodes,
        "req": req,
        "priority": submit.astype(np.float32),   # replay: start ~ submit
        "is_gpu": is_gpu,
        # partition tag = node-type index (mirroring TX-GAIA's xeon-g6 /
        # xeon-p8 split); consumed by load_jobs -> `partition` placement
        "part": np.where(is_gpu, gpu_ti, cpu_ti).astype(np.int32),
    }
    # pad trace bank to max_jobs
    Jmax = cfg.max_jobs
    bank = {
        "cpu": np.zeros((Jmax, Q), np.float32),
        "gpu": np.zeros((Jmax, Q), np.float32),
        "net_tx": np.zeros((Jmax,), np.float32),
    }
    bank["cpu"][:J] = cpu_trace
    bank["gpu"][:J] = gpu_trace
    bank["net_tx"][:J] = net_tx
    return jobs, bank


def replay_priorities(jobs: Dict[str, np.ndarray], recorded_start: np.ndarray):
    """For replay mode, priority carries the recorded start times."""
    out = dict(jobs)
    out["priority"] = recorded_start.astype(np.float32)
    return out
