"""Synthetic datacenter workloads from the performance model — the paper's
"can generate synthetic workloads using performance modeling tools, such as
Calculon [11]" path, and its "virtual benchmarking of speculative systems":
LM training/serving jobs over the assigned architectures become RAPS jobs
with durations, utilizations and network traffic derived analytically.

The JAX package's ``perfmodel/workload_gen.py``: host numpy, the same
``default_rng`` draws and dtypes, so both packages build the same arrays
bit for bit. ``data.synth_trace.synth_workload``'s form: the twin's
``build_statics`` and ``load_jobs`` take them on any device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_arch
from repro_torch.configs.sim import SimConfig
from repro_torch.perfmodel.constants import V5E
from repro_torch.perfmodel.roofline import analytic_roofline


def lm_training_job(
    arch: str,
    shape_name: str = "train_4k",
    *,
    n_chips: int = 256,
    chips_per_node: int = 4,
    token_budget: float = 2e9,
) -> Dict[str, float]:
    """One LM job: duration + utilization from the roofline estimate."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    est = analytic_roofline(cfg, shape, n_chips=n_chips)
    tokens_per_step = shape.global_batch * (
        1 if shape.mode == "decode" else shape.seq_len
    )
    steps = token_budget / max(tokens_per_step, 1)
    duration_s = steps * est.step_s
    n_nodes = max(n_chips // chips_per_node, 1)
    return {
        "arch": arch,
        "shape": shape_name,
        "n_nodes": n_nodes,
        "duration_s": duration_s,
        "gpu_util": est.util,                # accelerator busy fraction
        "cpu_util": 0.25 + 0.1 * est.util,   # host input pipeline
        "net_tx_gbps": est.collective_bytes_per_dev
        * chips_per_node / max(est.step_s, 1e-9) / 1e9,
        "chip_power_w": est.chip_power_w,
        "step_s": est.step_s,
        "dominant": est.dominant,
    }


def serving_profile(
    arch: str = "gemma3-1b",
    *,
    n_chips: int = 16,
    chips_per_node: int = 4,
    gen_tokens: int = 256,
) -> Dict[str, float]:
    """Serving-twin knobs for one LM deployment from the roofline model.

    Derives the per-request prefill/decode split, the end-to-end service
    time, and the per-node power profile for ``core.serving`` from the
    analytic estimates: a request is one prefill step plus ``gen_tokens``
    decode steps on an ``n_chips`` slice. Returns kwargs consumable by
    ``SimConfig`` (``tiny_cluster(**serving_profile(...),
    serving_enabled=True, serving_nodes=...)``).
    """
    pf = analytic_roofline(get_arch(arch), SHAPES["prefill_32k"],
                           n_chips=n_chips)
    dc = analytic_roofline(get_arch(arch), SHAPES["decode_32k"],
                           n_chips=n_chips)
    prefill_s = pf.step_s
    decode_s = gen_tokens * dc.step_s
    service_s = prefill_s + decode_s
    n_nodes = max(n_chips // chips_per_node, 1)
    return {
        "serving_service_s": service_s,
        "serving_prefill_frac": prefill_s / max(service_s, 1e-12),
        "serving_prefill_util": min(pf.util, 1.0),
        "serving_decode_util": min(dc.util, 1.0),
        # batched decode: the deployment serves global_batch concurrent
        # streams, split across the slice's nodes
        "serving_concurrency": SHAPES["decode_32k"].global_batch
        / n_nodes,
        "serving_node_idle_w": chips_per_node * V5E.idle_w,
        "serving_node_dyn_w": chips_per_node * V5E.dyn_w,
    }


def lm_jobs_workload(
    cfg: SimConfig,
    archs: List[str],
    *,
    horizon_s: float = 7200.0,
    n_jobs: int = 32,
    seed: int = 0,
    chips_per_node: int = 4,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A RAPS workload of LM jobs (mixed archs/scales) for the twin.

    Returns (jobs, trace bank) exactly like ``synth_trace.synth_workload``.
    """
    rng = np.random.default_rng(seed)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    submit, dur, n_nodes, gpu_u, cpu_u, net = [], [], [], [], [], []
    for j in range(n_jobs):
        arch = archs[int(rng.integers(0, len(archs)))]
        shape = shapes[int(rng.integers(0, len(shapes)))]
        chips = int(2 ** rng.integers(2, 7))  # 4..64 chips
        tokens = float(10 ** rng.uniform(7.5, 9.5))
        job = lm_training_job(arch, shape, n_chips=max(chips, 16),
                              chips_per_node=chips_per_node,
                              token_budget=tokens)
        submit.append(rng.uniform(0, horizon_s * 0.7))
        dur.append(min(max(job["duration_s"], 60.0), horizon_s))
        n_nodes.append(min(max(chips // chips_per_node, 1),
                           cfg.max_nodes_per_job))
        gpu_u.append(min(job["gpu_util"], 1.0))
        cpu_u.append(min(job["cpu_util"], 1.0))
        net.append(min(job["net_tx_gbps"], 100.0))
    submit = np.sort(np.array(submit, np.float32))
    dur = np.array(dur, np.float32)
    n_nodes = np.array(n_nodes, np.int32)

    gpu_type = cfg.node_types[0]
    req = np.stack([
        np.full(n_jobs, max(gpu_type.cpu_cores // 2, 1), np.float32),
        np.full(n_jobs, gpu_type.gpus, np.float32),
        np.full(n_jobs, gpu_type.mem_gb / 2, np.float32),
    ])
    Q = max(int(np.ceil(dur.max() / cfg.trace_quanta)) + 1, 8)
    Jmax = cfg.max_jobs
    bank = {
        "cpu": np.zeros((Jmax, Q), np.float32),
        "gpu": np.zeros((Jmax, Q), np.float32),
        "net_tx": np.zeros((Jmax,), np.float32),
    }
    t = np.arange(Q)[None, :] * cfg.trace_quanta
    ramp = np.clip(t / 120.0, 0, 1)
    for j in range(n_jobs):
        # training power fluctuates step-to-step (the paper's "large power
        # swings" motivation): square-wave-ish modulation around the mean
        wob = 0.06 * np.sign(np.sin(2 * np.pi * t[0] / 37.0))
        bank["gpu"][j] = np.clip((gpu_u[j] + wob) * ramp[0], 0, 1)
        bank["cpu"][j] = np.clip(cpu_u[j] * ramp[0], 0, 1)
        bank["net_tx"][j] = net[j]
    jobs = {
        "submit_t": submit,
        "dur": dur,
        "n_nodes": n_nodes,
        "req": req,
        "priority": submit,
    }
    return jobs, bank
