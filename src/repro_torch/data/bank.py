"""Workload-bank plumbing: many workloads in one banked trace.

``stack_workloads`` turns a list of ``(jobs, bank)`` tuples (as produced by
``synth_trace.synth_workload`` / ``trace_io.load_supercloud`` /
``perfmodel.lm_jobs_workload``) into

- one *banked* trace bank — ``cpu``/``gpu`` stacked to (W, J, Qmax) with
  the quanta axis padded to the longest workload (holding each job's last
  value, so long jobs keep their final utilization), ``net_tx`` to (W, J);
- one stacked job table — every ``load_jobs``-style field padded to
  ``cfg.max_jobs`` with a leading W axis, plus ``n_valid`` (W,) int32.

The banked bank feeds ``build_statics`` directly and is shared by every
replica of a fleet: a ``SimState.workload`` int32 selects the slice at
trace-lookup time (inside ``power_tick`` and ``core.network``), so each
replica's memory is O(sim state), not O(bank). numpy only: a copy of the
JAX package's module.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.sim import SimConfig

# job-table fields installed per env at reset; everything else in a jobs
# dict (e.g. the helper field ``is_gpu``) is loader-internal and dropped
JOB_FIELDS = ("submit_t", "dur", "n_nodes", "req", "priority", "part")


def _pad_quanta(a: np.ndarray, J: int, qmax: int) -> np.ndarray:
    out = np.zeros((J, qmax), np.float32)
    out[: a.shape[0], : a.shape[1]] = a[:J]
    # hold last value so long jobs keep their final utilization
    out[: a.shape[0], a.shape[1]:] = a[:J, -1:]
    return out


def _pad_jobs(jobs: Dict[str, np.ndarray], J: int) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    n = len(jobs["submit_t"])
    for name in JOB_FIELDS:
        if name not in jobs:
            continue
        arr = np.asarray(jobs[name])
        shape = (arr.shape[0], J) if name == "req" else (J,) + arr.shape[1:]
        buf = np.zeros(shape, arr.dtype)
        if name == "req":
            buf[:, :n] = arr
        else:
            buf[:n] = arr
        out[name] = buf
    out["n_valid"] = np.int32(n)
    return out


def stack_workloads(
    cfg: SimConfig, workloads: Sequence[Tuple[Dict, Dict]]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """[(jobs, bank), ...] -> (stacked jobs (leading W axis), banked trace
    bank {"cpu": (W, J, Qmax), "gpu": (W, J, Qmax), "net_tx": (W, J)})."""
    if not workloads:
        raise ValueError("stack_workloads needs at least one workload")
    J = cfg.max_jobs
    qmax = max(b["cpu"].shape[1] for _, b in workloads)
    def pad_net(a):
        out = np.zeros((J,), np.float32)
        out[: min(len(a), J)] = np.asarray(a, np.float32)[:J]
        return out

    bank = {
        "cpu": np.stack([_pad_quanta(b["cpu"], J, qmax) for _, b in workloads]),
        "gpu": np.stack([_pad_quanta(b["gpu"], J, qmax) for _, b in workloads]),
        "net_tx": np.stack([pad_net(b["net_tx"]) for _, b in workloads]),
    }
    padded: List[Dict[str, np.ndarray]] = [_pad_jobs(j, J) for j, _ in workloads]
    jobs = {name: np.stack([p[name] for p in padded]) for name in padded[0]}
    return jobs, bank
