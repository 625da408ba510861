"""MIT SuperCloud dataset IO (schema-faithful, Samsi et al. HPEC'21).

The dataset ships as CSVs:
  scheduler-log.csv : job_id,time_submit,time_start,time_end,nodes_alloc,
                      cpus_req,gpus_req,mem_req_gb,partition,state
  cpu-telemetry.csv : timestamp,node,job_id,cpu_util   (10 s quanta)
  gpu-telemetry.csv : timestamp,node,gpu_index,job_id,util_pct,power_w
                      (100 ms quanta)

``load_supercloud`` parses these into the simulator workload + trace bank,
band-averaging telemetry onto the sim's trace quanta exactly as RAPS does.
``write_supercloud_csvs`` emits synthetic data in the same schema so the
parser is exercised end-to-end offline (see DESIGN.md assumption table).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.sim import SimConfig, partition_type_indices
from repro_torch.data.validate import (
    IngestionReport,
    check_telemetry_row,
    validate_sched_rows,
)
from repro_torch.utils.errors import TraceValidationError

SCHED_COLS = [
    "job_id", "time_submit", "time_start", "time_end", "nodes_alloc",
    "cpus_req", "gpus_req", "mem_req_gb", "partition", "state",
]
CPU_COLS = ["timestamp", "node", "job_id", "cpu_util"]
GPU_COLS = ["timestamp", "node", "gpu_index", "job_id", "util_pct", "power_w"]


def write_supercloud_csvs(
    path: str,
    cfg: SimConfig,
    n_jobs: int,
    horizon_s: float,
    seed: int = 0,
    *,
    cpu_quanta_s: float = 10.0,
    gpu_quanta_s: float = 0.1,
    gpu_telemetry_stride: int = 100,   # write every k-th 100ms sample
) -> str:
    """Generate a synthetic dataset in the SuperCloud schema. Returns path."""
    from repro_torch.data.synth_trace import synth_workload

    os.makedirs(path, exist_ok=True)
    jobs, bank = synth_workload(cfg, n_jobs, horizon_s, seed)
    J = n_jobs

    with open(os.path.join(path, "scheduler-log.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(SCHED_COLS)
        for j in range(J):
            start = jobs["submit_t"][j] + abs(
                np.random.default_rng(seed + j).normal(20, 10)
            )
            w.writerow([
                j + 1,
                f"{jobs['submit_t'][j]:.1f}",
                f"{start:.1f}",
                f"{start + jobs['dur'][j]:.1f}",
                int(jobs["n_nodes"][j]),
                int(jobs["req"][0, j]),
                int(jobs["req"][1, j]),
                f"{jobs['req'][2, j]:.1f}",
                "xeon-g6" if jobs["req"][1, j] > 0 else "xeon-p8",
                "COMPLETED",
            ])

    # telemetry: per-job time series (node attribution simplified to rank 0)
    with open(os.path.join(path, "cpu-telemetry.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CPU_COLS)
        for j in range(J):
            Q = bank["cpu"].shape[1]
            for q in range(0, Q, max(1, int(cpu_quanta_s / cfg.trace_quanta))):
                if q * cfg.trace_quanta > jobs["dur"][j]:
                    break
                w.writerow([f"{q * cfg.trace_quanta:.1f}", f"n{j % cfg.n_nodes:04d}",
                            j + 1, f"{bank['cpu'][j, q]:.4f}"])

    with open(os.path.join(path, "gpu-telemetry.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(GPU_COLS)
        step = gpu_telemetry_stride
        for j in range(J):
            if jobs["req"][1, j] == 0:
                continue
            Q = bank["gpu"].shape[1]
            for q in range(0, Q, step):
                if q * gpu_quanta_s * step > jobs["dur"][j]:
                    break
                u = bank["gpu"][j, min(int(q * gpu_quanta_s * step / cfg.trace_quanta), Q - 1)]
                w.writerow([
                    f"{q * gpu_quanta_s * step:.1f}", f"n{j % cfg.n_nodes:04d}", 0,
                    j + 1, f"{100 * u:.2f}", f"{55 + 245 * u:.1f}",
                ])
    return path


def load_supercloud(
    path: str,
    cfg: SimConfig,
    *,
    validate: str = "repair",
    return_report: bool = False,
):
    """Parse SuperCloud-schema CSVs -> (jobs dict, trace bank).

    Telemetry is averaged onto ``cfg.trace_quanta`` bands (RAPS trace
    quanta); jobs without telemetry fall back to a constant 70% profile.

    ``validate`` (see :mod:`repro_torch.data.validate`): ``"repair"`` (default)
    quarantines corrupt rows and keeps going; ``"strict"`` raises
    :class:`~repro_torch.utils.errors.TraceValidationError` /
    ``SignalValidationError`` naming the offending rows; ``"off"`` trusts
    the input. With ``return_report=True`` the return value grows a third
    element: ``{"scheduler": IngestionReport, "cpu_telemetry": ...,
    "gpu_telemetry": ...}`` accounting for every dropped row.
    """
    sched_file = os.path.join(path, "scheduler-log.csv")
    rows = []
    with open(sched_file) as f:
        for row in csv.DictReader(f):
            rows.append(row)
    rows, sched_rep = validate_sched_rows(
        rows, cfg, mode=validate, source=sched_file)
    J = len(rows)
    if J > cfg.max_jobs:
        sched_rep.warnings.append({
            "row": cfg.max_jobs, "check": "truncated",
            "detail": f"{J - cfg.max_jobs} valid job(s) beyond "
                      f"cfg.max_jobs={cfg.max_jobs} dropped"})
        rows = rows[: cfg.max_jobs]
        J = cfg.max_jobs

    submit = np.array([float(r["time_submit"]) for r in rows], np.float32)
    start = np.array([float(r["time_start"]) for r in rows], np.float32)
    end = np.array([float(r["time_end"]) for r in rows], np.float32)
    dur = np.maximum(end - start, 1.0)
    n_nodes = np.array([int(r["nodes_alloc"]) for r in rows], np.int32)
    req = np.stack([
        np.array([float(r["cpus_req"]) for r in rows], np.float32),
        np.array([float(r["gpus_req"]) for r in rows], np.float32),
        np.array([float(r["mem_req_gb"]) for r in rows], np.float32),
    ])
    job_ids = {int(r["job_id"]): i for i, r in enumerate(rows)}

    Q = max(int(np.ceil(dur.max() / cfg.trace_quanta)) + 1, 8)
    Jmax = cfg.max_jobs
    cpu = np.zeros((Jmax, Q), np.float32)
    gpu = np.zeros((Jmax, Q), np.float32)
    cpu_n = np.zeros((Jmax, Q), np.float32)
    gpu_n = np.zeros((Jmax, Q), np.float32)

    def accumulate(fname, util_col, target, counts, scale, hi):
        fpath = os.path.join(path, fname)
        rep = IngestionReport(source=fpath, kind="telemetry", mode=validate)
        if not os.path.exists(fpath):
            return rep
        with open(fpath) as f:
            for i, row in enumerate(csv.DictReader(f)):
                rep.n_input += 1
                if validate == "off":
                    parsed = (int(row["job_id"]), float(row["timestamp"]),
                              float(row[util_col]))
                else:
                    parsed = check_telemetry_row(
                        row, util_col=util_col, lo=0.0, hi=hi,
                        rownum=i, report=rep)
                    if parsed is None:
                        continue
                jid, t, u = parsed
                rep.n_ok += 1
                if jid not in job_ids:
                    # jobs beyond max_jobs / quarantined jobs: skippable,
                    # counted (not corrupt — the job just isn't loaded)
                    rep.n_skipped_unknown_id += 1
                    continue
                j = job_ids[jid]
                q = min(int(t / cfg.trace_quanta), Q - 1)
                target[j, q] += u * scale
                counts[j, q] += 1.0
        if validate == "strict":
            rep.raise_if_dirty(TraceValidationError)
        return rep

    cpu_rep = accumulate("cpu-telemetry.csv", "cpu_util", cpu, cpu_n,
                         1.0, 1.0)
    gpu_rep = accumulate("gpu-telemetry.csv", "util_pct", gpu, gpu_n,
                         0.01, 100.0)
    cpu = np.where(cpu_n > 0, cpu / np.maximum(cpu_n, 1), 0.0)
    gpu = np.where(gpu_n > 0, gpu / np.maximum(gpu_n, 1), 0.0)
    # fill forward within each job's duration; default 0.7 when absent
    for j in range(J):
        qmax = min(int(dur[j] / cfg.trace_quanta) + 1, Q)
        if cpu[j, :qmax].max() == 0:
            cpu[j, :qmax] = 0.7
        if req[1, j] > 0 and gpu[j, :qmax].max() == 0:
            gpu[j, :qmax] = 0.7

    # partition tag: match the CSV partition name against cfg node-type
    # names; unknown names fall back to "needs GPUs -> first GPU type,
    # else first CPU-only type" so TX-GAIA semantics survive renames, and
    # to -1 (any node) when the config has no type of that kind — a made-up
    # single-type confinement would silently skew utilization results
    type_names = {t.name: i for i, t in enumerate(cfg.node_types)}
    gpu_ti, cpu_ti = partition_type_indices(cfg)
    part = np.array([
        type_names.get(r.get("partition", ""),
                       gpu_ti if req[1, i] > 0 else cpu_ti)
        for i, r in enumerate(rows)
    ], np.int32)

    jobs = {
        "submit_t": submit, "dur": dur.astype(np.float32), "n_nodes": n_nodes,
        "req": req, "priority": start,  # replay dispatches at recorded starts
        "part": part,
    }
    bank = {"cpu": cpu, "gpu": gpu, "net_tx": np.zeros((Jmax,), np.float32)}
    if return_report:
        report = {"scheduler": sched_rep, "cpu_telemetry": cpu_rep,
                  "gpu_telemetry": gpu_rep}
        return jobs, bank, report
    return jobs, bank
