"""Trace replay + rescheduling of a SuperCloud-schema dataset.

Writes a synthetic dataset in the MIT SuperCloud CSV schema (the real one
is not downloadable offline), parses it with the schema-faithful loader,
replays the recorded schedule, then re-schedules the same jobs under
FCFS / SJF / EASY-backfill and compares sustainability metrics — the
paper's core "tool to study optimal scheduling policies" workflow.

  PYTHONPATH=src python -m repro_torch.examples.replay_supercloud \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.sim import SimConfig, tx_gaia
from repro_torch.core import (
    build_statics,
    init_state,
    load_jobs,
    run_episode,
    summary,
)
from repro_torch.data import load_supercloud, write_supercloud_csvs
from repro_torch.utils.device import resolve_device

SCHEDULERS = ("replay", "fcfs", "sjf", "easy", "priority")


def compare_policies(cfg: SimConfig, path: str, n_steps: int, device,
                     schedulers=SCHEDULERS) -> dict:
    """The SuperCloud dataset at ``path`` replayed and rescheduled for
    ``n_steps`` ticks under each of ``schedulers`` on ``device``. Returns
    the summary of each."""
    jobs, bank = load_supercloud(path, cfg)
    statics = build_statics(cfg, bank, device=device)
    state = load_jobs(init_state(cfg, statics, 0), jobs)
    return {sched: summary(run_episode(cfg, statics, state, n_steps,
                                       sched)[0])
            for sched in schedulers}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = tx_gaia(max_jobs=128, max_nodes_per_job=8)
    path = tempfile.mkdtemp(prefix="supercloud_")
    write_supercloud_csvs(path, cfg, n_jobs=96, horizon_s=1800.0, seed=42)
    print(f"synthetic SuperCloud dataset at {path}:")
    for f in sorted(os.listdir(path)):
        print(f"  {f} ({os.path.getsize(os.path.join(path, f)):,} bytes)")

    rows = compare_policies(cfg, path, 5400, device)
    print(f"\n{'policy':10s} {'completed':>9s} {'energy kWh':>11s} "
          f"{'carbon kg':>9s} {'slowdown':>8s} {'wait s':>8s} {'PUE':>6s}")
    for sched, s in rows.items():
        print(f"{sched:10s} {s['completed']:9.0f} {s['energy_kwh']:11.1f} "
              f"{s['carbon_kg']:9.2f} {s['mean_slowdown']:8.2f} "
              f"{s['mean_wait_s']:8.0f} {s['avg_pue']:6.3f}")
    return rows


if __name__ == "__main__":
    main()
