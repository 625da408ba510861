"""Quickstart: build the MIT-SuperCloud-style digital twin, replay a
workload, print RAPS-style runtime stats (paper Fig. 2 top-left).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.configs.sim import SimConfig, tx_gaia
from repro_torch.core import (
    build_statics,
    init_state,
    load_jobs,
    run_episode,
    summary,
)
from repro_torch.data import synth_workload
from repro_torch.utils.device import resolve_device


def replay(cfg: SimConfig, n_jobs: int, horizon_s: float, n_steps: int,
           device) -> tuple[dict, dict]:
    """``n_steps`` ticks of "replay" over ``synth_workload(cfg, n_jobs,
    horizon_s, seed=0)`` on ``device``. Returns the episode summary and the
    facility power's peak, minimum and swing in kW."""
    jobs, bank = synth_workload(cfg, n_jobs=n_jobs, horizon_s=horizon_s,
                                seed=0)
    statics = build_statics(cfg, bank, device=device)
    state = load_jobs(init_state(cfg, statics, 0), jobs)
    final, outs = run_episode(cfg, statics, state, n_steps, "replay")
    p = outs.facility_w
    return summary(final), {"peak_kw": float(p.max()) / 1e3,
                            "min_kw": float(p.min()) / 1e3,
                            "swing_kw": float(p.max() - p.min()) / 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # TX-GAIA twin: 448 dual-V100 nodes + 224 CPU nodes, multi-tenant
    cfg = tx_gaia(max_jobs=256, max_nodes_per_job=16)
    print(f"twin: {cfg.name} ({cfg.n_nodes} nodes), 200 jobs, 1h horizon")
    s, power = replay(cfg, 200, 3600.0, 3600, device)

    print("\n--- simulation runtime stats (dt=1s, trace quanta=10s) ---")
    for k, v in s.items():
        print(f"  {k:22s} {v:,.3f}")
    print(f"  peak facility power    {power['peak_kw']:,.1f} kW")
    print(f"  min facility power     {power['min_kw']:,.1f} kW")
    print(f"  power swing            {power['swing_kw']:,.1f} kW "
          "(the utility-scale swing problem motivating the paper)")
    return {**s, **power}


if __name__ == "__main__":
    main()
