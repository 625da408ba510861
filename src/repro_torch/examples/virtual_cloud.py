"""Virtual benchmarking of a speculative system (paper: "ExaDigiT can
create a virtual cloud system ... virtual prototyping of hardware/software
and virtual benchmarking of speculative systems").

The analytic performance model (Calculon-analogue) turns the assigned LM
architectures into datacenter jobs; the twin then answers a what-if:
how do energy, carbon and throughput change if the cooling plant degrades
(higher wet-bulb) or the rectifiers are upgraded? The perf model's step
times are roofline estimates for the modelled accelerator
(``perfmodel.constants.V5E``), not measurements of the card the twin runs
on.

  PYTHONPATH=src python -m repro_torch.examples.virtual_cloud [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import acceptance as A
from repro_torch.configs.sim import SimConfig
from repro_torch.core import (
    build_statics,
    init_state,
    load_jobs,
    run_episode,
    summary,
)
from repro_torch.perfmodel import lm_training_job
from repro_torch.utils.device import resolve_device


def lm_jobs(archs=("qwen3-4b", "mixtral-8x22b", "gemma3-1b")) -> dict:
    """Each arch's ``train_4k`` job on 64 modelled chips for 5e8 tokens."""
    return {arch: lm_training_job(arch, "train_4k", n_chips=64,
                                  token_budget=5e8) for arch in archs}


def what_if(cfg: SimConfig, jobs, bank, n_steps: int, device) -> dict:
    """``n_steps`` ticks of "easy" over the LM jobs on ``cfg`` on
    ``device``: the summary."""
    statics = build_statics(cfg, bank, device=device)
    st = load_jobs(init_state(cfg, statics, 0), jobs)
    final, telem = run_episode(cfg, statics, st, n_steps,
                               A.VIRTUAL_CLOUD_SCHEDULER, summary_only=True)
    return summary(final, telem)


def what_ifs(base: SimConfig, n_steps: int, device,
             scenarios=tuple(A.VIRTUAL_CLOUD_WHAT_IFS)) -> dict:
    """The virtual cloud's LM workload on ``base`` under each of the
    what-ifs (``acceptance.VIRTUAL_CLOUD_WHAT_IFS``, overrides of
    ``base``): the summary of each."""
    jobs, bank = A.virtual_cloud_workload(base)
    return {name: what_if(dataclasses.replace(
                base, **A.VIRTUAL_CLOUD_WHAT_IFS[name]),
                jobs, bank, n_steps, device)
            for name in scenarios}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("=== LM jobs from the performance model (Calculon-analogue) ===")
    for arch, j in lm_jobs().items():
        print(f"  {arch:15s} step={j['step_s']*1e3:7.1f} ms "
              f"dur={j['duration_s']/60:6.1f} min util={j['gpu_util']:.2f} "
              f"net={j['net_tx_gbps']:6.1f} GB/s bound={j['dominant']}")

    rows = what_ifs(A.virtual_cloud_config(), A.VIRTUAL_CLOUD_TICKS, device)
    print("\n=== what-if scenarios on the twin (same workload) ===")
    print(f"{'scenario':24s} {'energy kWh':>10s} {'carbon kg':>9s} "
          f"{'PUE':>6s} {'completed':>9s}")
    for name, s in rows.items():
        print(f"{name:24s} {s['energy_kwh']:10.1f} {s['carbon_kg']:9.2f} "
              f"{s['avg_pue']:6.3f} {s['completed']:9.0f}")
    return rows


if __name__ == "__main__":
    main()
