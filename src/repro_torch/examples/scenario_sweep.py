"""Policy x scenario sweep: ONE batched run simulates a fleet of
datacenter replicas crossing scheduling policies (selection x placement,
policy-as-data) with heterogeneous grid scenarios — parametric diurnal
carbon, trace-driven carbon (synthetic grid-operator feed),
demand-response power-cap events, heatwaves — and compares
sustainability outcomes per (policy, scenario) cell.

  PYTHONPATH=src python -m repro_torch.examples.scenario_sweep \\
      [--steps 1200] [--selects fcfs,sjf] [--places first_fit,green] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.sim import SimConfig, tiny_cluster
from repro_torch.core import (
    build_statics,
    fleet_summary,
    init_state,
    load_jobs,
    policy_grid,
    policy_scenario_grid,
    run_fleet,
)
from repro_torch.data import synth_grid_trace, synth_workload
from repro_torch.scenarios import (
    carbon_trace,
    default_scenario,
    demand_response,
    heatwave,
    solar_heavy,
)
from repro_torch.utils.device import resolve_device


def build_scenarios(cfg: SimConfig, horizon_s: float):
    """5 scenario families (>= 3 distinct kinds: parametric carbon,
    trace-driven carbon, scheduled power-cap event)."""
    values, dt = synth_grid_trace("carbon", horizon_s * 4, dt=60.0, seed=1)
    nameplate = 1.3 * cfg.nameplate_it_w
    return [
        ("diurnal", default_scenario(cfg)),
        ("solar_heavy", solar_heavy(cfg)),
        ("carbon_trace", carbon_trace(cfg, values, dt)),
        ("demand_response", demand_response(
            cfg, cap_w=0.45 * nameplate, event_start_s=horizon_s * 0.3,
            event_len_s=horizon_s * 0.3)),
        ("heatwave", heatwave(cfg)),
    ]


def sweep(cfg: SimConfig, steps: int, selects, places, device):
    """The policy grid (``selects`` x ``places``) crossed with
    ``build_scenarios`` for ``steps`` ticks in one ``run_fleet`` on
    ``device`` (replica i runs policy i // S under scenario i % S). Returns
    [(policy, scenario, summary row, peak facility kW)] per replica."""
    horizon = steps * cfg.dt
    jobs, bank = synth_workload(cfg, 32, horizon * 0.75, seed=0)
    statics = build_statics(cfg, bank, device=device)
    state = load_jobs(init_state(cfg, statics, 0), jobs)

    scn_items = build_scenarios(cfg, horizon)
    scn_names = [n for n, _ in scn_items]
    pol_names, grid = policy_grid(selects, places)
    pols, scns = policy_scenario_grid(grid, [s for _, s in scn_items])
    # summary_only: the episode's reductions accumulate tick by tick, so
    # the fleet's memory does not grow with ``steps``
    finals, tel = run_fleet(cfg, statics, state, steps, scenarios=scns,
                            policies=pols, summary_only=True)
    rows = fleet_summary(finals)
    peak_w = tel.max_facility_w.cpu().numpy()
    cells = [(p, s) for p in pol_names for s in scn_names]
    return [(p, s, rows[i], float(peak_w[i]) / 1e3)
            for i, (p, s) in enumerate(cells)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--selects", default="fcfs,sjf,easy",
                    help="comma-separated job-selection policies")
    ap.add_argument("--places", default="first_fit,green",
                    help="comma-separated node-placement strategies")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = tiny_cluster()
    selects = [s.strip() for s in args.selects.split(",") if s.strip()]
    places = [p.strip() for p in args.places.split(",") if p.strip()]
    n_pol = len(selects) * len(places)
    print(f"fleet: {n_pol} policies x 5 scenarios = {n_pol * 5} replicas x "
          f"{args.steps} steps, one batched run")
    out = sweep(cfg, args.steps, selects, places, device)

    print(f"\n{'policy':22s} {'scenario':16s} {'energy_kwh':>11s} "
          f"{'carbon_kg':>10s} {'cost_usd':>9s} {'completed':>9s} "
          f"{'peak_kw':>8s}")
    for p, s, r, peak_kw in out:
        print(f"{p:22s} {s:16s} {r['energy_kwh']:11.3f} "
              f"{r['carbon_kg']:10.3f} {r['elec_cost_usd']:9.4f} "
              f"{r['completed']:9.1f} {peak_kw:8.2f}")
    return out


if __name__ == "__main__":
    main()
