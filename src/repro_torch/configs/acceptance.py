"""The port's acceptance cases: one hour of trace replay on the full
TX-GAIA twin (672 nodes, 21 racks), the JAX package's benches.

- ``replay_tx_gaia_1h``: thermals off (``benchmarks/bench_sim.py:44-60``).
- ``replay_tx_gaia_1h_thermal``: the rack thermal twin on
  (``bench_thermal``, ``benchmarks/bench_sim.py:303-341``). At TX-GAIA's
  default thresholds no rack reaches the throttle or the trip, so it
  drives the RC loop and the dynamic COP.
- ``replay_tx_gaia_1h_thermal_stress``: the same with a short rack time
  constant and low thresholds, so racks ride the throttle ramp and cross
  the dispatch trip at full width.

``PINNED[case]`` holds what the JAX package's ``run_episode(...,
"replay", summary_only=True)`` + ``summary(state, telemetry)`` give for
each case on the CPU (jax 0.9.0). ``chip_smoke.py`` holds the port's run
on the card to these values, and ``tests/test_torch_replay.py`` and
``tests/test_torch_thermal.py`` keep them honest against a live
reference run.
"""

from __future__ import annotations

from repro_torch.configs.sim import SimConfig, tx_gaia
from repro_torch.data.synth_trace import synth_workload

N_STEPS = 3600
SCHEDULER = "replay"
SEED = 0

# racks ride the throttle ramp and cross the trip within the hour
THERMAL_STRESS = dict(rack_tau_s=120.0, thermal_trip_c=26.0,
                      throttle_start_c=24.0, throttle_full_c=34.0)

CASES = {
    "replay_tx_gaia_1h": {},
    "replay_tx_gaia_1h_thermal": dict(thermal_enabled=True),
    "replay_tx_gaia_1h_thermal_stress": dict(thermal_enabled=True,
                                             **THERMAL_STRESS),
}

PINNED = {
    "replay_tx_gaia_1h": {
        "completed": 103.0,
        "energy_kwh": 264.79302978515625,
        "avg_pue": 1.2523986388179378,
        "mean_wait_s": 0.7530097591066823,
        "carbon_kg": 132.01934814453125,
    },
    "replay_tx_gaia_1h_thermal": {
        "completed": 103.0,
        "energy_kwh": 266.0106201171875,
        "avg_pue": 1.2581575082100478,
        "peak_rack_outlet_c": 28.327625274658203,
        "thermal_throttle_s": 0.0,
        "mean_cop": 5.6555938720703125,
        "carbon_kg": 132.62652587890625,
        "mean_wait_s": 0.7530097591066823,
    },
    "replay_tx_gaia_1h_thermal_stress": {
        "completed": 94.0,
        "energy_kwh": 264.5250549316406,
        "avg_pue": 1.2582372818223801,
        "peak_rack_outlet_c": 27.689422607421875,
        "thermal_throttle_s": 3020.0,
        "mean_cop": 5.653233528137207,
        "carbon_kg": 131.8872528076172,
        "mean_wait_s": 0.7990804631659325,
    },
}
RTOL = 1e-5   # float metrics; "completed" must match exactly


def config(case: str = "replay_tx_gaia_1h") -> SimConfig:
    return tx_gaia(max_jobs=256, max_nodes_per_job=16, **CASES[case])


def workload(cfg: SimConfig):
    """(jobs dict, trace bank): 200 synthetic jobs over one hour."""
    return synth_workload(cfg, 200, 3600.0, seed=SEED)


def check(case: str, got: dict) -> None:
    """Raise unless the summary ``got`` meets ``PINNED[case]``: the
    completion count exactly, every other value to ``RTOL``."""
    pins = PINNED[case]
    if got["completed"] != pins["completed"]:
        raise AssertionError(f"{case}: completed {got['completed']} != "
                             f"pinned {pins['completed']}")
    for k, v in pins.items():
        if abs(got[k] - v) > RTOL * abs(v):
            raise AssertionError(f"{case}: {k} {got[k]!r} vs pinned {v!r} "
                                 f"(rtol {RTOL})")
