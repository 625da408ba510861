"""The port's acceptance case, ``replay_tx_gaia_1h``: one hour of trace
replay on the full TX-GAIA twin (672 nodes, 21 racks), the JAX package's
``benchmarks/bench_sim.py:44-60`` bench.

``PINNED`` holds what the JAX package's ``run_episode(..., "replay",
summary_only=True)`` + ``summary`` give for it on the CPU (jax 0.9.0; the
default scatter path and the Pallas kernel in interpret mode agree to
the last bit). ``chip_smoke.py`` holds the port's run on the card to
these values, and ``tests/test_torch_replay.py`` keeps them honest
against a live reference run.
"""

from __future__ import annotations

from repro_torch.configs.sim import SimConfig, tx_gaia
from repro_torch.data.synth_trace import synth_workload

N_STEPS = 3600
SCHEDULER = "replay"
SEED = 0

PINNED = {
    "completed": 103.0,
    "energy_kwh": 264.79302978515625,
    "avg_pue": 1.2523986388179378,
    "mean_wait_s": 0.7530097591066823,
    "carbon_kg": 132.01934814453125,
}
RTOL = 1e-5   # float metrics; "completed" must match exactly


def config() -> SimConfig:
    return tx_gaia(max_jobs=256, max_nodes_per_job=16)


def workload(cfg: SimConfig):
    """(jobs dict, trace bank): 200 synthetic jobs over one hour."""
    return synth_workload(cfg, 200, 3600.0, seed=SEED)
