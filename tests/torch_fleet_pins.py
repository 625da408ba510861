"""Print ``PINNED_FLEET`` for ``repro_torch.configs.acceptance``: the JAX
package's vmapped ``run_fleet`` over the fleet case's grid (the
``replay_tx_gaia_1h`` config and workload, 8 policies x 9 scenarios, 3600
ticks, ``summary_only=True``) on the CPU, per replica ``completed`` and
``acceptance.FLEET_KEYS``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fleet_pins.py

Not a test module: the whole grid takes ~2 min on 8 CPU cores.
"""

from __future__ import annotations

import json
import math
import sys
import time

import jax
import numpy as np

import repro.configs.sim as rcfg
import repro.core as R
from repro.core.fleet import fleet_summary, policy_scenario_grid, run_fleet
from repro.core.fleet import _scenario_list
from repro.core.placement import policy_grid
from repro.data import synth_workload
from repro.scenarios.scenario import (
    default_scenario,
    demand_response,
    sample_scenarios,
)
from repro_torch.configs import acceptance as A


def reference_grid(cfg):
    """The fleet case's (batched Policy, batched Scenario) in the JAX
    package, built as ``acceptance.fleet_scenarios`` builds the port's."""
    dr = demand_response(
        cfg, cap_w=A.FLEET_DR["cap_frac"] * cfg.nameplate_it_w,
        event_start_s=A.FLEET_DR["event_start_s"],
        event_len_s=A.FLEET_DR["event_len_s"])
    scns = ([default_scenario(cfg)]
            + _scenario_list(sample_scenarios(cfg, A.FLEET_SAMPLED,
                                              seed=A.SEED))
            + [dr])
    _, pols = policy_grid(A.FLEET_SELECTS, A.FLEET_PLACES)
    return policy_scenario_grid(pols, scns)


def main() -> int:
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16)
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    pols, scns = reference_grid(cfg)
    t0 = time.time()
    fs, tel = run_fleet(cfg, st, s, A.N_STEPS, policies=pols, scenarios=scns,
                        summary_only=True)
    jax.block_until_ready(fs)
    rows = fleet_summary(fs, tel)
    print(f"# {len(rows)} replicas in {time.time() - t0:.1f} s, jax "
          f"{jax.__version__}", file=sys.stderr)
    pins = {"completed": [r["completed"] for r in rows]}
    for k in A.FLEET_KEYS:
        pins[k] = [r[k] for r in rows]
    pins["mean_throttle"] = [float(v) for v in np.asarray(tel.mean_throttle)]
    assert all(math.isfinite(v) for vs in pins.values() for v in vs)
    print(json.dumps(pins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
