"""Print the serving twin's pins for ``repro_torch.configs.acceptance``:
what the JAX package gives for the serving cases on the CPU.

- ``PINNED_SERVING``: ``run_episode(..., "replay", summary_only=True)`` +
  ``summary`` of ``replay_tx_gaia_1h_serving`` (with the final pool size
  and the latency histogram); its ``_macro`` twin holds the same values
  (the port's macro path is bitwise its per-tick path) and the JAX
  package's own macro event ticks as ``reference_macro_steps_taken``;
- ``PINNED_FLEET_SERVING``: the vmapped ``run_fleet`` of the serving fleet
  (``FLEET_SERVING_E`` replicas, replica i at a peak of 12 (i + 1)
  req/s), per replica;
- ``PINNED_RL_SERVING``: ``SchedEnv`` on ``rl_tx_gaia_serving`` driven by
  ``acceptance.rl_serving_script``, ``macro=False`` and ``macro=True``,
  in ``PINNED_RL``'s form.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_serving_pins.py \\
        [replay] [fleet] [rl]

Not a test module: the three parts take a few minutes on 8 CPU cores.
Each prints a Python literal on standard output.
"""

from __future__ import annotations

import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs.sim as rcfg
import repro.core as R
from repro.core import schedulers as rsched
from repro.core.fleet import fleet_summary, run_fleet
from repro.data import synth_workload
from repro.envs import SchedEnv
from repro.scenarios.scenario import diurnal_serving, stack_scenarios
from repro_torch.configs import acceptance as A

import torch_macro_pins
import torch_rl_pins


def reference_hour():
    """(cfg, statics, state) of the serving hour in the JAX package."""
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16, **A.SERVING)
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    st = R.build_statics(cfg, bank,
                         scenario=diurnal_serving(cfg, **A.SERVING_TRAFFIC))
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    return cfg, st, s._replace(srv_active=jnp.float32(A.SERVING_ACTIVE0))


def hour_summary(fs, tel) -> dict:
    got = R.summary(fs, tel)
    got["srv_active"] = float(fs.srv_active)
    got["srv_lat_hist"] = np.asarray(fs.srv_lat_hist, np.float64).tolist()
    return {k: got[k] for k in A.SERVING_KEYS}


def replay() -> dict:
    cfg, st, s = reference_hour()
    got = {}
    for macro in (False, True):
        fs, tel = jax.jit(lambda s, m=macro: R.run_episode(
            cfg, st, s, A.N_STEPS, A.SCHEDULER, summary_only=True,
            macro=m))(s)
        got[macro] = (hour_summary(fs, tel),
                      float(R.summary(fs, tel)["macro_steps_taken"]))
    pins = got[False][0]
    return {A.SERVING_CASE: pins,
            A.SERVING_MACRO_CASE: {
                **pins, "reference_macro_steps_taken": got[True][1]}}


def fleet() -> dict:
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16, **A.SERVING)
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    s = s._replace(srv_active=jnp.float32(A.SERVING_ACTIVE0))
    scns = stack_scenarios([diurnal_serving(cfg, **A.fleet_serving_traffic(e))
                            for e in range(A.FLEET_SERVING_E)])
    fs, tel = run_fleet(cfg, st, s, A.FLEET_SERVING_TICKS, A.SCHEDULER,
                        scenarios=scns, summary_only=True)
    rows = fleet_summary(fs, tel)
    pins = {k: [r[k] for r in rows] for k in A.FLEET_SERVING_KEYS}
    assert all(math.isfinite(v) for vs in pins.values() for v in vs)
    return pins


def scripted(macro: bool) -> dict:
    """The JAX side of ``acceptance.run_rl_script`` for
    ``rl_tx_gaia_serving``."""
    case = A.RL_SERVING_CASE
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       **A.RL_CASES[case])
    wls = [synth_workload(cfg, A.RL_JOBS, A.RL_HORIZON_S, seed=s)
           for s in range(A.RL_WORKLOADS)]
    env = SchedEnv(cfg, wls, scenario=diurnal_serving(
        cfg, **A.RL_SERVING_TRAFFIC), **A.rl_env_kwargs(macro=macro,
                                                        case=case))
    script = A.rl_serving_script(env.k, A.RL_ENVS, A.RL_SERVING_STEPS)
    keys = jax.random.split(jax.random.key(A.RL_SEED), A.RL_ENVS)
    st, obs = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    cands = jax.jit(jax.vmap(lambda s: rsched.rl_candidates(env.cfg, s)))
    rec = {"reward": [], "done": [], "n_valid": [],
           **{f: [] for f in A.RL_INFO}}
    for t in range(A.RL_SERVING_STEPS):
        rec["n_valid"].append(np.sum(np.asarray(cands(st.sim)) >= 0, -1))
        st, obs, r, d, info = step(st, jnp.asarray(script[t]))
        rec["reward"].append(np.asarray(r))
        rec["done"].append(np.asarray(d))
        for f in A.RL_INFO:
            rec[f].append(np.asarray(info[f]))
    sim = {f: np.asarray(getattr(st.sim, f))
           for f in A.RL_INT_FIELDS + ("n_completed",)}
    assert np.all(np.isin(np.arange(env.k + 5), script)), \
        "the script misses an action"
    return A.rl_record(script, env.k, np.stack(rec["n_valid"]),
                       np.stack(rec["reward"]), np.stack(rec["done"]),
                       {f: np.stack(rec[f]) for f in A.RL_INFO},
                       np.asarray(obs), sim, A.RL_INT_FIELDS)


def rl() -> dict:
    return {"per_tick": scripted(False), "macro": scripted(True)}


def main(argv) -> int:
    parts = argv or ["replay", "fleet", "rl"]
    for part in parts:
        t0 = time.time()
        pins = {"replay": replay, "fleet": fleet, "rl": rl}[part]()
        print(f"# {part}: {time.time() - t0:.1f} s, jax {jax.__version__}",
              file=sys.stderr)
        if part == "rl":
            print(torch_rl_pins.literal(pins, "PINNED_RL_SERVING"))
        elif part == "fleet":
            print(torch_macro_pins.literal(pins, "PINNED_FLEET_SERVING"))
        else:
            print(torch_rl_pins.literal(pins, "PINNED_SERVING"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
