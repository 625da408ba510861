"""Print the resilience twin's pins for ``repro_torch.configs.acceptance``:
what the JAX package gives for the fault cases on the CPU.

- ``PINNED_FAULTS``: ``run_episode(..., "replay", summary_only=True)`` +
  ``summary`` for each hour of ``acceptance.FAULT_CASES`` (the drill
  under its scenario); for its ``_macro`` twin the same values (the
  port's macro path is bitwise its per-tick path), the JAX package's own
  macro event ticks as ``reference_macro_steps_taken`` and the port's
  (its macro run on the CPU) as ``macro_steps_taken``: the JAX package's
  macro path misses the restart of a job its tick's faults killed as a
  start, so it fast-forwards ticks its per-tick path dispatches in;
- ``PINNED_FLEET_FAULTS``: the vmapped ``run_fleet`` of the fault fleet
  (``FLEET_FAULTS_E`` replicas of states made from keys 0..E-1, default
  grid and drill alternating), per replica;
- ``PINNED_RL_FAULTS``: ``SchedEnv`` on ``rl_tx_gaia_faults`` driven by
  ``acceptance.rl_fault_script``, ``macro=False`` and ``macro=True``, in
  ``PINNED_RL``'s form.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fault_pins.py \\
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
from repro.scenarios.scenario import (
    default_scenario,
    resilience_drill,
    stack_scenarios,
)
from repro_torch.configs import acceptance as A

import torch_macro_pins
import torch_rl_pins


def reference_hour(case: str):
    """(cfg, statics, state) of a fault hour in the JAX package."""
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       **A.FAULT_CASES[A.base_case(case)])
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    scn = resilience_drill(cfg, **A.DRILL) if "drill" in case else None
    st = R.build_statics(cfg, bank, scenario=scn)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    return cfg, st, s


def port_macro_steps(case: str) -> float:
    """The event ticks of the port's macro hour on the CPU."""
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core import run_episode, summary

    cfg = A.config(case)
    jobs, bank = A.workload(cfg)
    st = build_statics(cfg, bank, A.fault_scenario(case, cfg), device="cpu")
    s = load_jobs(init_state(cfg, st, A.SEED), jobs)
    fs, tel = run_episode(cfg, st, s, A.N_STEPS, A.SCHEDULER, macro=True)
    return summary(fs, tel)["macro_steps_taken"]


def replay() -> dict:
    pins = {}
    for case in A.FAULT_CASES:
        cfg, st, s = reference_hour(case)
        got = {}
        for macro in (False, True):
            fs, tel = jax.jit(lambda s, cfg=cfg, st=st, m=macro:
                              R.run_episode(cfg, st, s, A.N_STEPS,
                                            A.SCHEDULER, summary_only=True,
                                            macro=m))(s)
            got[macro] = R.summary(fs, tel)
        pins[case] = {k: float(got[False][k]) for k in A.fault_keys(case)}
        pins[f"{case}_macro"] = {
            **pins[case], "macro_steps_taken": port_macro_steps(case),
            "reference_macro_steps_taken": float(
                got[True]["macro_steps_taken"])}
    return pins


def reference_fleet():
    """(cfg, statics, batched state, batched scenario) of the fault fleet
    in the JAX package."""
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       outages_enabled=True, **A.FAULTS)
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    st = R.build_statics(cfg, bank)
    keys = jnp.stack([jax.random.key(e) for e in range(A.FLEET_FAULTS_E)])
    s = jax.vmap(lambda k: R.load_jobs(R.init_state(cfg, st, k), jobs,
                                       validate="off"))(keys)
    scns = stack_scenarios([
        default_scenario(cfg) if e % 2 == 0
        else resilience_drill(cfg, **A.DRILL)
        for e in range(A.FLEET_FAULTS_E)])
    return cfg, st, s, scns


def fleet() -> dict:
    cfg, st, s, scns = reference_fleet()
    fs, tel = run_fleet(cfg, st, s, A.FLEET_FAULTS_TICKS,
                        A.FLEET_FAULTS_SCHEDULER, scenarios=scns,
                        summary_only=True)
    rows = fleet_summary(fs, tel)
    pins = {k: [r[k] for r in rows] for k in A.FLEET_FAULTS_KEYS}
    assert all(math.isfinite(v) for vs in pins.values() for v in vs)
    return pins


def scripted(macro: bool) -> dict:
    """The JAX side of ``acceptance.run_rl_script`` for
    ``rl_tx_gaia_faults``."""
    case = A.RL_FAULTS_CASE
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       **A.RL_CASES[case])
    wls = [synth_workload(cfg, A.RL_JOBS, A.RL_HORIZON_S, seed=s)
           for s in range(A.RL_WORKLOADS)]
    env = SchedEnv(cfg, wls, **A.rl_env_kwargs(macro=macro, case=case))
    script = A.rl_fault_script(env.k, A.RL_ENVS, A.RL_FAULTS_STEPS)
    keys = jax.random.split(jax.random.key(A.RL_SEED), A.RL_ENVS)
    st, obs = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    cands = jax.jit(jax.vmap(lambda s: rsched.rl_candidates(env.cfg, s)))
    rec = {"reward": [], "done": [], "n_valid": [],
           **{f: [] for f in A.RL_INFO}}
    for t in range(A.RL_FAULTS_STEPS):
        rec["n_valid"].append(np.sum(np.asarray(cands(st.sim)) >= 0, -1))
        st, obs, r, d, info = step(st, jnp.asarray(script[t]))
        rec["reward"].append(np.asarray(r))
        rec["done"].append(np.asarray(d))
        for f in A.RL_INFO:
            rec[f].append(np.asarray(info[f]))
    sim = {f: np.asarray(getattr(st.sim, f))
           for f in A.RL_FAULTS_INT_FIELDS + ("n_completed",)}
    assert np.all(np.isin(np.arange(env.k + 6), script)), \
        "the script misses an action"
    return A.rl_record(script, env.k, np.stack(rec["n_valid"]),
                       np.stack(rec["reward"]), np.stack(rec["done"]),
                       {f: np.stack(rec[f]) for f in A.RL_INFO},
                       np.asarray(obs), sim, A.RL_FAULTS_INT_FIELDS)


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
            print(torch_rl_pins.literal(pins, "PINNED_RL_FAULTS"))
        elif part == "fleet":
            print(torch_macro_pins.literal(pins, "PINNED_FLEET_FAULTS"))
        else:
            print(torch_macro_pins.literal(pins, "PINNED_FAULTS"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
