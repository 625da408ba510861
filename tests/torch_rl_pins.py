"""Print ``PINNED_RL`` for ``repro_torch.configs.acceptance``: the JAX
package's ``SchedEnv(macro=False)`` and ``ppo_train`` on the RL cases at
full width (``acceptance.rl_config``: TX-GAIA, 672 nodes, the 256 x 16
job table; four 40-job workloads), on the CPU:

- ``rl_tx_gaia`` and ``rl_tx_gaia_thermal_stress``: 8 environments reset
  from ``split(key(0), 8)`` and driven by ``acceptance.rl_script`` through
  ``jax.vmap(env.step)``, in ``acceptance.rl_record``'s form;
- ``ppo``: iteration 0's rollout of ``ppo_train(seed=0)`` (its actions,
  mean reward and mean value, made as ``ppo_train`` makes them, before
  any update) and the stats of ``RL_ITERATIONS`` iterations.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_rl_pins.py

Not a test module: it takes about half a minute on 8 CPU cores. It
prints the pins as a Python literal on standard output.
"""

from __future__ import annotations

import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs.sim as rcfg
from repro.core import schedulers as rsched
from repro.data import synth_workload
from repro.envs import SchedEnv
from repro.rl import ActorCritic, PPOConfig, ppo_train
from repro.rl.ppo import make_rollout
from repro_torch.configs import acceptance as A


def reference_env(case: str, env_kw: dict | None = None) -> SchedEnv:
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       **A.RL_CASES[case])
    wls = [synth_workload(cfg, A.RL_JOBS, A.RL_HORIZON_S, seed=s)
           for s in range(A.RL_WORKLOADS)]
    return SchedEnv(cfg, wls, **(env_kw or A.rl_env_kwargs()))


def scripted(case: str, env_kw: dict | None = None) -> dict:
    """The JAX side of ``acceptance.run_rl_script`` (``env_kw``: the
    ``SchedEnv`` keywords, default ``acceptance.rl_env_kwargs()``)."""
    env = reference_env(case, env_kw)
    steps = A.RL_SCRIPT_STEPS[case]
    script = A.rl_script(env.k, A.RL_ENVS, steps)
    keys = jax.random.split(jax.random.key(A.RL_SEED), A.RL_ENVS)
    st, obs = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    cands = jax.jit(jax.vmap(lambda s: rsched.rl_candidates(env.cfg, s)))
    rec = {"reward": [], "done": [], "n_valid": [],
           **{f: [] for f in A.RL_INFO}}
    for t in range(steps):
        rec["n_valid"].append(np.sum(np.asarray(cands(st.sim)) >= 0, -1))
        st, obs, r, d, info = step(st, jnp.asarray(script[t]))
        rec["reward"].append(np.asarray(r))
        rec["done"].append(np.asarray(d))
        for f in A.RL_INFO:
            rec[f].append(np.asarray(info[f]))
    sim = {f: np.asarray(getattr(st.sim, f))
           for f in A.RL_INT_FIELDS + ("n_completed",)}
    out = A.rl_record(script, env.k, np.stack(rec["n_valid"]),
                      np.stack(rec["reward"]), np.stack(rec["done"]),
                      {f: np.stack(rec[f]) for f in A.RL_INFO},
                      np.asarray(obs), sim)
    assert out["past_queued"] > 0, "the script never points past the queue"
    assert np.all(np.isin(script, np.arange(env.k + 1)))
    return out


def ppo(env_kw: dict | None = None,
        n_iterations: int = A.RL_ITERATIONS) -> dict:
    env = reference_env("rl_tx_gaia", env_kw)
    cfg = PPOConfig(n_envs=A.RL_ENVS, rollout_len=A.RL_ROLLOUT)
    policy = ActorCritic(env.obs_dim, env.n_actions)
    # iteration 0's rollout, keys split as ppo_train splits them
    key = jax.random.key(A.RL_SEED)
    key, kp, ke = jax.random.split(key, 3)
    params = policy.init(kp)
    states, _ = jax.vmap(env.reset)(jax.random.split(ke, cfg.n_envs))
    _, kroll, _ = jax.random.split(key, 3)
    _, batch, _, _ = jax.jit(make_rollout(env, policy, cfg))(
        params, states, kroll)
    _, history = ppo_train(env, cfg=cfg, n_iterations=n_iterations,
                           seed=A.RL_SEED)
    mean_reward = float(jnp.mean(batch.reward))
    np.testing.assert_allclose(history[0]["mean_reward"], mean_reward,
                               rtol=1e-6)
    return {"actions0": np.asarray(batch.action).tolist(),
            "mean_reward0": mean_reward,
            "mean_value0": float(jnp.mean(batch.value)),
            "history": [{k: h[k] for k in sorted(h)} for h in history]}


def main() -> int:
    t0 = time.time()
    pins = {case: scripted(case) for case in A.RL_SCRIPT_STEPS}
    pins["ppo"] = ppo()
    print(f"# {time.time() - t0:.1f} s, jax {jax.__version__}",
          file=sys.stderr)
    print(literal(pins))
    return 0


def _text(x) -> str:
    """A pin as Python source: floats as the shortest repr of their f32
    value (every pinned float is an f32), nested lists flat-bracketed."""
    if isinstance(x, bool):
        return repr(x)
    if isinstance(x, float):
        return str(np.float32(x))
    if isinstance(x, list):
        return "[" + ", ".join(_text(v) for v in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f'"{k}": {_text(v)}' for k, v in x.items()) \
            + "}"
    return repr(x)


def literal(pins: dict, name: str = "PINNED_RL") -> str:
    """``PINNED_RL = {...}`` (or ``name``) wrapped to 79 columns."""
    lines = [f"{name} = {{"]
    for case, fields in pins.items():
        lines.append(f'    "{case}": {{')
        for f, v in fields.items():
            lines.append(textwrap.fill(
                f'"{f}": {_text(v)},', width=79, initial_indent=" " * 8,
                subsequent_indent=" " * 12, break_on_hyphens=False))
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(main())
