"""Print ``PINNED_RL_DIST`` for ``repro_torch.configs.acceptance``: the JAX
package's ``distributed_ppo_train`` on ``rl_tx_gaia`` at full width
(TX-GAIA, 672 nodes, the 256 x 16 job table, four 40-job workloads,
``SchedEnv(macro=False)``, 8 environments, ``compress=True``) on W = 1
and 2 fake host devices of the CPU:

- each rank's iteration 0 rollout, made as the reference makes it (keys
  ``split(key(0), 3)``, the environments reset from ``split(ke, 8)`` and
  cut into W blocks, ``split(split(key)[1], W)[r]`` for rank r's
  rollout): its sampled actions, mean reward and mean value;
- the stats of ``RL_ITERATIONS`` iterations.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_mesh_pins.py

Not a test module. It prints the pins as a Python literal on standard
output and its run time on standard error.
"""

from __future__ import annotations

import os
import sys
import textwrap
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rl_pins import _text, reference_env  # noqa: E402

from repro.launch.mesh import make_fleet_mesh  # noqa: E402
from repro.rl import ActorCritic, PPOConfig  # noqa: E402
from repro.rl.distributed import distributed_ppo_train  # noqa: E402
from repro.rl.ppo import make_rollout  # noqa: E402
from repro_torch.configs import acceptance as A  # noqa: E402


def dist(world: int) -> dict:
    env = reference_env("rl_tx_gaia")
    cfg = PPOConfig(n_envs=A.RL_ENVS, rollout_len=A.RL_ROLLOUT)
    local = PPOConfig(n_envs=A.RL_ENVS // world, rollout_len=A.RL_ROLLOUT)
    policy = ActorCritic(env.obs_dim, env.n_actions)
    key = jax.random.key(A.RL_SEED)
    key, kp, ke = jax.random.split(key, 3)
    params = policy.init(kp)
    states, _ = jax.vmap(env.reset)(jax.random.split(ke, cfg.n_envs))
    _, kr = jax.random.split(key)
    keys = jax.random.split(kr, world)
    rollout = jax.jit(make_rollout(env, policy, local))
    b = A.RL_ENVS // world
    out = {"actions0": [], "mean_reward0": [], "mean_value0": []}
    for r in range(world):
        block = jax.tree.map(lambda x: x[r * b:(r + 1) * b], states)
        _, batch, _, _ = rollout(params, block, keys[r])
        out["actions0"].append(np.asarray(batch.action).tolist())
        out["mean_reward0"].append(float(jnp.mean(batch.reward)))
        out["mean_value0"].append(float(jnp.mean(batch.value)))
    _, history = distributed_ppo_train(
        env, make_fleet_mesh(world), cfg=cfg, n_iterations=A.RL_ITERATIONS,
        seed=A.RL_SEED, compress=True)
    np.testing.assert_allclose(history[0]["mean_reward"],
                               np.mean(out["mean_reward0"]), rtol=1e-6)
    out["history"] = [{k: h[k] for k in sorted(h)} for h in history]
    return out


def literal(pins: dict, name: str = "PINNED_RL_DIST") -> str:
    """``PINNED_RL_DIST = {W: {...}, ...}`` wrapped to 79 columns."""
    lines = [f"{name} = {{"]
    for world, fields in pins.items():
        lines.append(f"    {world}: {{")
        for f, v in fields.items():
            lines.append(textwrap.fill(
                f'"{f}": {_text(v)},', width=79, initial_indent=" " * 8,
                subsequent_indent=" " * 12, break_on_hyphens=False))
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines)


def main() -> int:
    t0 = time.time()
    pins = {world: dist(world) for world in (1, 2)}
    print(f"# {time.time() - t0:.1f} s, jax {jax.__version__}",
          file=sys.stderr)
    print(literal(pins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
