"""RL scheduler training (the paper's Fig. 2 pipeline) on the port:
build the TX-GAIA (or tiny) twin, wrap it in the batched ``SchedEnv``,
train PPO, write the reward history and a power trace under the learned
policy. The same flags as the JAX package's ``repro.launch.rl_train``,
plus ``--device`` (default: the CUDA card). The environment is built as
the JAX package builds it, macro-stepping its idle ticks (``SchedEnv``'s
default ``macro=True``). On the card that default is, for now, slower
than ``macro=False``: the environments step in lockstep, so a decision
issues ~20 ticks instead of 15, and a fast tick launches about as many
kernels as an idle tick. On an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py``, phases ``rl`` and ``macro``) an env step of 8
environments ran 7,532 CUDA kernels against 6,225, and 512 environments
took 4,524-4,949 decisions/s against 5,171-6,643 (``PERF.md`` §6).

  PYTHONPATH=src python -m repro_torch.launch.rl_train --cluster tx-gaia \\
      --iterations 3 [--device cpu] [--out experiments/rl] \\
      [--ckpt experiments/rl/ckpt [--resume]]

``--ckpt DIR`` checkpoints the whole training state every 10 iterations
(``ppo_train``'s ``checkpoint_every``); with ``--resume`` training goes on
from the newest checkpoint there, bit for bit. Distributed training has
no flag here, as in the JAX package's launcher: call
``rl.distributed.distributed_ppo_train(env, launch.mesh.make_fleet_mesh())``
on every rank (``launch.mesh.spawn_world`` starts the ranks).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.configs.sim import tiny_cluster, tx_gaia
from repro_torch.data import synth_workload
from repro_torch.envs import SchedEnv
from repro_torch.rl import ActorCritic, PPOConfig, ppo_train
from repro_torch.utils.prng import key_words


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", default="tiny", choices=["tiny", "tx-gaia"])
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--episode-steps", type=int, default=32)
    ap.add_argument("--n-jobs", type=int, default=40)
    ap.add_argument("--horizon", type=float, default=1800.0)
    ap.add_argument("--n-workloads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)

    if args.cluster == "tiny":
        cfg = tiny_cluster(sched_max_candidates=4)
    else:
        cfg = tx_gaia(max_jobs=256, max_nodes_per_job=16)

    wls = [
        synth_workload(cfg, args.n_jobs, args.horizon, seed=args.seed + s)
        for s in range(args.n_workloads)
    ]
    env = SchedEnv(cfg, wls, episode_steps=args.episode_steps,
                   sim_steps_per_action=15, device=args.device)
    print(f"cluster={cfg.name} nodes={cfg.n_nodes} obs={env.obs_dim} "
          f"actions={env.n_actions} device={env.device}")

    ppo_cfg = PPOConfig(n_envs=args.n_envs, rollout_len=args.rollout,
                        lr=args.lr)
    history = []

    def log(it, stats):
        history.append({"iteration": it, **stats})
        print(f"it {it:3d} ep_return={stats['mean_episode_return']:8.2f} "
              f"reward={stats['mean_reward']:7.3f} "
              f"kl={stats['approx_kl']:.4f}")

    params, _ = ppo_train(
        env, cfg=ppo_cfg, n_iterations=args.iterations, seed=args.seed,
        log=log, checkpoint_dir=args.ckpt or None, resume=args.resume,
    )

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ppo_history.json"), "w") as f:
            json.dump(history, f, indent=1)
        # paper Fig 2 (bottom-right): power trace under the greedy policy
        policy = ActorCritic(env.obs_dim, env.n_actions, device=env.device)
        st, obs = env.reset(key_words(123))
        power = []
        with torch.no_grad():
            for _ in range(args.episode_steps):
                logits, _ = policy.apply(params, obs)
                st, obs, _, _, info = env.step(st, torch.argmax(logits))
                power.append(info["facility_w"])
        np.save(os.path.join(args.out, "power_trace_rl.npy"),
                torch.stack(power).cpu().numpy())
        print(f"wrote {args.out}/ppo_history.json and power_trace_rl.npy")
    return params, history


if __name__ == "__main__":
    main()
