"""End-to-end run of the paper's central experiment (Fig. 2): train a PPO
agent to schedule jobs on the datacenter twin for an energy/carbon/
throughput reward, then compare the learned policy against the classical
schedulers.

  PYTHONPATH=src python -m repro_torch.examples.rl_scheduler [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.rl_scheduler --fast  # smoke
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig, tiny_cluster
from repro_torch.core import (
    build_statics,
    init_state,
    load_jobs,
    run_episode,
    summary,
)
from repro_torch.data import synth_workload
from repro_torch.envs import SchedEnv
from repro_torch.rl import ActorCritic, PPOConfig, ppo_train
from repro_torch.utils import prng
from repro_torch.utils.device import exact_matmul, resolve_device


def make_env(cfg: SimConfig, device, *, n_workloads: int = 4,
             n_jobs: int = 40, horizon_s: float = 1500.0,
             episode_steps: int = 24) -> SchedEnv:
    """The env over ``n_workloads`` synthetic workloads (seeds 0, 1, ...),
    15 ticks a decision, on ``device``."""
    wls = [synth_workload(cfg, n_jobs, horizon_s, seed=s)
           for s in range(n_workloads)]
    return SchedEnv(cfg, wls, episode_steps=episode_steps,
                    sim_steps_per_action=15, device=device)


def train(env: SchedEnv, iterations: int, *, n_envs: int = 8,
          rollout_len: int = 24, log=print):
    """``ppo_train`` for ``iterations``; returns (params, the mean episode
    return of each iteration)."""
    returns = []

    def on_iteration(it, s):
        returns.append(s["mean_episode_return"])
        log(f"  it {it:3d} episodic_return={s['mean_episode_return']:8.2f}")

    params, _ = ppo_train(
        env, cfg=PPOConfig(n_envs=n_envs, rollout_len=rollout_len, lr=3e-4),
        n_iterations=iterations, log=on_iteration)
    return params, returns


def evaluate_policy(env: SchedEnv, params, key, episodes: int = 4):
    """Greedy rollout of the learned policy on one environment per
    episode (key words ``fold_in(key, e)``); returns the mean over the
    episodes of (return, energy kWh, carbon kg, jobs completed)."""
    policy = ActorCritic(env.obs_dim, env.n_actions, device=env.device)
    totals = []
    with torch.no_grad():
        for e in range(episodes):
            st, obs = env.reset(prng.fold_in(key, e))
            ret, energy, carbon, done_jobs = 0.0, 0.0, 0.0, 0.0
            for _ in range(env.episode_steps):
                logits, _ = policy.apply(params, obs)
                st, obs, r, d, info = env.step(st, torch.argmax(logits))
                ret += float(r)
                energy += float(info["energy_kwh"])
                carbon += float(info["carbon_kg"])
                done_jobs += float(info["completed"])
            totals.append((ret, energy, carbon, done_jobs))
    return np.mean(totals, axis=0)


def classical(cfg: SimConfig, workload, n_steps: int, device,
              schedulers=("fcfs", "sjf", "easy")) -> dict:
    """The classical schedulers on ``workload`` for ``n_steps`` ticks:
    the summary of each."""
    jobs, bank = workload
    statics = build_statics(cfg, bank, device=device)
    st = load_jobs(init_state(cfg, statics, 0), jobs)
    return {sched: summary(run_episode(cfg, statics, st, n_steps, sched)[0])
            for sched in schedulers}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    iters = 4 if args.fast else args.iterations
    device = resolve_device(args.device)
    exact_matmul()

    cfg = tiny_cluster(sched_max_candidates=4)
    env = make_env(cfg, device)
    print(f"env: obs={env.obs_dim} actions={env.n_actions} "
          f"({cfg.n_nodes}-node twin)")

    params, hist_rewards = train(env, iters)
    first = np.mean(hist_rewards[:3])
    last = np.mean(hist_rewards[-3:])
    print(f"\nPPO reward: first3={first:.2f} -> last3={last:.2f} "
          f"({'improved' if last > first else 'no improvement yet'})")

    # learned policy vs classical schedulers on the same workload
    ret, energy, carbon, jobs_done = evaluate_policy(
        env, params, prng.key_words(99))
    print(f"\nRL policy   : jobs={jobs_done:5.1f} energy={energy:7.2f} kWh "
          f"carbon={carbon:6.2f} kg")

    horizon = env.episode_steps * env.sim_steps_per_action
    rows = classical(cfg, synth_workload(cfg, 40, 1500.0, seed=0), horizon,
                     device)
    for sched, s in rows.items():
        print(f"{sched:12s}: jobs={s['completed']:5.1f} "
              f"energy={s['energy_kwh']:7.2f} kWh "
              f"carbon={s['carbon_kg']:6.2f} kg")
    return {"returns": hist_rewards, "rl": (ret, energy, carbon, jobs_done),
            "classical": rows}


if __name__ == "__main__":
    main()
