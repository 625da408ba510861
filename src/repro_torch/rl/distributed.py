"""Distributed PPO on a fleet mesh: data parallelism over the mesh's ranks
with the int8 error-feedback all-reduce (``optim.compress``), as the JAX
package's ``rl/distributed.py`` does it under ``shard_map``.

Every rank holds the parameters, the optimizer state and the key words
whole (they stay equal on every rank), rolls out its own contiguous block
of the ``n_envs`` environments (``sharding.specs.fleet_block``; the
environments are the replicas of one batched ``SchedEnv`` state on the
rank's device), and computes one full-batch PPO gradient of its block a
iteration; only gradients and stats cross between ranks.

The reference's schedule, copied exactly:

- keys: ``key, kp, ke = split(key(seed), 3)``; the environments are reset
  from ``split(ke, n_envs)`` over the whole batch and cut into blocks;
  each iteration ``key, kr = split(key)`` and rank r rolls out with
  ``split(kr, W)[r]``;
- the rollout's episode accumulators start from zero every iteration
  (the reference does not thread them across gradient steps, unlike
  ``ppo_train``);
- the update: one ``ppo_loss`` gradient of the rank's whole rollout (no
  epochs, minibatches or permutation), ``compressed_psum`` (or a mean
  all-reduce with ``compress=False``), ``clip_by_global_norm``, then
  ``AdamW(lr, b2=0.999, weight_decay=0.0)`` at the iteration index;
- the stats: ``ppo_train``'s and the total ``loss``, each the mean over
  the ranks.

Iterations run in chunks of ``sync_every``; each chunk's stats reach the
host in one transfer (``rl.ppo._drain``). Checkpoints hold the whole
training state (the parameters, the optimizer, the whole batch of
environments, the error-feedback state with a leading axis of one entry
per rank, and the key words) in the reference's layout, written through
``checkpoint.ckpt.save_sharded``; ``resume=True`` goes on bit for bit on
a world of the same size, and on another size raises ``CheckpointError``
(the error-feedback state is per rank and cannot be rescaled).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.optim.compress import compressed_psum
from repro_torch.rl import ppo as _ppo
from repro_torch.rl.gae import gae
from repro_torch.rl.policy import ActorCritic
from repro_torch.rl.ppo import (
    PPOConfig,
    Transition,
    _train_fingerprint,
    loss_and_grads,
    make_rollout,
)
from repro_torch.sharding.specs import fleet_block
from repro_torch.utils import prng
from repro_torch.utils.device import full, to_device
from repro_torch.utils.errors import CheckpointError, ConfigError

DIST_STAT_KEYS = ("loss",) + _ppo.STAT_KEYS


def _axis(mesh, axis: Optional[str]) -> str:
    axis = mesh.axis_names[0] if axis is None else axis
    if axis not in mesh.shape:
        raise ConfigError(f"mesh has axes {tuple(mesh.shape)}, no "
                          f"{axis!r} — build a fleet mesh with "
                          "launch.mesh.make_fleet_mesh()")
    return axis


def make_distributed_grad_step(env, policy: ActorCritic, cfg: PPOConfig,
                               mesh, *, axis: Optional[str] = None,
                               compress: bool = True,
                               on_rollout: Optional[Callable] = None):
    """Returns grad_step(params, env_states, key, error) -> (grads,
    env_states, new_error, stats), called on every rank with its block of
    environments, its key words (2,) and its error-feedback dict (left
    as it is with ``compress=False``): rollout, GAE and the gradient of
    the rank's block, then the all-reduce. ``stats``: a (len(DIST_STAT_KEYS),) tensor
    of the means over the ranks. ``on_rollout(batch)``, where given, sees
    each rollout's ``Transition`` of the rank's block (on the device,
    read nothing)."""
    axis = _axis(mesh, axis)
    n_shards = mesh.shape[axis]
    if cfg.n_envs % n_shards:
        raise ConfigError(
            f"{cfg.n_envs} envs do not divide across {n_shards} {axis!r}"
            "-axis devices — pick n_envs as a multiple of the mesh size")
    local_cfg = PPOConfig(**{**cfg.__dict__,
                             "n_envs": cfg.n_envs // n_shards})
    rollout = make_rollout(env, policy, local_cfg)
    inv_n = float(np.float32(1.0) / np.float32(n_shards))

    def grad_step(params, env_states, key, error):
        env_states, batch, last_val, ep = rollout(params, env_states, key)
        if on_rollout is not None:
            on_rollout(batch)
        adv, ret = gae(batch.reward, batch.value, batch.done, last_val,
                       gamma=cfg.gamma, lam=cfg.lam)
        flat = Transition(*(x.reshape((-1,) + x.shape[2:]) for x in batch))
        loss, metrics, grads = loss_and_grads(
            policy, params, flat, adv.reshape(-1), ret.reshape(-1), cfg)
        if compress:
            grads, error = compressed_psum(grads, mesh, error)
        else:
            grads = {k: mesh.all_reduce(g) * inv_n for k, g in grads.items()}
        # window-local episode stats (ep is not threaded across steps)
        local = {
            "loss": loss,
            "mean_reward": torch.mean(batch.reward),
            "mean_episode_return": torch.mean(ep["fin_ret"]),
            "mean_episode_len": torch.mean(ep["fin_len"].to(torch.float32)),
            "mean_value": torch.mean(batch.value),
            **metrics,
        }
        stats = mesh.all_reduce(
            torch.stack([local[k] for k in DIST_STAT_KEYS])) * inv_n
        return grads, env_states, error, stats

    return grad_step


def distributed_ppo_train(
    env, mesh, *, cfg: PPOConfig = PPOConfig(), n_iterations: int = 10,
    seed: int = 0, compress: bool = True, axis: Optional[str] = None,
    log: Optional[Callable[[int, Dict[str, float]], None]] = None,
    sync_every: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    on_rollout: Optional[Callable[[int, Transition], None]] = None,
) -> Tuple[Any, list]:
    """PPO over ``mesh``'s ranks (call it on every rank, each with the same
    arguments and a ``SchedEnv`` on the rank's device). Returns (params,
    history), the same on every rank: ``history`` has ``ppo_train``'s
    per-iteration keys plus ``loss``. ``axis`` defaults to the mesh's
    axis. See the module docstring for the schedule and the checkpoints
    (every ``checkpoint_every`` iterations, chunks cut there).
    ``on_rollout(iteration, batch)``, where given, sees each iteration's
    rollout of the rank's block, on the device, before its update."""
    axis = _axis(mesh, axis)
    n_shards = mesh.shape[axis]
    dev = env.device
    policy = ActorCritic(env.obs_dim, env.n_actions, device=dev)
    opt = AdamW(lr=cfg.lr, b2=0.999, weight_decay=0.0)
    # the hook reads the loop's iteration (it + i below) when it is called
    grad_step = make_distributed_grad_step(
        env, policy, cfg, mesh, axis=axis, compress=compress,
        on_rollout=None if on_rollout is None
        else (lambda batch: on_rollout(it + i, batch)))  # noqa: B023
    key = to_device(torch.from_numpy(prng.key_words(seed)), dev)
    key, kp, ke = prng.split(key, 3)
    params = policy.init(kp)
    opt_state = opt.init(params)
    all_states, _ = env.reset(prng.split(ke, cfg.n_envs))
    env_states = fleet_block(all_states, mesh)
    # this rank's error-feedback state (zeros throughout with
    # compress=False, as in the reference, whose checkpoints carry it)
    error = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in params.items()}

    start = 0
    fingerprint = dict(_train_fingerprint(env, cfg, seed, ()),
                       kind="ppo-dist", compress=bool(compress))
    if checkpoint_dir and resume:
        params, opt_state, env_states, error, key, start = _resume(
            checkpoint_dir, fingerprint, mesh, params, opt_state,
            all_states, error, key)

    if sync_every is None:
        sync_every = min(checkpoint_every if checkpoint_dir else n_iterations,
                         8)
    sync_every = max(1, sync_every)
    history = []
    it = start
    while it < n_iterations:
        n = min(sync_every, n_iterations - it)
        if checkpoint_dir:
            # cut at checkpoint boundaries so saves land at the same
            # iterations the unfused loop produced
            n = min(n, ((it // checkpoint_every) + 1) * checkpoint_every - it)
        chunk = []
        for i in range(n):
            key, kr = prng.split(key, 2)
            rank_key = prng.split(kr, n_shards)[mesh.rank]
            grads, env_states, error, stats = grad_step(
                params, env_states, rank_key, error)
            grads, _ = clip_by_global_norm(grads, cfg.max_grad_norm)
            params, opt_state = opt.update(
                grads, opt_state, params, full(it + i, torch.int32, dev))
            chunk.append(dict(zip(DIST_STAT_KEYS, stats)))
        host = _ppo._drain(chunk, DIST_STAT_KEYS)   # ONE sync per chunk
        for i in range(n):
            s = {k: float(v) for k, v in zip(DIST_STAT_KEYS, host[i])}
            history.append(s)
            if log:
                log(it + i, s)
        it += n
        if checkpoint_dir and it % checkpoint_every == 0:
            from repro_torch.checkpoint.ckpt import save_sharded

            blocks = {"env_states": env_states,
                      "error": {k: e[None] for k, e in error.items()}}
            save_sharded(checkpoint_dir, it - 1, blocks, mesh,
                         whole={"params": params, "opt": opt_state,
                                "key": key},
                         extra_meta={"iteration": it - 1,
                                     "fingerprint": fingerprint})
    return params, history


def _resume(directory, fingerprint, mesh, params, opt_state, all_states,
            error, key):
    """The training state from the newest checkpoint in ``directory`` (or
    the fresh one, if there is none), this rank's block of it, and the
    iteration to start from."""
    from repro_torch.checkpoint import latest_step, read_meta, restore
    from repro_torch.checkpoint.episode import check_fingerprint

    step = latest_step(directory)
    if step is None:
        return (params, opt_state, fleet_block(all_states, mesh), error, key,
                0)
    meta = read_meta(directory, step)
    saved = meta.get("extra", {}).get("fingerprint")
    if saved is not None:
        check_fingerprint(saved, fingerprint, directory)
    leaves = meta.get("leaves", {})
    ranks = {v["shape"][0] for k, v in leaves.items()
             if k.startswith("error__")}
    if ranks and ranks != {mesh.world}:
        raise CheckpointError(
            f"distributed PPO checkpoint {directory} (step {step}) holds "
            f"the error-feedback state of {sorted(ranks)} rank(s); this "
            f"world has {mesh.world}: the state is per rank and is not "
            "rescaled — resume on a world of the size that wrote it",
            field="error")
    # a checkpoint without the host's step counters (the JAX package's)
    # resumes with them unknown: the auto-reset then builds fresh
    # environments every step and keeps them where done (same key stream)
    if "env_states__host_steps" not in leaves:
        all_states = all_states._replace(host_steps=None)
    like = {"params": params, "opt": opt_state, "env_states": all_states,
            "key": key,
            "error": {k: torch.zeros((mesh.world,) + tuple(e.shape),
                                     dtype=e.dtype, device=e.device)
                      for k, e in error.items()}}
    p = restore(directory, step, like)
    return (p["params"], p["opt"], fleet_block(p["env_states"], mesh),
            {k: e[mesh.rank] for k, e in p["error"].items()}, p["key"],
            step + 1)


__all__ = ["DIST_STAT_KEYS", "make_distributed_grad_step",
           "distributed_ppo_train"]
