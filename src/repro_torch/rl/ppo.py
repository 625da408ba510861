"""PPO (clipped surrogate) on the batched environment: rollouts of
``n_envs`` environments (the replicas of one batched state) with
auto-reset, GAE, minibatched clipped-objective epochs, AdamW.

The key schedule is the JAX package's (``rl/ppo.py``): ``split(key, 3)``
per rollout step, per iteration and at the start; ``split(ka, n_envs)``
for the per-env ``categorical`` draws; ``split(kr, n_envs)`` for the
auto-reset; ``split(kperm, n_epochs)`` then ``permutation(ke, B)``.
Gradients come from ``torch.autograd``; the optimizer is the JAX
package's AdamW math, stepped with the iteration index for every
minibatch update of an iteration, as the JAX package does.

Nothing in an iteration reads a tensor on the host. ``ppo_train`` runs
``sync_every`` iterations as a chunk and drains the chunk's stats to the
host once (``_drain``): the one host sync of training. The auto-reset
builds fresh environments only where the host knows, from its own copy
of the step counters (``EnvState.host_steps``), that an environment is
done; with the counters unknown it builds them at every step and keeps
them where ``done``, as the JAX package does. The key stream is the same
either way.

With ``checkpoint_dir`` a checkpoint of the whole training state (the
parameters, the optimizer's moments, the batched environment states with
their host step counters, the episode accumulators and the key words)
is written every ``checkpoint_every`` iterations (``checkpoint.ckpt``:
crash-atomic, one counted read for the save); ``resume=True`` goes on
from the newest one bit for bit, as the JAX package's ``ppo_train`` does.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.envs.sched_env import where_state
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.rl.gae import gae
from repro_torch.rl.policy import ActorCritic, Params
from repro_torch.utils import prng
from repro_torch.utils.device import full, to_device

STAT_KEYS = ("mean_reward", "mean_episode_return", "mean_episode_len",
             "mean_value", "pg_loss", "v_loss", "entropy", "approx_kl")


@dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 16
    rollout_len: int = 64
    n_epochs: int = 4
    n_minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def _zero_ep(like: torch.Tensor) -> Dict[str, torch.Tensor]:
    z = torch.zeros_like(like, dtype=torch.float32)
    zi = torch.zeros_like(like, dtype=torch.int32)
    return {"ret": z, "len": zi, "fin_ret": z, "fin_len": zi}


def make_rollout(env, policy: ActorCritic, cfg: PPOConfig):
    """Returns rollout(params, env_states, key, ep=None) -> (env_states,
    batch, last_val, ep): ``rollout_len`` steps of the ``n_envs``
    environments (a batched ``EnvState``) under ``params``, with key words
    ``key`` (2,). ``ep`` is the per-env episode accumulator {ret, len,
    fin_ret, fin_len}; thread it across calls, as ``ppo_train`` does, so
    episodes spanning rollout windows report their true totals (``None``
    starts from zeros). ``batch`` is a ``Transition`` of (T, N, ...)."""

    def rollout(params: Params, env_states, key, ep=None):
        states = env_states
        with torch.no_grad():
            obs = env.observe(states)
            if ep is None:
                ep = _zero_ep(obs[:, 0])
            ep_ret, ep_len = ep["ret"], ep["len"]
            fin_ret, fin_len = ep["fin_ret"], ep["fin_len"]
            steps = []
            for _ in range(cfg.rollout_len):
                key, ka, kr = prng.split(key, 3)
                logits, values = policy.apply(params, obs)
                actions = prng.categorical(prng.split(ka, cfg.n_envs),
                                           logits)
                logp_all = torch.log_softmax(logits, -1)
                logps = torch.gather(logp_all, -1, actions[:, None])[:, 0]
                states, nobs, rew, done, _ = env.step(states, actions)
                ep_ret = ep_ret + rew
                ep_len = ep_len + 1
                fin_ret = torch.where(done, ep_ret, fin_ret)
                fin_len = torch.where(done, ep_len, fin_len)
                # auto-reset finished envs
                host = states.host_steps
                if host is None or bool((host >= env.episode_steps).any()):
                    fresh, fresh_obs = env.reset(prng.split(kr, cfg.n_envs))
                    states = where_state(done, fresh, states)._replace(
                        host_steps=None if host is None else np.where(
                            host >= env.episode_steps, 0, host))
                    nobs = torch.where(done[:, None], fresh_obs, nobs)
                ep_ret = torch.where(done, 0.0, ep_ret)
                ep_len = torch.where(done, 0, ep_len)
                steps.append(Transition(obs, actions, logps, values, rew,
                                        done))
                obs = nobs
            _, last_val = policy.apply(params, obs)
        batch = Transition(*(torch.stack(x) for x in zip(*steps)))
        ep = {"ret": ep_ret, "len": ep_len,
              "fin_ret": fin_ret, "fin_len": fin_len}
        return states, batch, last_val, ep

    return rollout


def ppo_loss(policy: ActorCritic, params: Params, batch: Transition,
             adv: torch.Tensor, ret: torch.Tensor, cfg: PPOConfig):
    """(total loss, {pg_loss, v_loss, entropy, approx_kl}) of one
    minibatch; the advantages are normalized by their population
    deviation (``jnp.std``'s ddof 0)."""
    logits, value = policy.apply(params, batch.obs)
    logp_all = torch.log_softmax(logits, -1)
    logp = torch.gather(logp_all, -1, batch.action[..., None])[..., 0]
    ratio = torch.exp(logp - batch.logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_clip = batch.value + torch.clamp(value - batch.value, -cfg.clip_eps,
                                       cfg.clip_eps)
    v_loss = 0.5 * torch.mean(
        torch.maximum(torch.square(value - ret), torch.square(v_clip - ret)))
    ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    approx_kl = torch.mean(batch.logp - logp)
    return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
                   "approx_kl": approx_kl}


def loss_and_grads(policy: ActorCritic, params: Params, batch: Transition,
                   adv, ret, cfg: PPOConfig):
    """(loss, metrics, grads): ``ppo_loss`` and its gradients in the
    parameters, by ``torch.autograd``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = ppo_loss(policy, leaves, batch, adv, ret, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def make_update(policy: ActorCritic, cfg: PPOConfig, opt: AdamW):
    """Returns update(params, opt_state, batch, last_val, kperm, step) ->
    (params, opt_state, metrics): GAE over a rollout's ``batch``, then
    ``n_epochs`` epochs of ``n_minibatches`` clipped-objective AdamW steps
    over ``permutation``s from ``split(kperm, n_epochs)``, every step at
    the iteration index ``step``. ``metrics`` maps each loss stat to its
    (n_epochs * n_minibatches,) values."""

    def update(params, opt_state, batch: Transition, last_val, kperm, step):
        adv, ret = gae(batch.reward, batch.value, batch.done, last_val,
                       gamma=cfg.gamma, lam=cfg.lam)
        # flatten (T, N) -> (T*N,)
        flat = Transition(*(x.reshape((-1,) + x.shape[2:]) for x in batch))
        adv_f, ret_f = adv.reshape(-1), ret.reshape(-1)
        B = adv_f.shape[0]
        mb = B // cfg.n_minibatches
        metrics = []
        for ke in prng.split(kperm, cfg.n_epochs):
            perm = prng.permutation(ke, B)
            for i in range(cfg.n_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                mb_batch = Transition(*(x.index_select(0, idx)
                                        for x in flat))
                _, m, grads = loss_and_grads(
                    policy, params, mb_batch, adv_f.index_select(0, idx),
                    ret_f.index_select(0, idx), cfg)
                grads, _ = clip_by_global_norm(grads, cfg.max_grad_norm)
                params, opt_state = opt.update(grads, opt_state, params,
                                               step)
                metrics.append(m)
        return params, opt_state, {k: torch.stack([m[k] for m in metrics])
                                   for k in metrics[0]}

    return update


def make_train_iteration(env, policy: ActorCritic, cfg: PPOConfig):
    """One PPO iteration: rollout -> GAE -> epochs of minibatched
    updates. Returns (iteration, optimizer); iteration(params, opt_state,
    env_states, ep, key, step) -> (params, opt_state, env_states, ep,
    key, stats), ``step`` the iteration index as a 0-d int32 tensor."""
    opt = AdamW(lr=cfg.lr, b2=0.999, weight_decay=0.0)
    rollout = make_rollout(env, policy, cfg)
    update = make_update(policy, cfg, opt)

    def iteration(params, opt_state, env_states, ep, key, step):
        key, kroll, kperm = prng.split(key, 3)
        env_states, batch, last_val, ep = rollout(params, env_states, kroll,
                                                  ep)
        params, opt_state, metrics = update(params, opt_state, batch,
                                            last_val, kperm, step)
        stats = {
            "mean_reward": torch.mean(batch.reward),
            "mean_episode_return": torch.mean(ep["fin_ret"]),
            "mean_episode_len": torch.mean(ep["fin_len"].to(torch.float32)),
            "mean_value": torch.mean(batch.value),
            **{k: torch.mean(v) for k, v in metrics.items()},
        }
        return params, opt_state, env_states, ep, key, stats

    return iteration, opt


def _drain(stats: list) -> np.ndarray:
    """A chunk's stats to the host: the one host sync per chunk.
    (n iterations, len(STAT_KEYS)) float64."""
    rows = torch.stack([torch.stack([s[k] for k in STAT_KEYS])
                        for s in stats])
    return rows.cpu().numpy().astype(np.float64)


def ppo_train(
    env,
    *,
    cfg: PPOConfig = PPOConfig(),
    n_iterations: int = 20,
    seed: int = 0,
    hidden=(128, 128),
    log: Optional[Callable[[int, Dict[str, float]], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    sync_every: Optional[int] = None,
):
    """Train a PPO scheduler on ``env`` (a ``SchedEnv``), on the env's
    device. Returns (params, history): the final parameter dict and one
    stats dict per iteration.

    Iterations run in chunks of ``sync_every`` (default: min(
    ``checkpoint_every`` when checkpointing, else ``n_iterations``, 8));
    each chunk's stats reach the host in one transfer, after which ``log``
    fires once per iteration. With ``checkpoint_dir``, chunks are cut at
    the checkpoint boundaries, and after every ``checkpoint_every``-th
    iteration the FULL training state — params, optimizer, the batched
    environment states, the episode accumulators and the key words — is
    saved with a run fingerprint (``_train_fingerprint``); each save's
    drain is one counted read beside the chunk's stats sync. ``resume=
    True`` continues from the newest checkpoint bit for bit (a
    fingerprint of another run raises ``CheckpointError``; a params-only
    checkpoint resumes warm, with fresh environments and key)."""
    dev = env.device
    policy = ActorCritic(env.obs_dim, env.n_actions, hidden, device=dev)
    iteration, opt = make_train_iteration(env, policy, cfg)

    key = to_device(torch.from_numpy(prng.key_words(seed)), dev)
    key, kp, ke = prng.split(key, 3)
    params = policy.init(kp)
    opt_state = opt.init(params)
    env_states, obs = env.reset(prng.split(ke, cfg.n_envs))
    # episode accumulators persist across iterations (and chunks)
    ep = _zero_ep(obs[:, 0])
    start = 0
    fingerprint = _train_fingerprint(env, cfg, seed, hidden)
    if checkpoint_dir and resume:
        params, opt_state, env_states, ep, key, start = _resume(
            checkpoint_dir, fingerprint, params, opt_state, env_states, ep,
            key)

    if sync_every is None:
        # capped: a chunk's stats wait on the device until its drain
        sync_every = min(checkpoint_every if checkpoint_dir else n_iterations,
                         8)
    sync_every = max(1, sync_every)
    history = []
    it = start
    while it < n_iterations:
        n = min(sync_every, n_iterations - it)
        if checkpoint_dir:
            # cut the chunk at the next checkpoint boundary
            n = min(n, ((it // checkpoint_every) + 1) * checkpoint_every
                    - it)
        chunk = []
        for i in range(n):
            params, opt_state, env_states, ep, key, stats = iteration(
                params, opt_state, env_states, ep, key,
                full(it + i, torch.int32, dev))
            chunk.append(stats)
        host = _drain(chunk)                      # ONE sync per chunk
        for i in range(n):
            s = {k: float(v) for k, v in zip(STAT_KEYS, host[i])}
            history.append(s)
            if log:
                log(it + i, s)
        it += n
        if checkpoint_dir and it % checkpoint_every == 0:
            from repro_torch.checkpoint import save

            save(checkpoint_dir, it - 1,
                 {"params": params, "opt": opt_state,
                  "env_states": env_states, "ep": ep, "key": key},
                 extra_meta={"iteration": it - 1,
                             "fingerprint": fingerprint})
    return params, history


def _resume(directory, fingerprint, params, opt_state, env_states, ep, key):
    """The training state from the newest checkpoint in ``directory`` (or
    the fresh one given, if there is none) and the iteration to start
    from."""
    from repro_torch.checkpoint import latest_step, read_meta, restore
    from repro_torch.checkpoint.episode import check_fingerprint

    step = latest_step(directory)
    if step is None:
        return params, opt_state, env_states, ep, key, 0
    meta = read_meta(directory, step)
    saved = meta.get("extra", {}).get("fingerprint")
    if saved is not None:
        check_fingerprint(saved, fingerprint, directory)
    if any(k.startswith("env_states") for k in meta.get("leaves", {})):
        p = restore(directory, step,
                    {"params": params, "opt": opt_state,
                     "env_states": env_states, "ep": ep, "key": key})
        return (p["params"], p["opt"], p["env_states"], p["ep"], p["key"],
                step + 1)
    # a params-only checkpoint: a warm resume (fresh envs and key: learning
    # goes on, but not bit for bit)
    p = restore(directory, step, {"params": params, "opt": opt_state})
    return p["params"], p["opt"], env_states, ep, key, step + 1


def _train_fingerprint(env, cfg: PPOConfig, seed, hidden) -> Dict[str, Any]:
    """The run fingerprint in PPO checkpoint manifests. ``n_iterations``
    is left out: training on from a finished run's newest checkpoint is a
    legitimate resume; another env, config or seed is not."""
    def dig(s: str) -> str:
        return hashlib.sha256(s.encode()).hexdigest()[:16]

    return {
        "kind": "ppo",
        "ppo_cfg": dig(repr(cfg)),
        "seed": int(seed),
        "hidden": list(hidden),
        "env": dig(f"{type(env).__name__}/{env.obs_dim}/{env.n_actions}/"
                   f"{repr(getattr(env, 'cfg', None))}"),
    }
