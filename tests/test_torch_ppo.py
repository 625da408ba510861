"""The port's PPO pieces against the JAX package's, on ``tiny_cluster(
sched_max_candidates=4)`` (three 24-job workloads in 900 s, episodes of 8
decisions of 5 ticks, ``SchedEnv(macro=False)``):

- ``gae`` with episode boundaries (rtol 1e-6);
- ``ActorCritic.apply`` on the JAX package's parameters carried across by
  ``interop.actor_critic_params_from_numpy`` (rtol 1e-5), and ``init``
  from the same seed (``prng.normal``: within ``INIT_ULPS``);
- ``ppo_loss`` and its gradients against ``jax.value_and_grad`` on one
  fixed minibatch (rtol 1e-5, atol 1e-6);
- ``clip_by_global_norm`` and one AdamW update at an iteration index
  (rtol 1e-6);
- one ``ppo_train`` iteration: iteration 0's sampled actions equal, its
  rollout stats within 1e-5, the loss stats (after Adam updates) within
  1e-3;
- three iterations finite and bitwise repeatable, the host-known
  auto-reset equal to the always-built one, the checkpoint refusal, and
  ``launch/rl_train.py`` on the CPU with its refusals (no ``--mesh``);
- a run checkpointed every 2 iterations, stopped after 4 and resumed to
  6, against the JAX package's uninterrupted 6: params within rtol 1e-5
  (atol 1e-6), the resumed iterations' stats as iteration 0's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy

import repro.configs.sim as rcfg
from repro.data import synth_workload
from repro.envs import SchedEnv as RefEnv
from repro.optim import AdamW as RefAdamW
from repro.optim.base import clip_by_global_norm as ref_clip
from repro.rl import ActorCritic as RefAC
from repro.rl import ppo as RP
from repro.rl.gae import gae as ref_gae
import repro_torch.configs.sim as pcfg
from repro_torch import interop
from repro_torch.envs import SchedEnv
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.rl import ActorCritic
from repro_torch.rl import ppo as PP
from repro_torch.rl.gae import gae
from repro_torch.utils import prng

OBS, ACTIONS = 53, 5
# prng.normal is within 3 ulps of jax.random.normal; the scale multiply
# adds at most one more rounding step
INIT_ULPS = 4
STATS_RTOL = 1e-3
ROLLOUT_STATS = ("mean_reward", "mean_episode_return", "mean_episode_len",
                 "mean_value")
PPO = dict(n_envs=4, rollout_len=8, n_epochs=2, n_minibatches=2)


@pytest.fixture(scope="module")
def envs():
    rc = rcfg.tiny_cluster(sched_max_candidates=4)
    pc = pcfg.tiny_cluster(sched_max_candidates=4)
    wls = [synth_workload(rc, 24, 900.0, seed=s) for s in range(3)]
    kw = dict(episode_steps=8, sim_steps_per_action=5, macro=False)
    return RefEnv(rc, wls, **kw), SchedEnv(pc, wls, device="cpu", **kw)


def _ref_params(seed=0):
    return jax.device_get(RefAC(OBS, ACTIONS).init(jax.random.key(seed)))


def test_gae_matches_reference_with_episode_boundaries():
    rng = np.random.default_rng(0)
    T, N = 16, 5
    r = rng.normal(size=(T, N)).astype(np.float32)
    v = rng.normal(size=(T, N)).astype(np.float32)
    d = rng.random((T, N)) < 0.2
    d[7] = True
    last = rng.normal(size=N).astype(np.float32)
    want = ref_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                   jnp.asarray(last), gamma=0.9, lam=0.8)
    got = gae(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(d),
              torch.from_numpy(last), gamma=0.9, lam=0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_apply_on_carried_params_matches_reference():
    ref = RefAC(OBS, ACTIONS)
    params = _ref_params(3)
    obs = np.random.default_rng(1).normal(size=(7, OBS)).astype(np.float32)
    want = ref.apply(params, jnp.asarray(obs))
    port = ActorCritic(OBS, ACTIONS, device="cpu")
    carried = interop.actor_critic_params_from_numpy(params, device="cpu")
    assert set(carried) == {n for n, _ in port.named_parameters()}
    for got in (port.apply(carried, torch.from_numpy(obs)),
                (port.load(carried), port(torch.from_numpy(obs)))[1]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_matches_reference_from_the_same_seed(seed):
    want = _ref_params(seed)
    got = ActorCritic(OBS, ACTIONS, device="cpu").init(prng.key_words(seed))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == np.float32, k
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - np.asarray(w).view(np.int32))
        assert ulps.max() <= INIT_ULPS, k


def _minibatch(params, n=24):
    """A fixed minibatch: old log-probs and values moved off the current
    ones, so both clips bind somewhere."""
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(n, OBS)).astype(np.float32)
    logits, value = RefAC(OBS, ACTIONS).apply(params, jnp.asarray(obs))
    action = rng.integers(0, ACTIONS, n).astype(np.int32)
    logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(n), action]
    arrays = dict(
        obs=obs, action=action,
        logp=(logp + rng.normal(scale=0.3, size=n)).astype(np.float32),
        value=(np.asarray(value) + rng.normal(scale=0.4, size=n)
               ).astype(np.float32),
        reward=rng.normal(size=n).astype(np.float32),
        done=np.zeros(n, bool))
    adv = rng.normal(size=n).astype(np.float32)
    ret = rng.normal(size=n).astype(np.float32)
    return arrays, adv, ret


def test_ppo_loss_and_grads_match_value_and_grad():
    params = _ref_params(1)
    arrays, adv, ret = _minibatch(params)
    cfg = RP.PPOConfig()
    ref_batch = RP.Transition(**{k: jnp.asarray(v) for k, v in arrays.items()})
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: RP.ppo_loss(RefAC(OBS, ACTIONS), p, ref_batch,
                              jnp.asarray(adv), jnp.asarray(ret), cfg),
        has_aux=True)(params)
    port = ActorCritic(OBS, ACTIONS, device="cpu")
    batch = PP.Transition(**{k: torch.from_numpy(v).long()
                             if k == "action" else torch.from_numpy(v)
                             for k, v in arrays.items()})
    gl, gm, gg = PP.loss_and_grads(
        port, interop.actor_critic_params_from_numpy(params, device="cpu"),
        batch, torch.from_numpy(adv), torch.from_numpy(ret), PP.PPOConfig())
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(gl), float(loss), **tol)
    for k in metrics:
        np.testing.assert_allclose(float(gm[k]), float(metrics[k]), **tol,
                                   err_msg=k)
    assert set(gg) == set(grads)
    for k in grads:
        np.testing.assert_allclose(gg[k].numpy(), np.asarray(grads[k]),
                                   **tol, err_msg=k)


def test_clip_and_adamw_match_reference_at_the_iteration_index():
    """Equal gradients, clipped by the global norm (binding), then one
    AdamW update at iteration index 3 (bias correction at t = 4: the
    step the caller passes, not a count of updates)."""
    params = _ref_params(4)
    rng = np.random.default_rng(3)
    grads = [{k: rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in params.items()}]
    ref_opt = RefAdamW(lr=3e-4, b2=0.999, weight_decay=0.0)
    opt = AdamW(lr=3e-4, b2=0.999, weight_decay=0.0)
    rp = jax.tree.map(jnp.asarray, params)
    pp = interop.actor_critic_params_from_numpy(params, device="cpu")
    rs, ps = ref_opt.init(rp), opt.init(pp)
    step = 3
    for g in grads:
        rg, rnorm = ref_clip(jax.tree.map(jnp.asarray, g), 0.5)
        pg, pnorm = clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 0.5)
        np.testing.assert_allclose(float(pnorm), float(rnorm), rtol=1e-6)
        assert float(pnorm) > 0.5
        for k in g:
            np.testing.assert_allclose(pg[k].numpy(), np.asarray(rg[k]),
                                       rtol=1e-6, atol=1e-12)
        rp, rs = ref_opt.update(rg, rs, rp, jnp.int32(step))
        pp, ps = opt.update(pg, ps, pp, torch.tensor(step, dtype=torch.int32))
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        for mom in ("m", "v"):
            np.testing.assert_allclose(ps[mom][k].numpy(),
                                       np.asarray(rs[mom][k]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{mom}.{k}")
    # decay only on params with two or more dimensions
    decayed, _ = AdamW(lr=1.0, weight_decay=0.5).update(
        {k: torch.zeros_like(v) for k, v in pp.items()},
        AdamW().init(pp), pp, torch.tensor(0, dtype=torch.int32))
    assert torch.equal(decayed["b0"], pp["b0"])
    assert torch.allclose(decayed["w0"], 0.5 * pp["w0"])


def test_one_iteration_matches_reference(envs):
    ref_env, env = envs
    rcfg_ = RP.PPOConfig(**PPO)
    cfg = PP.PPOConfig(**PPO)
    # iteration 0's rollout, keys split as ppo_train splits them
    key, kp, ke = jax.random.split(jax.random.key(0), 3)
    ref_pol = RefAC(ref_env.obs_dim, ref_env.n_actions)
    rstates, _ = jax.vmap(ref_env.reset)(jax.random.split(ke, 4))
    _, kroll, _ = jax.random.split(key, 3)
    _, rbatch, _, _ = jax.jit(RP.make_rollout(ref_env, ref_pol, rcfg_))(
        ref_pol.init(kp), rstates, kroll)
    pk, pkp, pke = prng.split(torch.from_numpy(prng.key_words(0)), 3)
    pol = ActorCritic(env.obs_dim, env.n_actions, device="cpu")
    states, _ = env.reset(prng.split(pke, 4))
    _, pkroll, _ = prng.split(pk, 3)
    _, batch, _, _ = PP.make_rollout(env, pol, cfg)(pol.init(pkp), states,
                                                    pkroll)
    np.testing.assert_array_equal(batch.action.numpy(),
                                  np.asarray(rbatch.action))
    for f in ("reward", "value", "logp"):
        np.testing.assert_allclose(getattr(batch, f).numpy(),
                                   np.asarray(getattr(rbatch, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    _, rh = RP.ppo_train(ref_env, cfg=rcfg_, n_iterations=1, seed=0)
    _, ph = PP.ppo_train(env, cfg=cfg, n_iterations=1, seed=0)
    for k, v in rh[0].items():
        tol = 1e-5 if k in ROLLOUT_STATS else STATS_RTOL
        np.testing.assert_allclose(ph[0][k], v, rtol=tol, err_msg=k)


def test_three_iterations_are_finite_and_bitwise_repeatable(envs):
    _, env = envs
    cfg = PP.PPOConfig(**PPO)
    logged = []
    runs = [PP.ppo_train(env, cfg=cfg, n_iterations=3, seed=5, sync_every=2,
                         log=lambda i, s: logged.append(i))
            for _ in range(2)]
    (p1, h1), (p2, h2) = runs
    assert h1 == h2 and len(h1) == 3
    assert logged == [0, 1, 2] * 2
    assert all(np.isfinite(v) for h in h1 for v in h.values())
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_host_known_auto_reset_equals_the_always_built_one(envs):
    """The rollout skips the fresh environments only where the host knows
    no env is done; with the counters unknown it builds them every step.
    Both give the same rollout (past an auto-reset)."""
    _, env = envs
    cfg = PP.PPOConfig(n_envs=4, rollout_len=11)
    pol = ActorCritic(env.obs_dim, env.n_actions, device="cpu")
    params = pol.init(prng.key_words(9))
    key = torch.from_numpy(prng.key_words(2))
    known, _ = env.reset(prng.split(key, 4))
    unknown = known._replace(host_steps=None)
    rollout = PP.make_rollout(env, pol, cfg)
    a = rollout(params, known, key)
    b = rollout(params, unknown, key)
    assert bool(a[1].done.any())
    assert a[0].host_steps is not None and b[0].host_steps is None
    np.testing.assert_array_equal(a[0].host_steps,
                                  to_numpy(a[0].step_count))
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    for x, y in zip(a[0].sim, b[0].sim):
        assert torch.equal(x, y)
    assert torch.equal(a[2], b[2])


def test_checkpointing_is_refused(envs, tmp_path):
    """Checkpointing came with the durable slice: a resume that finds a
    checkpoint of another run (another seed, another config) is refused
    with ``CheckpointError`` naming what differs; ``resume=True`` without
    a directory starts afresh."""
    from repro_torch.utils.errors import CheckpointError

    _, env = envs
    cfg = PP.PPOConfig(n_envs=2, rollout_len=4, n_epochs=1, n_minibatches=1)
    d = str(tmp_path)
    PP.ppo_train(env, cfg=cfg, n_iterations=1, checkpoint_dir=d,
                 checkpoint_every=1)
    with pytest.raises(CheckpointError, match="seed"):
        PP.ppo_train(env, cfg=cfg, n_iterations=2, seed=1,
                     checkpoint_dir=d, checkpoint_every=1, resume=True)
    with pytest.raises(CheckpointError, match="ppo_cfg"):
        PP.ppo_train(env, cfg=PP.PPOConfig(n_envs=2, rollout_len=4,
                                           n_epochs=2, n_minibatches=1),
                     n_iterations=2, checkpoint_dir=d, checkpoint_every=1,
                     resume=True)
    _, history = PP.ppo_train(env, cfg=cfg, n_iterations=1, resume=True)
    assert len(history) == 1


def test_resumed_training_matches_the_reference(envs, tmp_path):
    """``ppo_train`` stopped after iteration 4 (a checkpoint every 2) and
    resumed to 6 against the JAX package's uninterrupted 6 iterations from
    the same seed: params to rtol 1e-5 (atol 1e-6, as the loss gradients
    are held), the two resumed iterations' stats as iteration 0's."""
    ref_env, env = envs
    cfg = PP.PPOConfig(**PPO)
    d = str(tmp_path)
    PP.ppo_train(env, cfg=cfg, n_iterations=4, seed=0, checkpoint_dir=d,
                 checkpoint_every=2)
    pp, ph = PP.ppo_train(env, cfg=cfg, n_iterations=6, seed=0,
                          checkpoint_dir=d, checkpoint_every=2, resume=True)
    rp, rh = RP.ppo_train(ref_env, cfg=RP.PPOConfig(**PPO), n_iterations=6,
                          seed=0)
    rp = jax.device_get(rp)
    assert sorted(pp) == sorted(rp)
    for k, v in rp.items():
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert len(ph) == len(rh[4:]) == 2
    for i, (got, want) in enumerate(zip(ph, rh[4:])):
        for k, v in want.items():
            tol = 1e-5 if k in ROLLOUT_STATS else STATS_RTOL
            np.testing.assert_allclose(got[k], v, rtol=tol,
                                       err_msg=f"iteration {4 + i}: {k}")


def test_rl_train_runs_on_the_cpu_and_refuses_later_slices(tmp_path):
    """The launcher trains on the tiny cluster with ``--device cpu``,
    building the env as the JAX package does (``macro=True``, the
    default: its idle ticks are fast-forwarded), and writes its history
    and the greedy policy's power trace; ``--ckpt`` checkpoints and
    ``--resume`` goes on from it, and argparse rejects ``--mesh``: as in
    the JAX package's launcher there is no such flag (distributed PPO is
    ``rl.distributed.distributed_ppo_train``)."""
    from repro_torch.core import sim as PSIM
    from repro_torch.launch import rl_train

    base = ["--device", "cpu", "--iterations", "1", "--n-envs", "2",
            "--rollout", "4", "--episode-steps", "4", "--n-jobs", "12",
            "--horizon", "300"]
    PSIM.reset_macro_ticks()
    _, history = rl_train.main(base + ["--out", str(tmp_path)])
    assert len(history) == 1 and np.isfinite(history[0]["mean_reward"])
    assert PSIM.MACRO_TICKS["fast"] > 0       # the macro env ran
    trace = np.load(tmp_path / "power_trace_rl.npy")
    assert trace.shape == (4,) and np.all(trace > 0)
    assert (tmp_path / "ppo_history.json").exists()
    # --ckpt checkpoints every 10 iterations; --resume goes on from there
    ckpt = str(tmp_path / "ckpt")
    ten, eleven = list(base), list(base)
    ten[ten.index("--iterations") + 1] = "10"
    eleven[eleven.index("--iterations") + 1] = "11"
    rl_train.main(ten + ["--ckpt", ckpt])
    assert os.listdir(ckpt) == ["step_0000000009"]
    _, resumed = rl_train.main(eleven + ["--ckpt", ckpt, "--resume"])
    assert [h["iteration"] for h in resumed] == [10]
    with pytest.raises(SystemExit):
        rl_train.main(base + ["--mesh", "4"])
