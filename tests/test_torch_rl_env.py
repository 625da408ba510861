"""The port's ``SchedEnv`` against the JAX package's ``SchedEnv(macro=
False)`` on ``tiny_cluster(sched_max_candidates=4)``: three 24-job
workloads in 900 s, episodes of 8 decisions of 5 ticks
(``tests/test_rl.py``'s setting).

``reset`` from the same key words; then a scripted action sequence over
two episodes (every candidate index, the no-op, indices past the queued
candidates; a fresh reset between them), for one env and for E = 4
against ``jax.vmap(env.step)``: per-step observations, rewards and info
fields within ``RTOL``, dones and every integer sim field exactly, the
whole state field by field (``_torch_parity``). Also with
``placement="partition"`` and with the thermal twin at settings where
racks trip mid-episode (so the trip gates the candidates' feasibility),
the default ``macro=True`` against the JAX package's macro env, and
``scheduler="rl"`` on a batched state against its replicas run alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import RTOL, assert_state_close, to_numpy

import repro.configs.sim as rcfg
from repro.data import synth_workload
from repro.envs import SchedEnv as RefEnv
from repro.envs import sched_env as rse
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch.core.state import broadcast_state
from repro_torch.envs import SchedEnv
from repro_torch.envs import sched_env as pse
from repro_torch.envs.sched_env import (
    CANDIDATE_FEATURES,
    GLOBAL_FEATURES,
    RESILIENCE_FEATURES,
    SERVING_FEATURES,
    THERMAL_FEATURES,
)

ENV_KW = dict(episode_steps=8, sim_steps_per_action=5)
# racks cross the trip a few decisions into each episode
TRIP = dict(thermal_enabled=True, rack_tau_s=120.0, thermal_trip_c=15.0,
            throttle_start_c=14.5, throttle_full_c=24.0, nodes_per_rack=4)
CASES = {
    "first_fit": ({}, "first_fit"),
    "partition": ({}, "partition"),
    "thermal_trip": (TRIP, "first_fit"),
}


def _envs(extra, placement):
    rc = rcfg.tiny_cluster(sched_max_candidates=4, **extra)
    pc = pcfg.tiny_cluster(sched_max_candidates=4, **extra)
    wls = [synth_workload(rc, 24, 900.0, seed=s) for s in range(3)]
    ref = RefEnv(rc, wls, placement=placement, macro=False, **ENV_KW)
    port = SchedEnv(pc, wls, placement=placement, macro=False,
                    device="cpu", **ENV_KW)
    return ref, port


@pytest.fixture(scope="module", params=list(CASES))
def envs(request):
    return request.param, _envs(*CASES[request.param])


def _words(keys):
    return torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
        np.int64))


def _close(got, want, tag):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                               atol=0.0, err_msg=tag)


def _assert_env_state(ref_st, st, tag):
    assert_state_close(ref_st.sim, st.sim, f"{tag}.sim")
    np.testing.assert_array_equal(to_numpy(st.step_count),
                                  np.asarray(ref_st.step_count))


def test_layout_and_spaces_match_reference(envs):
    _, (ref, port) = envs
    assert port.obs_dim == ref.obs_dim
    assert port.n_actions == ref.n_actions == port.k + 1
    for name in ("GLOBAL_FEATURES", "THERMAL_FEATURES", "CANDIDATE_FEATURES",
                 "RESILIENCE_FEATURES", "SERVING_FEATURES", "TYPE_FEATURES"):
        assert getattr(pse, name) == getattr(rse, name), name
    # the resilience and serving blocks count zero with those models off
    thermal = len(THERMAL_FEATURES) if port.cfg.thermal_enabled else 0
    assert port.obs_dim == (len(GLOBAL_FEATURES) + thermal + 5
                            + 3 * port.cfg.n_types
                            + len(CANDIDATE_FEATURES) * port.k)
    assert RESILIENCE_FEATURES and SERVING_FEATURES


def test_reset_matches_reference(envs):
    _, (ref, port) = envs
    keys = jax.random.split(jax.random.key(11), 4)
    rs, robs = jax.jit(jax.vmap(ref.reset))(keys)
    st, obs = port.reset(_words(keys))
    np.testing.assert_array_equal(to_numpy(st.sim.workload),
                                  np.asarray(rs.sim.workload))
    assert tuple(obs.shape) == tuple(np.shape(robs))
    _close(obs, robs, "obs")
    _assert_env_state(rs, st, "reset")


def _script(k, n_envs, steps):
    t = np.arange(steps)[:, None]
    e = np.arange(n_envs)[None, :]
    return ((t + 3 * e) % (k + 1)).astype(np.int32)


def _run_episodes(ref, port, n_envs, name):
    """Two episodes of 8 scripted decisions, a fresh reset between them,
    in both packages; ``n_envs`` None: one unbatched env (the port takes
    Python ints)."""
    batched = n_envs is not None
    step = jax.jit(jax.vmap(ref.step) if batched else ref.step)
    reset = jax.jit(jax.vmap(ref.reset) if batched else ref.reset)
    script = _script(port.k, n_envs or 1, 2 * port.episode_steps)
    past_queue = tripped = 0
    for ep in range(2):
        keys = jax.random.split(jax.random.key(20 + ep), n_envs or 1)
        keys = keys if batched else keys[0]
        rs, robs = reset(keys)
        st, obs = port.reset(_words(keys))
        for t in range(port.episode_steps):
            a = script[ep * port.episode_steps + t]
            n_valid = to_numpy(obs[..., -8 * port.k:-7 * port.k]).sum(-1)
            past_queue += int(((a < port.k) & (a >= n_valid)).sum())
            if batched:
                rs, robs, rr, rd, ri = step(rs, jnp.asarray(a))
                st, obs, r, d, info = port.step(st, torch.from_numpy(a))
            else:
                rs, robs, rr, rd, ri = step(rs, jnp.int32(a[0]))
                st, obs, r, d, info = port.step(st, int(a[0]))
            tag = f"{name} E={n_envs} ep {ep} step {t}"
            _close(obs, robs, f"{tag} obs")
            _close(r, rr, f"{tag} reward")
            np.testing.assert_array_equal(to_numpy(d), np.asarray(rd),
                                          err_msg=f"{tag} done")
            assert sorted(info) == sorted(ri)
            for f in ri:
                _close(info[f], ri[f], f"{tag} info.{f}")
            _assert_env_state(rs, st, tag)
            if port.cfg.thermal_enabled:
                tripped += int((to_numpy(st.sim.rack_outlet_c)
                                >= port.cfg.thermal_trip_c).sum())
        assert to_numpy(d).all()
    assert past_queue > 0
    if port.cfg.thermal_enabled:
        assert tripped > 0        # the trip gated the feasibility features


def test_scripted_episodes_match_reference(envs):
    """E = 4 environments against ``jax.vmap(env.step)``."""
    name, (ref, port) = envs
    _run_episodes(ref, port, 4, name)


def test_one_env_scripted_episodes_match_reference():
    """One unbatched environment against ``env.step``."""
    ref, port = _envs(*CASES["first_fit"])
    _run_episodes(ref, port, None, "one env")


def test_macro_is_the_default_and_runs():
    """``macro=True`` is the default, as in the JAX package, and a step of
    it equals the JAX package's macro env and the port's ``macro=False``
    (``tests/test_torch_macro.py`` holds whole episodes); an unknown
    placement still raises."""
    rc = rcfg.tiny_cluster(sched_max_candidates=4)
    pc = pcfg.tiny_cluster(sched_max_candidates=4)
    wls = [synth_workload(rc, 24, 900.0, seed=0)]
    ref = RefEnv(rc, wls, **ENV_KW)
    port = SchedEnv(pc, wls, device="cpu", **ENV_KW)
    oracle = SchedEnv(pc, wls, macro=False, device="cpu", **ENV_KW)
    assert port.macro and ref.macro
    key = jax.random.key(5)
    rs, _ = ref.reset(key)
    st, _ = port.reset(_words(key))
    so, _ = oracle.reset(_words(key))
    step = jax.jit(ref.step)
    for a in (0, 4, 1):
        rs, robs, rr, _, _ = step(rs, jnp.int32(a))
        st, obs, r, _, _ = port.step(st, a)
        so, oobs, orr, _, _ = oracle.step(so, a)
        assert torch.equal(obs, oobs) and torch.equal(r, orr)
        _close(obs, robs, f"action {a} obs")
        _close(r, rr, f"action {a} reward")
    _assert_env_state(rs, st, "macro env")
    with pytest.raises(KeyError):
        SchedEnv(pc, wls, placement="nowhere", macro=False, device="cpu")


def test_rl_step_on_a_batched_state_equals_replicas_alone():
    """``make_step(..., "rl")`` on an (E,) batch, each replica with its
    own action (candidates, the no-op, past the queue), equals each
    replica stepped alone: bitwise on the CPU."""
    pc = pcfg.tiny_cluster(sched_max_candidates=4)
    jobs, bank = synth_workload(pc, 24, 120.0, seed=3, mean_dur_s=150.0)
    st = C.build_statics(pc, bank, device="cpu")
    s = C.load_jobs(C.init_state(pc, st, 0), jobs)
    step = C.make_step(pc, st, "rl")
    idle = C.make_step(pc, st, "none")
    for _ in range(20):
        s, _ = idle(s, -1)
    E = 5
    batch = broadcast_state(s, E)
    alone = [s] * E
    rng = np.random.default_rng(0)
    for t in range(40):
        acts = rng.integers(0, pc.sched_max_candidates + 1, E)
        batch, out = step(batch, torch.from_numpy(acts))
        for e in range(E):
            alone[e], o = step(alone[e], int(acts[e]))
            assert float(o.reward) == float(out.reward[e])
    for e in range(E):
        for f, a in zip(alone[e]._fields, alone[e]):
            assert torch.equal(a, getattr(batch, f)[e]), (e, f)
    assert int((batch.jstate == C.RUNNING).sum()) > 0
