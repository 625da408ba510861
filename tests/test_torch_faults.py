"""The port's resilience twin against the JAX package's, on the CPU.

- ``prng.exponential``: all 2**23 values the uniform can take through
  ``-log1p(-u)`` bitwise against XLA's, and whole draws against
  ``jax.random.exponential``;
- ``init_state``'s fault clocks and key words bitwise at seeds 0-3;
- ``apply_faults`` field by field on ``tiny_cluster`` states built once in
  the JAX package and carried across (``interop``): node fires, a rack
  fire, an absorbed fire, a forced maintenance window, a repair, kills
  rewound to their checkpoint, retries exhausted into ``FAILED``, requeue
  backoff at multipliers 2.0 and 1.5, a level-4 eviction, and a quiet tick
  as a bitwise fixpoint; integers and clocks exact, floats to ``RTOL``;
- ``ckpt_interval_s=1.1e-308`` cast to 0.0 by both packages;
- a mass eviction on TX-GAIA (every running job released in one tick,
  nodes shared by up to five jobs with fractional ``mem_gb``): ``free``
  and the dispatches after it against the JAX package;
- a short-MTBF TX-GAIA replay, per tick and macro-stepped, against the
  JAX package's per-tick run (the port's macro bitwise with its per tick);
- a fleet of 4 (own keys, own clocks, drill and default grids) against
  the JAX package's vmapped ``run_fleet``, and ``SchedEnv`` with the
  ladder's actions and the resilience features against the JAX env.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    RTOL,
    assert_state_close,
    assert_summary_close,
    assert_tree_close,
    make_pair,
    ref_numpy,
    to_numpy,
)

import repro.configs.sim as rcfg
import repro.core as R
from repro.core import faults as RF
from repro.core.fleet import run_fleet as ref_run_fleet
from repro.data import synth_workload
from repro.envs import SchedEnv as RefEnv
from repro.scenarios import scenario as RSC
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import interop
from repro_torch.core import faults as PF
from repro_torch.core.fleet import run_fleet
from repro_torch.envs import SchedEnv
from repro_torch.envs.sched_env import RESILIENCE_FEATURES
from repro_torch.scenarios import scenario as PSC
from repro_torch.utils import prng
from repro_torch.utils.errors import ConfigError

CLOCKS = ("next_fail_t", "rack_fail_t", "repair_t", "submit_t", "start_t",
          "end_t")


def _words(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


def test_exponential_exhaustive_against_xla():
    """``-log1p(-u)`` on every u = k 2**-23 that ``uniform`` gives (the
    whole domain of ``exponential``'s transform) has XLA's bits, and whole
    draws equal ``jax.random.exponential``."""
    u = (np.arange(2 ** 23, dtype=np.float64) * 2.0 ** -23).astype(np.float32)
    want = np.asarray(jax.jit(lambda u: jax.lax.neg(jax.lax.log1p(
        jax.lax.neg(u))))(u))
    got = (-prng.log1p_f32(-torch.from_numpy(u))).numpy()
    assert np.count_nonzero(want.view(np.int32) != got.view(np.int32)) == 0
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jax.random.exponential(key, (3, 1000)))
        got = prng.exponential(_words(key), (3, 1000)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _round32(q) -> float:
    """The f32 nearest the exact rational ``q``, ties to even."""
    near = np.float32(float(q))
    cands = {float(near), float(np.nextafter(near, np.float32(np.inf))),
             float(np.nextafter(near, np.float32(-np.inf)))}
    return min(cands, key=lambda v: (abs(Fraction(v) - q),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """``fma_f32`` where the f64 sum lands on an f32 tie that the exact
    sum is not (rounding twice would go the wrong way, up and down), and
    an ordinary case: each result is the exact value rounded once."""
    a = [1.0 + 2.0 ** -12, 1.0 + 2.0 ** -12, 3.0]
    b = [1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, float(np.float32(0.1))]
    c = [2.0 ** -60, -(2.0 ** -60), 1.0]
    want = [_round32(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]

    def t(v):
        return torch.tensor(v, dtype=torch.float32)
    got = prng.fma_f32(t(a), t(b), t(c)).tolist()
    assert got == want
    # the f64 sum alone would round the two ties the other way
    twice = [float(np.float32(x * y + z)) for x, y, z in zip(a, b, c)]
    assert twice[:2] != want[:2]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_init_state_clocks_and_key_words(seed):
    kw = dict(node_mtbf_hours=6.0, rack_mtbf_hours=48.0)
    rc, pc = rcfg.tx_gaia(max_jobs=16, **kw), pcfg.tx_gaia(max_jobs=16, **kw)
    want = ref_numpy(R.init_state(rc, R.build_statics(rc),
                                  jax.random.key(seed)))
    got = C.init_state(pc, C.build_statics(pc, device="cpu"), seed)
    for f in ("key", "next_fail_t", "rack_fail_t"):
        np.testing.assert_array_equal(
            to_numpy(getattr(got, f)).astype(np.float64),
            np.asarray(getattr(want, f)).astype(np.float64), err_msg=f)
    # a batch of keys: each replica draws from its own key, as vmap does
    keys = jax.random.split(jax.random.key(seed), 3)
    want = ref_numpy(jax.vmap(lambda k: R.init_state(
        rc, R.build_statics(rc), k))(keys))
    got = C.init_state(pc, C.build_statics(pc, device="cpu"), _words(keys))
    for f in ("key", "next_fail_t", "rack_fail_t"):
        np.testing.assert_array_equal(
            to_numpy(getattr(got, f)).astype(np.float64),
            np.asarray(getattr(want, f)).astype(np.float64), err_msg=f)


def test_ckpt_interval_cast_to_f32():
    """Both packages store ``ckpt_interval`` as f32: 1.1e-308 becomes 0.0
    (no checkpoints), whatever the JAX package's own property test
    assumes."""
    rc = rcfg.tiny_cluster(ckpt_interval_s=1.1e-308)
    pc = pcfg.tiny_cluster(ckpt_interval_s=1.1e-308)
    want = np.asarray(R.init_state(rc, R.build_statics(rc),
                                   jax.random.key(0)).ckpt_interval)
    got = C.init_state(pc, C.build_statics(pc, device="cpu"),
                       0).ckpt_interval.numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()


# ------------------------------------------------------------ apply_faults
def _base(cfg_kw, scenario=None):
    """A JAX-package state of ``tiny_cluster(nodes_per_rack=4, **cfg_kw)``
    with jobs running (fcfs from a fault-free run), its statics, and the
    port's statics carried across."""
    rc = rcfg.tiny_cluster(nodes_per_rack=4, **cfg_kw)
    pc = pcfg.tiny_cluster(nodes_per_rack=4, **cfg_kw)
    quiet = rcfg.tiny_cluster(nodes_per_rack=4)
    jobs, bank = synth_workload(rc, 32, 600.0, seed=3)
    scn = None if scenario is None else scenario(RSC, rc)
    rst = R.build_statics(rc, bank, scenario=scn)
    rs = R.load_jobs(R.init_state(rc, rst, jax.random.key(7)), jobs)
    warm, _ = jax.jit(lambda s: R.run_episode(
        quiet, rst, s, 200, "fcfs", summary_only=True))(rs)
    rs = rs._replace(**{f: getattr(warm, f) for f in (
        "t", "free", "jstate", "start_t", "work_left", "placement")})
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    return rc, pc, rst, rs, pst


def _edit(rs, **fields):
    """The JAX state with numpy edits (key words stay typed)."""
    return rs._replace(**{f: jnp.asarray(v) for f, v in fields.items()})


def _port_state(rs):
    return interop.state_from_numpy(ref_numpy(rs), device="cpu")


def _node_of_running(rs, n=2):
    """Nodes of the first ``n`` running jobs' first slots."""
    run = np.flatnonzero(np.asarray(rs.jstate) == R.RUNNING)
    assert run.size >= n
    return [int(np.asarray(rs.placement)[j, 0]) for j in run[:n]]


def _due(rs, nodes):
    clocks = np.full(np.shape(rs.next_fail_t), 1e9, np.float32)
    clocks[nodes] = float(rs.t) - 0.5
    return clocks


def _case(name):
    """(cfg kw, scenario builder, edit(rs) -> rs) of an apply_faults case."""
    ck = dict(ckpt_interval_s=40.0, ckpt_overhead_s=5.0)
    if name == "node_fire":
        def edit(rs):
            nodes = _node_of_running(rs)
            up = np.asarray(rs.node_up).copy()
            up[15] = 0.0                    # an absorbed fire: already down
            rep = np.asarray(rs.repair_t).copy()
            rep[15] = float(rs.t) + 300.0
            return _edit(rs, next_fail_t=_due(rs, nodes + [15]), node_up=up,
                         repair_t=rep)
        return dict(node_mtbf_hours=1.0, node_repair_hours=0.1, **ck), \
            None, edit
    if name == "rack_fire":
        def edit(rs):
            rack = np.full(np.shape(rs.rack_fail_t), 1e9, np.float32)
            rack[1] = float(rs.t)
            return _edit(rs, rack_fail_t=rack,
                         next_fail_t=np.full(np.shape(rs.next_fail_t), 1e9,
                                             np.float32))
        return dict(rack_mtbf_hours=2.0, rack_repair_hours=0.2, **ck), \
            None, edit
    if name == "forced_window":
        def drill(m, cfg):
            return m.resilience_drill(cfg, maint_rack=2, maint_start_s=100.0,
                                      maint_len_s=400.0,
                                      brownout_start_s=1e5)
        return dict(outages_enabled=True, **ck), drill, lambda rs: rs
    if name == "repair":
        def edit(rs):
            up = np.asarray(rs.node_up).copy()
            rep = np.asarray(rs.repair_t).copy()
            up[[3, 9]] = 0.0
            rep[3] = float(rs.t) - 1.0       # due now
            rep[9] = float(rs.t) + 50.0      # not yet
            return _edit(rs, node_up=up, repair_t=rep,
                         next_fail_t=_due(rs, []))
        return dict(node_mtbf_hours=1.0), None, edit
    if name == "retries_exhausted":
        def edit(rs):
            nodes = _node_of_running(rs, 3)
            fails = np.asarray(rs.n_failures).copy()
            fails[:] = 1
            return _edit(rs, next_fail_t=_due(rs, nodes), n_failures=fails)
        return dict(node_mtbf_hours=1.0, max_job_retries=1, **ck), None, edit
    if name.startswith("backoff"):
        mult = float(name.split("_")[1])

        def edit(rs):
            fails = np.asarray(rs.n_failures).copy()
            fails[::2] = 2
            return _edit(rs, next_fail_t=_due(rs, _node_of_running(rs, 3)),
                         n_failures=fails)
        return dict(node_mtbf_hours=1.0, requeue_backoff_s=45.0,
                    requeue_backoff_mult=mult, max_job_retries=5), None, edit
    if name == "evict":
        return dict(degrade_enabled=True, **ck), None, \
            lambda rs: _edit(rs, degrade_level=np.int32(4))
    if name == "quiet":
        return dict(node_mtbf_hours=1.0, rack_mtbf_hours=2.0,
                    outages_enabled=True, **ck), None, \
            lambda rs: _edit(rs, next_fail_t=_due(rs, []),
                             rack_fail_t=np.full(np.shape(rs.rack_fail_t),
                                                 1e9, np.float32))
    raise KeyError(name)


APPLY_CASES = ("node_fire", "rack_fire", "forced_window", "repair",
               "retries_exhausted", "backoff_2.0", "backoff_1.5", "evict",
               "quiet")


@pytest.mark.parametrize("name", APPLY_CASES)
def test_apply_faults_matches_reference(name):
    cfg_kw, scenario, edit = _case(name)
    rc, pc, rst, rs, pst = _base(cfg_kw, scenario)
    rs = edit(rs)
    ps = _port_state(rs)
    want, wk, wl = jax.jit(lambda s: RF.apply_faults(rc, s, rst))(rs)
    got, gk, gl = PF.apply_faults(pc, ps, pst)
    want = ref_numpy(want)
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), to_numpy(getattr(got, f))
        if a.dtype.kind in "iub" or f in CLOCKS + ("key",):
            np.testing.assert_array_equal(b.astype(np.float64),
                                          a.astype(np.float64), err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0.0, err_msg=f)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL)
    before = ref_numpy(rs)
    killed = int(np.asarray(wk))
    if name in ("node_fire", "rack_fire", "retries_exhausted") \
            or name.startswith("backoff"):
        assert killed > 0
        assert not np.array_equal(np.asarray(want.key),
                                  np.asarray(before.key))
    if name == "retries_exhausted":
        assert float(want.n_failed) > 0
    if name.startswith("backoff"):
        assert np.any(np.asarray(want.submit_t)
                      > np.asarray(before.submit_t))
    if name == "forced_window":
        assert np.asarray(want.node_up)[8:12].sum() == 0
    if name == "repair":
        assert np.asarray(want.node_up)[3] == 1.0
        assert np.asarray(want.node_up)[9] == 0.0
    if name == "evict":
        assert not np.any(np.asarray(want.jstate) == R.RUNNING)
        assert float(want.lost_node_s) == 0.0
    if name == "quiet":
        # a tick with nothing due changes nothing, the key included
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(ps, f)), f


# -------------------------------------------------------- TX-GAIA episodes
def test_mass_eviction_release_on_tx_gaia():
    """600 ticks of the replay hour, then the ladder at EVICT for one tick
    (every running job checkpoint-evicted: 27 jobs, nodes shared by up to
    five, fractional mem_gb) and back to NORMAL: ``free`` after the mass
    release within RTOL (the port sums each node's releases as one
    product, the JAX package slot by slot onto ``free``) and every
    placement and job state of the next 60 ticks exact."""
    kw = dict(max_jobs=256, max_nodes_per_job=16, degrade_enabled=True)
    rc, pc = rcfg.tx_gaia(**kw), pcfg.tx_gaia(**kw)
    rst, rs, pst, ps, _, _ = make_pair(rc, pc, 200, 3600.0, seed=0)
    rs, _ = jax.jit(lambda s: R.run_episode(rc, rst, s, 600, "replay",
                                            summary_only=True))(rs)
    ps, _ = C.run_episode(pc, pst, ps, 600, "replay", summary_only=True)
    run = to_numpy(ps.jstate) == C.RUNNING
    place = to_numpy(ps.placement)[run]
    shared = np.bincount(place[place >= 0], minlength=pc.n_nodes)
    assert run.sum() >= 20 and shared.max() >= 3
    rstep = jax.jit(R.make_step(rc, rst, "replay"))
    pstep = C.make_step(pc, pst, "replay")
    rs, _ = rstep(rs._replace(degrade_level=jnp.int32(4)), jnp.int32(-1))
    ps, _ = pstep(ps._replace(degrade_level=torch.tensor(
        4, dtype=torch.int32)), -1)
    assert not (to_numpy(ps.jstate) == C.RUNNING).any()
    np.testing.assert_allclose(to_numpy(ps.free), np.asarray(rs.free),
                               rtol=RTOL, atol=0.0)
    rs = rs._replace(degrade_level=jnp.int32(0))
    ps = ps._replace(degrade_level=torch.tensor(0, dtype=torch.int32))
    for _ in range(60):
        rs, _ = rstep(rs, jnp.int32(-1))
        ps, _ = pstep(ps, -1)
        np.testing.assert_array_equal(to_numpy(ps.placement),
                                      np.asarray(rs.placement))
        np.testing.assert_array_equal(to_numpy(ps.jstate),
                                      np.asarray(rs.jstate))
    assert (to_numpy(ps.jstate) == C.RUNNING).sum() > 0


def test_short_mtbf_tx_gaia_per_tick_and_macro():
    """TX-GAIA's 672 nodes with a 64 x 4 job table and short MTBFs for 300
    ticks of replay: the port's per-tick state against the JAX package's
    per-tick run (clocks and integers exact), and the port's macro run
    bitwise with its per-tick run."""
    kw = dict(max_jobs=64, max_nodes_per_job=4, node_mtbf_hours=0.5,
              node_repair_hours=0.05, rack_mtbf_hours=2.0,
              rack_repair_hours=0.05, ckpt_interval_s=60.0,
              ckpt_overhead_s=5.0, max_job_retries=2)
    rc, pc = rcfg.tx_gaia(**kw), pcfg.tx_gaia(**kw)
    rst, rs, pst, ps, _, _ = make_pair(rc, pc, 40, 300.0, seed=2)
    rf, rt = jax.jit(lambda s: R.run_episode(rc, rst, s, 300, "replay",
                                             summary_only=True))(rs)
    pf, pt = C.run_episode(pc, pst, ps, 300, "replay", summary_only=True)
    assert float(pf.n_killed) > 0
    assert_state_close(rf, pf, "per tick")
    for f in CLOCKS:
        np.testing.assert_array_equal(to_numpy(getattr(pf, f)),
                                      np.asarray(getattr(rf, f)), err_msg=f)
    assert_tree_close(rt, pt, "telemetry", skip=("macro_steps",))
    assert_summary_close(R.summary(rf, rt), C.summary(pf, pt), "summary")
    mf, mt = C.run_episode(pc, pst, ps, 300, "replay", macro=True)
    for f in pf._fields:
        assert torch.equal(getattr(mf, f), getattr(pf, f)), f
    for f in pt._fields:
        if f != "macro_steps":
            assert torch.equal(getattr(mt, f), getattr(pt, f)), f
    assert float(mt.macro_steps) < 300


# ------------------------------------------------------------ fleet and env
def _tiny_drill(m, cfg):
    return m.resilience_drill(cfg, maint_rack=1, maint_start_s=60.0,
                              maint_len_s=120.0, brownout_start_s=240.0,
                              brownout_len_s=60.0, brownout_level=4)


def test_fleet_of_four_matches_vmapped_reference():
    """Four replicas from keys 0-3 (each with its own clocks), default grid
    and drill alternating, 300 ticks of fcfs: the port's batched run
    against the JAX package's vmapped ``run_fleet``, field by field."""
    kw = dict(nodes_per_rack=4, node_mtbf_hours=0.3, node_repair_hours=0.02,
              rack_mtbf_hours=1.0, rack_repair_hours=0.02,
              outages_enabled=True, ckpt_interval_s=30.0, max_job_retries=3)
    rc, pc = rcfg.tiny_cluster(**kw), pcfg.tiny_cluster(**kw)
    jobs, bank = synth_workload(rc, 32, 300.0, seed=4)
    rst = R.build_statics(rc, bank)
    keys = jnp.stack([jax.random.key(e) for e in range(4)])
    rs = jax.vmap(lambda k: R.load_jobs(R.init_state(rc, rst, k), jobs,
                                        validate="off"))(keys)
    scns = [RSC.default_scenario(rc) if e % 2 == 0 else _tiny_drill(RSC, rc)
            for e in range(4)]
    rf, rt = ref_run_fleet(rc, rst, rs, 300, "fcfs",
                           scenarios=RSC.stack_scenarios(scns),
                           summary_only=True)
    pst = C.build_statics(pc, bank, device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, _words(keys)), jobs)
    pscns = [PSC.default_scenario(pc) if e % 2 == 0
             else _tiny_drill(PSC, pc) for e in range(4)]
    pf, pt = run_fleet(pc, pst, ps, 300, "fcfs",
                       scenarios=PSC.stack_scenarios(pscns),
                       summary_only=True)
    assert float(pf.n_killed.sum()) > 0
    assert_state_close(rf, pf, "fleet")
    assert_tree_close(rt, pt, "fleet telemetry")


@pytest.mark.parametrize("macro", [False, True])
def test_env_ladder_actions_and_features(macro):
    """``SchedEnv`` with the ladder schedulable and faults on, 4
    environments, a script through every dispatch index, the no-op and
    the five rungs: observations (the resilience block among them),
    rewards (with the lost-work term), dones and the ladder level against
    the JAX package's env, step by step."""
    kw = dict(sched_max_candidates=4, degrade_enabled=True,
              node_mtbf_hours=0.3, node_repair_hours=0.05,
              ckpt_interval_s=30.0, ckpt_overhead_s=3.0, max_job_retries=2)
    rc, pc = rcfg.tiny_cluster(**kw), pcfg.tiny_cluster(**kw)
    wls = [synth_workload(rc, 24, 900.0, seed=s) for s in range(3)]
    env_kw = dict(episode_steps=8, sim_steps_per_action=5, macro=macro,
                  reward_weights=(1.0, 1.0, 1.0, 0.05, 0.0, 0.5))
    ref = RefEnv(rc, wls, **env_kw)
    port = SchedEnv(pc, wls, device="cpu", **env_kw)
    assert port.n_actions == ref.n_actions == port.k + 6
    assert port.obs_dim == ref.obs_dim
    keys = jax.random.split(jax.random.key(5), 4)
    rst, robs = jax.vmap(ref.reset)(keys)
    pst, pobs = port.reset(_words(keys))
    step = jax.jit(jax.vmap(ref.step))
    t = np.arange(6)[:, None]
    script = ((t + 3 * np.arange(4)[None, :]) % (port.k + 6)).astype(np.int32)
    assert set(script.ravel()) == set(range(port.k + 6))
    g0 = len(pse_globals(port))
    for i in range(6):
        rst, robs, rr, rd, _ = step(rst, jnp.asarray(script[i]))
        pst, pobs, pr, pd, _ = port.step(pst, torch.from_numpy(
            script[i]).long())
        np.testing.assert_allclose(to_numpy(pobs), np.asarray(robs),
                                   rtol=RTOL, atol=0.0, err_msg=f"obs {i}")
        np.testing.assert_allclose(to_numpy(pr), np.asarray(rr), rtol=RTOL,
                                   err_msg=f"reward {i}")
        np.testing.assert_array_equal(to_numpy(pd), np.asarray(rd))
        np.testing.assert_array_equal(to_numpy(pst.sim.degrade_level),
                                      np.asarray(rst.sim.degrade_level))
    assert_state_close(rst.sim, pst.sim, "env sim")
    # the resilience block sits after the globals and reads the rung
    block = to_numpy(pobs)[:, g0:g0 + len(RESILIENCE_FEATURES)]
    np.testing.assert_allclose(
        block[:, 0], to_numpy(pst.sim.degrade_level) / 4.0, rtol=1e-6)


def pse_globals(env):
    from repro_torch.envs.sched_env import GLOBAL_FEATURES, THERMAL_FEATURES

    return GLOBAL_FEATURES + (THERMAL_FEATURES if env.cfg.thermal_enabled
                              else ())


def test_weights_and_refusals():
    """``w_lost`` and ``w_slo`` join the reward weights: with faults and
    serving on, both terms' rewards against the JAX package's, tick by
    tick; an eighth weight raises."""
    kw = dict(node_mtbf_hours=0.2, node_repair_hours=0.02,
              ckpt_interval_s=30.0, serving_enabled=True, serving_nodes=2,
              serving_queue_cap=20.0)
    rc, pc = rcfg.tiny_cluster(**kw), pcfg.tiny_cluster(**kw)
    scn = RSC.diurnal_serving(rc, peak_rps=6.0, period_s=600.0,
                              burst_start_s=60.0, burst_len_s=60.0)
    jobs, bank = synth_workload(rc, 24, 300.0, seed=2)
    rst = R.build_statics(rc, bank, scenario=scn)
    rs = R.load_jobs(R.init_state(rc, rst, jax.random.key(2)), jobs)
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    ps = interop.state_from_numpy(ref_numpy(rs), device="cpu")
    w = (1, 1, 1, 0.05, 0, 0.5, 2.0)
    _, rout = jax.jit(lambda s: R.run_episode(rc, rst, s, 200, "fcfs",
                                              reward_weights=w))(rs)
    pf, pout = C.run_episode(pc, pst, ps, 200, "fcfs", reward_weights=w)
    np.testing.assert_allclose(to_numpy(pout.reward),
                               np.asarray(rout.reward), rtol=RTOL)
    assert float(pf.n_killed) > 0 and float(pf.srv_shed) > 0
    with pytest.raises(ConfigError, match="4 to 7"):
        C.make_step(pc, pst, "fcfs", reward_weights=w + (1.0,))
