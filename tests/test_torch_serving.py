"""The port's serving twin against the JAX package's, on the CPU.

- each ``core.serving`` function on one batch of 4096 random pool states
  built once in the JAX package and carried across (``interop``): the
  clocks, the pool counts and the histogram exactly, request mass and
  power to ``RTOL``;
- the latency bucket on every f32 in [2**-4, 2**4] and on either side of
  each edge, equal to XLA's CPU ``floor(log2(.))`` bucket;
- ``retry_backoff``'s table against the JAX package's;
- request conservation under overload, every rung of the ladder firing;
- the full serving stack on ``tiny_cluster`` (a wake in flight from the
  first tick, a burst, shedding, retries, drops) per tick against the JAX
  package's per tick, the port's macro run bitwise with its own per tick;
- serving with thermals, and with faults and the ladder;
- a fleet of four against the JAX package's vmapped ``run_fleet``;
- ``SchedEnv``'s serving observation block and its four actions;
- a serving scenario carried through ``scenario_from_numpy`` and padded by
  ``stack_scenarios``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    RTOL,
    assert_close,
    assert_state_close,
    assert_tree_close,
    ref_numpy,
    to_numpy,
)

import repro.configs.sim as rcfg
import repro.core as R
from repro.core import serving as RS
from repro.core.fleet import run_fleet as ref_run_fleet
from repro.data import synth_workload
from repro.envs import SchedEnv as RefEnv
from repro.scenarios import scenario as RSC
from repro.scenarios.events import burst_events as ref_burst_events
from repro.scenarios.events import burst_mult_at as ref_burst_mult_at
from repro.scenarios.events import next_burst_event as ref_next_burst_event
from repro.scenarios.signals import eval_signal as ref_eval_signal
from repro.scenarios.signals import from_trace as ref_from_trace
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import interop
from repro_torch.core import serving as PS
from repro_torch.core.fleet import run_fleet
from repro_torch.envs import SchedEnv
from repro_torch.envs.sched_env import (
    GLOBAL_FEATURES,
    SERVING_FEATURES,
)
from repro_torch.scenarios import scenario as PSC
from repro_torch.scenarios.events import burst_mult_at, next_burst_event
from repro_torch.scenarios.signals import eval_signal

# ``tests/test_serving.py``'s pool: 4 nodes of 4 concurrent requests, a
# 60-request queue, 2 retries
POOL = dict(serving_enabled=True, serving_nodes=4, serving_concurrency=4.0,
            serving_service_s=3.0, serving_queue_cap=60.0,
            serving_timeout_s=20.0, serving_slo_s=6.0, serving_max_retries=2,
            serving_backoff_s=5.0)
CLOCKS = ("srv_retry_t", "srv_wake_t", "srv_active", "srv_wake_n",
          "srv_target", "srv_lat_hist")


def _words(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


def _traffic(mod, cfg, **kw):
    base = dict(peak_rps=30.0, period_s=1800.0, burst_start_s=300.0,
                burst_len_s=200.0, burst_mult=3.0)
    return mod.diurnal_serving(cfg, **{**base, **kw})


def _pair(cfg_kw, n_jobs=0, seed=0, scenario_kw=None, active=None):
    """(ref cfg, port cfg, ref statics, ref state, port statics, port
    state) of a ``tiny_cluster`` serving config under ``_traffic``."""
    rc, pc = rcfg.tiny_cluster(**cfg_kw), pcfg.tiny_cluster(**cfg_kw)
    scn = _traffic(RSC, rc, **(scenario_kw or {}))
    if n_jobs:
        jobs, bank = synth_workload(rc, n_jobs, 900.0, seed=seed)
    else:
        jobs, bank = None, None
    rst = R.build_statics(rc, bank, scenario=scn)
    rs = R.init_state(rc, rst, jax.random.key(seed))
    if jobs is not None:
        rs = R.load_jobs(rs, jobs)
    if active is not None:
        rs = rs._replace(srv_active=jnp.float32(active))
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    ps = interop.state_from_numpy(ref_numpy(rs), device="cpu")
    return rc, pc, rst, rs, pst, ps


# ------------------------------------------------------ the functions alone
E_RANDOM = 4096


@pytest.fixture(scope="module")
def random_pool():
    """E_RANDOM pool states at random times, queues, retry buckets and
    clocks, wake batches, targets and thresholds (a batch in both
    packages), and a throttle and a COP per state."""
    rc, pc, rst, rs, pst, _ = _pair(POOL)
    rng = np.random.default_rng(0)
    E, B1 = E_RANDOM, rc.serving_max_retries + 1

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, (E,) + shape).astype(np.float32)

    def n(hi):
        return rng.integers(0, hi, E).astype(np.float32)

    t = np.round(u(0, 900))
    fields = dict(
        t=t, srv_queue=u(0, 40, B1), srv_inflight=u(0, 20),
        srv_retry_q=u(0, 5, B1) * (rng.random((E, B1)) < 0.5),
        srv_retry_t=np.where(rng.random((E, B1)) < 0.3, np.inf,
                             np.round(u(0, 900, B1))).astype(np.float32),
        srv_active=n(5), srv_wake_n=n(3),
        srv_wake_t=np.where(rng.random(E) < 0.3, np.inf,
                            t + np.round(u(-20, 20))).astype(np.float32),
        srv_target=n(6), srv_admit_thresh=u(0.05, 1.0))
    rsE = jax.tree.map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), rs)
    rsE = rsE._replace(**{f: jnp.asarray(v) for f, v in fields.items()})
    psE = interop.state_from_numpy(ref_numpy(rsE), device="cpu")
    throttle, cop = u(0.3, 1.0), u(3.0, 6.0)
    return rc, pc, rst, pst, rsE, psE, throttle, cop


def _check(ref, got, tag):
    """Exact for the clocks, counts and histogram, ``RTOL`` otherwise."""
    ref, got = np.asarray(ref), to_numpy(got)
    if tag.split(".")[-1] in CLOCKS or ref.dtype == bool:
        np.testing.assert_array_equal(got, ref, err_msg=tag)
    else:
        assert_close(ref, got, tag)


def _check_state(ref, got, tag):
    ref, got = ref_numpy(ref), to_numpy(got)
    for f in ref._fields:
        if f.startswith("srv_"):
            _check(getattr(ref, f), getattr(got, f), f"{tag}.{f}")


@pytest.mark.parametrize("name", [
    "apply_serving", "serving_power", "serving_flow", "serving_trigger",
    "next_serving_event", "serving_crossing_horizon"])
def test_serving_function_matches_reference(random_pool, name):
    rc, pc, rst, pst, rsE, psE, throttle, cop = random_pool
    th, cp = torch.from_numpy(throttle), torch.from_numpy(cop)
    if name == "apply_serving":
        want = jax.jit(jax.vmap(lambda s: RS.apply_serving(rc, s, rst)))(rsE)
        got = PS.apply_serving(pc, psE, pst)
        _check_state(want[0], got[0], name)
        for i, part in enumerate(("shed", "dropped", "retried"), 1):
            _check(want[i], got[i], f"{name}.{part}")
        # the sweep moved mass, woke, slept and scheduled retries
        for f in ("srv_shed", "srv_dropped", "srv_retried"):
            assert float(getattr(got[0], f).sum()) > 0, f
        assert bool((got[0].srv_active != psE.srv_active).any())
    elif name == "serving_power":
        want = jax.jit(jax.vmap(lambda s, c: RS.serving_power(rc, s, c)))(
            rsE, cop)
        got = PS.serving_power(pc, psE, cp)
        for i, part in enumerate(("it_w", "input_w", "cooling_w", "idle_w")):
            _check(want[i], got[i], f"{name}.{part}")
    elif name == "serving_flow":
        want = jax.jit(jax.vmap(
            lambda s, t: RS.serving_flow(rc, s, rst, t)))(rsE, throttle)
        got = PS.serving_flow(pc, psE, pst, th)
        _check_state(want[0], got[0], name)
        for i, part in enumerate(("arrive", "comp", "viol", "w_est",
                                  "q_after", "srv_lat_hist"), 1):
            _check(want[i], got[i], f"{name}.{part}")
        assert float(got[3].sum()) > 0          # some mass over the SLO
        assert int((got[6] > 0).any(0).sum()) >= 4   # buckets in use
    elif name == "serving_trigger":
        want = jax.vmap(lambda s: RS.serving_trigger(rc, s))(rsE)
        got = PS.serving_trigger(pc, psE)
        _check(want, got, name)
        assert 0 < int(got.sum()) < E_RANDOM
    elif name == "next_serving_event":
        want = jax.vmap(lambda s: RS.next_serving_event(rc, s, rst, s.t))(
            rsE)
        got = PS.next_serving_event(pc, psE, pst, psE.t)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    else:
        # at a peak of 0.5 req/s, so that the headroom lasts some ticks
        _, _, rlow, _, plow, _ = _pair(POOL, scenario_kw=dict(
            peak_rps=0.5))
        for r_st, p_st in ((rst, pst), (rlow, plow)):
            want = jax.vmap(lambda s: RS.serving_crossing_horizon(
                rc, s, r_st, 4096))(rsE)
            got = PS.serving_crossing_horizon(pc, psE, p_st, 4096)
            np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        assert int((got > 0).sum()) > 100


# ------------------------------------------------------------ the buckets
def _xla_bucket():
    return jax.jit(lambda r: jnp.clip(jnp.floor(jnp.log2(jnp.maximum(
        r, 1e-9))).astype(jnp.int32) + 4, 0, 7))


def _port_bucket(x: np.ndarray) -> np.ndarray:
    return PS.latency_bucket(torch.from_numpy(x)).numpy()


def test_latency_bucket_exhaustive_against_xla():
    """Every f32 in [2**-4, 2**4], one binade at a time, and the values
    around each edge and at the ends: the port's bucket is XLA's CPU
    ``clip(floor(log2(max(r, 1e-9))) + 4, 0, 7)``."""
    xla = _xla_bucket()
    for b in range(-4, 4):
        lo = np.float32(2.0 ** b).view(np.int32)
        hi = np.float32(2.0 ** (b + 1)).view(np.int32)
        x = np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)
        np.testing.assert_array_equal(_port_bucket(x), np.asarray(xla(x)),
                                      err_msg=f"binade 2**{b}")
    edges = PS.BUCKET_EDGES.view(np.int32)
    near = (edges[:, None] + np.arange(-64, 65)[None, :]).ravel()
    ends = np.array([0.0, 1e-30, 1e-9, 2 ** -20, 1e4, 1e30,
                     np.finfo(np.float32).max], np.float32)
    x = np.concatenate([near.astype(np.int32).view(np.float32), ends])
    np.testing.assert_array_equal(_port_bucket(x), np.asarray(xla(x)))
    # off the f32 range: XLA's int cast of the floor puts +inf in bucket 0
    # and NaN in bucket 4, and so does the port
    odd = np.array([np.inf, np.nan, -np.inf, -1.0], np.float32)
    np.testing.assert_array_equal(_port_bucket(odd), np.asarray(xla(odd)))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(serving_backoff_s=4.0, serving_backoff_mult=2.0,
         serving_backoff_cap_s=60.0, serving_max_retries=8),
    dict(serving_backoff_s=3.0, serving_backoff_mult=1.5,
         serving_backoff_cap_s=40.0, serving_max_retries=6),
])
def test_retry_backoff_table(kw):
    """The per-tier backoff table the port builds once per config equals
    the JAX package's ``retry_backoff`` over the tiers bit for bit."""
    rc, pc = rcfg.tiny_cluster(**kw), pcfg.tiny_cluster(**kw)
    tiers = np.arange(rc.serving_max_retries + 1)
    want = np.asarray(RS.retry_backoff(rc, jnp.asarray(tiers)))
    got = PS.serving_consts(pc, torch.device("cpu")).backoff.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PS.retry_backoff(pc, tiers).numpy(), want)


# ---------------------------------------------------------------- episodes
def test_request_conservation_under_overload():
    """``tests/test_serving.py``'s overload: every arrived request is
    queued, waiting out a backoff, in flight, completed, shed or dropped;
    every rung fires; state and telemetry against the JAX package's."""
    rc, pc, rst, rs, pst, ps = _pair(POOL)
    rf, rt = jax.jit(lambda s: R.run_episode(
        rc, rst, s, 900, "fcfs", summary_only=True))(rs)
    pf, pt = C.run_episode(pc, pst, ps, 900, "fcfs", summary_only=True)
    held = (float(pf.srv_queue.sum()) + float(pf.srv_retry_q.sum())
            + float(pf.srv_inflight))
    out = (float(pf.srv_completed) + float(pf.srv_shed)
           + float(pf.srv_dropped))
    np.testing.assert_allclose(held + out, float(pf.srv_arrived), rtol=1e-5,
                               atol=1e-2)
    for f in ("srv_shed", "srv_retried", "srv_dropped", "srv_completed"):
        assert float(getattr(pf, f)) > 0, f
    assert_state_close(rf, pf, "state")
    assert_tree_close(rt, pt, "telemetry")


def _per_tick_and_macro(rc, pc, rst, rs, pst, ps, n, scheduler="fcfs"):
    """The port's per-tick run against the JAX package's, and its macro
    run bitwise with its per-tick run. Returns the port's (final,
    telemetry, macro telemetry)."""
    rf, rt = jax.jit(lambda s: R.run_episode(
        rc, rst, s, n, scheduler, summary_only=True))(rs)
    pf, pt = C.run_episode(pc, pst, ps, n, scheduler, summary_only=True)
    assert_state_close(rf, pf, "state")
    assert_tree_close(rt, pt, "telemetry")
    mf, mt = C.run_episode(pc, pst, ps, n, scheduler, macro=True)
    for f in pf._fields:
        assert torch.equal(getattr(pf, f), getattr(mf, f)), f
    for f in pt._fields:
        if f != "macro_steps":
            assert torch.equal(getattr(pt, f), getattr(mt, f)), f
    return pf, pt, mt


def test_full_serving_stack_per_tick_and_macro():
    """``test_macro_full_serving_stack``'s case: diurnal traffic with a
    burst, admission control, shedding, timeout/backoff retries with
    drops and a wake in flight from the first tick, 1800 ticks of fcfs
    with jobs; the macro run still skips the quiet trough."""
    kw = dict(POOL, serving_wake_s=90.0)
    rc, pc, rst, rs, pst, ps = _pair(
        kw, n_jobs=24, seed=7, active=2.0,
        scenario_kw=dict(peak_rps=8.0, base_frac=0.05, burst_start_s=600.0,
                         burst_mult=4.0))
    pf, pt, mt = _per_tick_and_macro(rc, pc, rst, rs, pst, ps, 1800)
    for f in ("srv_shed", "srv_retried", "srv_dropped", "srv_completed"):
        assert float(getattr(pf, f)) > 0, f
    assert float(pf.srv_active) == kw["serving_nodes"]
    assert float(mt.macro_steps) < 0.85 * 1800


@pytest.mark.parametrize("other", ["thermal", "faults"])
def test_serving_with_other_models(other):
    """Serving beside the thermal twin (the pool rides the dynamic COP)
    and beside the fault engine with the ladder at THROTTLE (serving power
    joins after the ladder, before the cap), 600 ticks per tick against
    the JAX package's, and the port's macro run bitwise with its per
    tick."""
    if other == "thermal":
        kw = dict(POOL, thermal_enabled=True, rack_tau_s=60.0,
                  thermal_trip_c=26.0, throttle_start_c=24.0,
                  throttle_full_c=30.0)
    else:
        kw = dict(POOL, nodes_per_rack=4, node_mtbf_hours=0.3,
                  node_repair_hours=0.02, ckpt_interval_s=30.0,
                  degrade_enabled=True)
    rc, pc, rst, rs, pst, ps = _pair(kw, n_jobs=24, seed=3, active=2.0)
    if other == "faults":
        rs = rs._replace(degrade_level=jnp.int32(1))
        ps = ps._replace(degrade_level=torch.tensor(1, dtype=torch.int32))
    pf, _, _ = _per_tick_and_macro(rc, pc, rst, rs, pst, ps, 600)
    assert float(pf.srv_completed) > 0
    if other == "thermal":
        assert float(pf.thermal_throttle_s) > 0
    else:
        assert float(pf.n_killed) > 0


def test_fleet_of_four_matches_vmapped_reference():
    """Four replicas at peaks of 1, 4, 8 and 16 req/s (only the busier
    ones overload), 600 ticks of fcfs: the port's batched run against the
    JAX package's vmapped ``run_fleet``, field by field; per tick and
    macro bitwise."""
    rc, pc = rcfg.tiny_cluster(**POOL), pcfg.tiny_cluster(**POOL)
    jobs, bank = synth_workload(rc, 24, 600.0, seed=4)
    rst = R.build_statics(rc, bank)
    rs = R.load_jobs(R.init_state(rc, rst, jax.random.key(4)), jobs)
    rs = rs._replace(srv_active=jnp.float32(2.0))
    peaks = (1.0, 4.0, 8.0, 16.0)
    rf, rt = ref_run_fleet(rc, rst, rs, 600, "fcfs", scenarios=(
        RSC.stack_scenarios([_traffic(RSC, rc, peak_rps=p) for p in peaks])),
        summary_only=True)
    pst = C.build_statics(pc, bank, device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 4), jobs)
    ps = ps._replace(srv_active=torch.tensor(2.0))
    pscns = PSC.stack_scenarios([_traffic(PSC, pc, peak_rps=p)
                                 for p in peaks])
    pf, pt = run_fleet(pc, pst, ps, 600, "fcfs", scenarios=pscns,
                       summary_only=True)
    assert_state_close(rf, pf, "fleet")
    assert_tree_close(rt, pt, "fleet telemetry")
    shed = to_numpy(pf.srv_shed)
    assert shed[0] == 0.0 and shed[-1] > 0.0
    mf, _ = run_fleet(pc, pst, ps, 600, "fcfs", scenarios=pscns, macro=True)
    for f in pf._fields:
        assert torch.equal(getattr(pf, f), getattr(mf, f)), f


@pytest.mark.parametrize("macro", [False, True])
def test_env_serving_actions_and_features(macro):
    """``SchedEnv`` with serving on and the ladder schedulable, 4
    environments, a script through every dispatch index, the no-op, the
    five rungs and the four serving actions: observations (the serving
    block among them), rewards (with the SLO term), dones, the pool
    target and the admission threshold against the JAX package's env,
    step by step."""
    kw = dict(POOL, sched_max_candidates=4, degrade_enabled=True)
    rc, pc = rcfg.tiny_cluster(**kw), pcfg.tiny_cluster(**kw)
    wls = [synth_workload(rc, 24, 900.0, seed=s) for s in range(3)]
    env_kw = dict(episode_steps=8, sim_steps_per_action=5, macro=macro,
                  reward_weights=(1.0, 1.0, 1.0, 0.05, 0.0, 0.5, 5.0))
    ref = RefEnv(rc, wls, scenario=_traffic(RSC, rc), **env_kw)
    port = SchedEnv(pc, wls, scenario=_traffic(PSC, pc), device="cpu",
                    **env_kw)
    assert port.n_actions == ref.n_actions == port.k + 10
    assert port.obs_dim == ref.obs_dim
    keys = jax.random.split(jax.random.key(5), 4)
    rst, robs = jax.vmap(ref.reset)(keys)
    pst, pobs = port.reset(_words(keys))
    step = jax.jit(jax.vmap(ref.step))
    t = np.arange(8)[:, None]
    script = ((t + 3 * np.arange(4)[None, :]) % (port.k + 10)).astype(
        np.int32)
    assert set(script.ravel()) == set(range(port.k + 10))
    for i in range(8):
        rst, robs, rr, rd, _ = step(rst, jnp.asarray(script[i]))
        pst, pobs, pr, pd, _ = port.step(pst, torch.from_numpy(
            script[i]).long())
        np.testing.assert_allclose(to_numpy(pobs), np.asarray(robs),
                                   rtol=RTOL, atol=0.0, err_msg=f"obs {i}")
        np.testing.assert_allclose(to_numpy(pr), np.asarray(rr), rtol=RTOL,
                                   err_msg=f"reward {i}")
        np.testing.assert_array_equal(to_numpy(pd), np.asarray(rd))
        for f in ("srv_target", "srv_admit_thresh", "degrade_level"):
            np.testing.assert_array_equal(
                to_numpy(getattr(pst.sim, f)),
                np.asarray(getattr(rst.sim, f)), err_msg=f"{f} {i}")
    assert_state_close(rst.sim, pst.sim, "env sim")
    # the serving block follows the globals and the resilience block
    from repro_torch.envs.sched_env import RESILIENCE_FEATURES

    g0 = len(GLOBAL_FEATURES) + len(RESILIENCE_FEATURES)
    block = to_numpy(pobs)[:, g0:g0 + len(SERVING_FEATURES)]
    np.testing.assert_allclose(block[:, -1],
                               to_numpy(pst.sim.srv_admit_thresh))
    np.testing.assert_allclose(block[:, 3],
                               to_numpy(pst.sim.srv_active) / 4.0)


def test_scenario_through_interop_and_stacking():
    """A serving scenario built in the JAX package, carried across by
    ``scenario_from_numpy``: traffic, burst multiplier and burst edges as
    the JAX package evaluates them; ``stack_scenarios`` pads a shorter
    burst schedule and a shorter traffic trace as the JAX package's does,
    and ``SCENARIOS`` names the preset."""
    rc, pc = rcfg.tiny_cluster(**POOL), pcfg.tiny_cluster(**POOL)
    a = _traffic(RSC, rc)
    b = a._replace(
        traffic=ref_from_trace(np.linspace(1.0, 9.0, 7), 120.0),
        bursts=ref_burst_events([100.0, 500.0], [200.0, 900.0], [2.0, 0.5]))
    ts = np.arange(0.0, 1200.0, 7.0, dtype=np.float32)
    for scn in (a, b):
        got = interop.scenario_from_numpy(jax.device_get(scn), device="cpu")
        for f in ("traffic", "bursts"):
            assert_tree_close(getattr(scn, f), getattr(got, f), f)
        for t in ts:
            tt = jnp.float32(t)
            pt = torch.tensor(t)
            assert_close(ref_eval_signal(scn.traffic, tt),
                         eval_signal(got.traffic, pt), f"traffic {t}")
            assert float(burst_mult_at(got.bursts, pt)) == float(
                ref_burst_mult_at(scn.bursts, tt))
            assert float(next_burst_event(got.bursts, pt)) == float(
                ref_next_burst_event(scn.bursts, tt))
    want = RSC.stack_scenarios([a, b])
    pa = interop.scenario_from_numpy(jax.device_get(a), device="cpu")
    pb = interop.scenario_from_numpy(jax.device_get(b), device="cpu")
    assert_tree_close(want, PSC.stack_scenarios([pa, pb]), "stacked")
    assert PSC.SCENARIOS["diurnal_serving"] is PSC.diurnal_serving
    assert_tree_close(_traffic(RSC, rc), _traffic(PSC, pc), "preset")


def test_quiet_horizon_serving_terms():
    """``quiet_horizon`` with serving on: the crossing horizon joins the
    min and a queue over a threshold forces 0, as in the JAX package."""
    rc, pc, rst, rs, pst, ps = _pair(POOL, n_jobs=8, seed=2)
    for q in (0.0, 30.0, 70.0):
        rq = rs._replace(srv_queue=jnp.asarray([q, 0.0, 0.0], jnp.float32),
                         t=jnp.float32(100.0))
        pq = interop.state_from_numpy(ref_numpy(rq), device="cpu")
        for sched in ("fcfs", "none"):
            want = int(R.quiet_horizon(rc, rst, rq, sched,
                                       assume_undispatchable=True))
            got = int(C.quiet_horizon(pc, pst, pq, sched,
                                      assume_undispatchable=True))
            assert got == want, (q, sched)
        if q == 70.0:
            assert got == 0
