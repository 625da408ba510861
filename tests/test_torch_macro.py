"""Macro-stepping on the port: ``run_episode(macro=True)``,
``run_fleet(macro=True)`` and ``SchedEnv(macro=True)`` against the port's
own per-tick path and against the JAX package's macro path, the horizons
at probe states, the signal envelope and integrals, and the counted host
reads.

Inside the port, macro equals per-tick exactly: every ``SimState`` field
and every telemetry field but ``macro_steps`` (a fast tick runs the same
``power_tick`` and tail on the same inputs). Against the JAX package:
integers exact, floats to ``RTOL`` (``_torch_parity``), and on the
thermal-off cases the same number of event ticks (``macro_steps``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    RTOL,
    assert_state_close,
    assert_tree_close,
    make_pair,
    to_numpy,
)

import repro.configs.sim as rcfg
import repro.core as R
from repro import scenarios as RS
from repro.core import fleet as RF
from repro.core import placement as RPL
from repro.core import thermal as RT
from repro.data import synth_workload
from repro.envs import SchedEnv as RefEnv
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import scenarios as PS
from repro_torch.core import fleet as PF
from repro_torch.core import placement as PPL
from repro_torch.core import sim as PSIM
from repro_torch.core import thermal as PT
from repro_torch.envs import SchedEnv
from repro_torch.utils import device as PD

# racks ride the throttle ramp and cross the dispatch trip mid-episode
# (``tests/test_thermal.py``'s stress setting)
STRESS = dict(thermal_enabled=True, rack_tau_s=120.0, thermal_trip_c=22.0,
              throttle_start_c=20.0, throttle_full_c=30.0)


def _port_both(pc, pst, ps, n, scheduler, **kw):
    """The port's per-tick (summary_only) and macro episodes."""
    f1, t1 = C.run_episode(pc, pst, ps, n, scheduler, summary_only=True,
                           **kw)
    f2, t2 = C.run_episode(pc, pst, ps, n, scheduler, macro=True, **kw)
    return f1, t1, f2, t2


def _assert_bitwise(a, b, tag, skip=("macro_steps",)):
    """Two port NamedTuples field by field, bitwise (``None`` alike)."""
    for f in a._fields:
        if f in skip:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f"{tag}.{f}"
            continue
        assert torch.equal(x, y), f"{tag}.{f} differs from per-tick"


def _ref_macro(rc, rst, rs, n, scheduler, **kw):
    return jax.jit(lambda s: R.run_episode(rc, rst, s, n, scheduler,
                                           macro=True, **kw))(rs)


def _check_case(rc, pc, pair, n, scheduler, *, same_segments=True, **kw):
    """Port macro against port per-tick (bitwise) and against the JAX
    package's macro path; returns the port's (state, telemetry) and the
    reference's telemetry."""
    rst, rs, pst, ps, _, _ = pair
    f1, t1, f2, t2 = _port_both(pc, pst, ps, n, scheduler, **kw)
    _assert_bitwise(f1, f2, "state", skip=())
    _assert_bitwise(t1, t2, "telemetry")
    assert float(t2.n_steps) == n
    assert float(t2.macro_steps) < n            # the engine fast-forwards
    rf, rt = _ref_macro(rc, rst, rs, n, scheduler, **kw)
    assert_state_close(rf, f2, "state vs JAX macro")
    assert_tree_close(rt, t2, "telemetry vs JAX macro", skip=("macro_steps",))
    if same_segments:
        assert float(t2.macro_steps) == float(rt.macro_steps)
    return f2, t2, rt


def test_tiny_fcfs_macro_equals_per_tick_and_reference():
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    pair = make_pair(rc, pc, 32, 900.0, seed=0)
    final, telem, _ = _check_case(rc, pc, pair, 900, "fcfs")
    s = C.summary(final, telem)
    assert s["ticks_simulated"] == 900 and s["macro_skip_ratio"] > 4.0


def test_tx_gaia_slice_replay():
    """TX-GAIA's nodes with a 64 x 4 job table, replay for 600 ticks: the
    JAX package takes its chunked count-matrix power path here, the port
    its per-tick ``power_tick``."""
    kw = dict(max_jobs=64, max_nodes_per_job=4)
    rc, pc = rcfg.tx_gaia(**kw), pcfg.tx_gaia(**kw)
    pair = make_pair(rc, pc, 30, 600.0, seed=5)
    final, _, _ = _check_case(rc, pc, pair, 600, "replay")
    assert float(final.n_completed) > 0


def test_demand_response_cap_crossing():
    """A cap window opens and closes inside the episode: the segments stop
    at both edges and the throttle accounting stays exact."""
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    jobs, bank = synth_workload(rc, 32, 900.0, seed=1)
    dr = dict(cap_w=4000.0, event_start_s=200.0, event_len_s=300.0)
    rst = R.build_statics(rc, bank, scenario=RS.demand_response(rc, **dr))
    rs = R.load_jobs(R.init_state(rc, rst, jax.random.key(0)), jobs)
    pst = C.build_statics(pc, bank, scenario=PS.demand_response(pc, **dr),
                          device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 0), jobs)
    _, telem, _ = _check_case(rc, pc, (rst, rs, pst, ps, jobs, bank), 900,
                              "fcfs")
    assert float(telem.mean_throttle) < 1.0


def test_thermal_trip_crossing():
    """Racks cross the dispatch trip mid-episode: the segments end at the
    crossings and the thermal horizon caps them. The event-tick count is
    the JAX package's wherever the horizon's float inputs agree; it is
    held to the reference's within a few ticks here. (EASY under the same
    trip: the fleet case below.)"""
    rc, pc = rcfg.tiny_cluster(**STRESS), pcfg.tiny_cluster(**STRESS)
    pair = make_pair(rc, pc, 24, 600.0, seed=8)
    final, telem, rt = _check_case(rc, pc, pair, 900, "fcfs",
                                   same_segments=False)
    assert float(final.peak_rack_c) >= pc.thermal_trip_c
    assert float(final.thermal_throttle_s) > 0.0
    assert abs(float(telem.macro_steps) - float(rt.macro_steps)) <= 3


def test_windowed_telemetry_stays_tick_aligned():
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = make_pair(rc, pc, 24, 900.0, seed=4)
    f1, w1 = C.run_episode(pc, pst, ps, 600, "fcfs", telemetry_every=60)
    f2, w2 = C.run_episode(pc, pst, ps, 600, "fcfs", telemetry_every=60,
                           macro=True)
    assert tuple(w2.n_steps.shape) == (10,)
    assert torch.equal(w2.n_steps, torch.full((10,), 60.0))
    _assert_bitwise(f1, f2, "state", skip=())
    _assert_bitwise(w1, w2, "windows")
    rf, rw = _ref_macro(rc, rst, rs, 600, "fcfs", telemetry_every=60)
    assert_state_close(rf, f2, "state vs JAX macro")
    assert_tree_close(rw, w2, "windows vs JAX macro")
    s = C.summary(f2, w2)
    assert s["macro_steps_taken"] == float(w2.macro_steps.sum())


def test_stacked_stepout_summarises_and_refusals():
    """``macro=True`` cannot stack per-tick ``StepOut``: it returns the
    episode-wide summary, as the JAX package does; ``summary_only`` with
    windows still raises."""
    pc = pcfg.tiny_cluster()
    _, _, pst, ps, _, _ = make_pair(rcfg.tiny_cluster(), pc, 8, 300.0,
                                    seed=0)
    _, out = C.run_episode(pc, pst, ps, 50, "fcfs", macro=True)
    assert isinstance(out, C.TelemetrySummary)
    assert float(out.n_steps) == 50
    with pytest.raises(ValueError):
        C.run_episode(pc, pst, ps, 50, "fcfs", macro=True,
                      summary_only=True, telemetry_every=10)


# ------------------------------------------------------------ horizons
def _probe(rc, pc, seed, warm, n_jobs=24, horizon=900.0):
    """Both packages advanced per tick to a (likely mid-segment) state."""
    rst, rs, pst, ps, _, _ = make_pair(rc, pc, n_jobs, horizon, seed=seed)
    if warm:
        rs = jax.jit(lambda s: R.run_episode(rc, rst, s, warm, "fcfs",
                                             summary_only=True))(rs)[0]
        ps = C.run_episode(pc, pst, ps, warm, "fcfs", summary_only=True)[0]
    return rst, rs, pst, ps


@pytest.mark.parametrize("seed,warm", [(0, 0), (1, 50), (2, 120), (5, 77)])
def test_quiet_horizon_matches_reference_and_never_overshoots(seed, warm):
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps = _probe(rc, pc, seed, warm)
    for sched in ("fcfs", "replay", "none"):
        for assume in (False, True):
            want = int(R.quiet_horizon(rc, rst, rs, sched, max_ticks=256,
                                       assume_undispatchable=assume))
            got = PSIM.quiet_horizon(pc, pst, ps, sched, max_ticks=256,
                                     assume_undispatchable=assume)
            assert got.dtype == torch.int32 and int(got) == want, (sched,
                                                                   assume)
    # advancing the predicted horizon per tick changes no machine state
    k = int(PSIM.quiet_horizon(pc, pst, ps, "fcfs", max_ticks=256))
    after = C.run_episode(pc, pst, ps, k, "fcfs", summary_only=True)[0]
    for f in ("jstate", "placement", "free", "node_up", "n_completed"):
        assert torch.equal(getattr(ps, f), getattr(after, f)), f


def test_quiet_horizon_visible_queue_blocks():
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    jobs, bank = synth_workload(rc, 8, 100.0, seed=0)
    jobs["submit_t"][:] = 0.0
    pst = C.build_statics(pc, bank, device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 0), jobs)
    ps = ps._replace(t=torch.tensor(1.0))
    assert int(PSIM.quiet_horizon(pc, pst, ps, "fcfs")) == 0
    assert int(PSIM.quiet_horizon(pc, pst, ps, "fcfs",
                                  assume_undispatchable=True)) > 0
    assert int(PSIM.quiet_horizon(pc, pst, ps, "none")) > 0


@pytest.mark.parametrize("seed,warm", [(8, 0), (8, 200), (3, 450)])
def test_thermal_crossing_horizon_at_probe_states(seed, warm):
    rc, pc = rcfg.tiny_cluster(**STRESS), pcfg.tiny_cluster(**STRESS)
    rst, rs, pst, ps = _probe(rc, pc, seed, warm, horizon=600.0)
    want = int(RT.thermal_crossing_horizon(rc, rst, rs, 256))
    got = PT.thermal_crossing_horizon(pc, pst, ps, 256)
    assert got.dtype == torch.int32
    # the box's float inputs (rack temperatures) agree to ~1e-6
    assert abs(int(got) - want) <= 1
    # a batched state: one horizon per replica, each its own
    both = C.broadcast_state(ps, 2)
    assert PT.thermal_crossing_horizon(pc, pst, both, 256).tolist() == [
        int(got)] * 2
    # no rack crosses the trip inside the horizon
    k = int(got)
    hot0 = ps.rack_outlet_c >= pc.thermal_trip_c
    step = C.make_step(pc, pst, "fcfs")
    s = ps
    for _ in range(k):
        s, _ = step(s, -1)
        assert torch.equal(s.rack_outlet_c >= pc.thermal_trip_c, hot0)


# ------------------------------------------------------------- signals
def _signal_pairs():
    """(reference Signal, port Signal) of each family: a noisy sinusoid,
    a plain one, a trace, and a one-sample trace."""
    rng = np.random.default_rng(0)
    vals = rng.uniform(150.0, 450.0, 17).astype(np.float32)
    specs = [("sinusoid", (300.0, 80.0, 7200.0, 0.3),
              dict(noise_amp=12.0, noise_seed=1.7)),
             ("sinusoid", (0.12, 0.03, 86_400.0, -1.0), {}),
             ("from_trace", (vals, 300.0, 120.0), {}),
             ("from_trace", (vals[:1], 60.0), {})]
    return [(getattr(RS, n)(*a, **k), getattr(PS, n)(*a, **k))
            for n, a, k in specs]


def test_signal_bounds_integrals_and_means():
    t0 = np.array([-500.0, 0.0, 1234.5, 4000.0, 9000.0], np.float32)
    t1 = np.array([700.0, 0.0, 2000.0, 3000.0, 20_000.0], np.float32)
    for i, (rsig, psig) in enumerate(_signal_pairs()):
        lo, hi = PS.signal_bounds(psig)
        rlo, rhi = RS.signal_bounds(rsig)
        np.testing.assert_allclose([float(lo), float(hi)],
                                   [float(rlo), float(rhi)], rtol=RTOL)
        ts = torch.linspace(-1000.0, 30_000.0, 301)
        v = PS.eval_signal(psig, ts)
        assert float(v.min()) >= float(lo) - 1e-4 * abs(float(lo))
        assert float(v.max()) <= float(hi) + 1e-4 * abs(float(hi))
        for a, b in zip(t0, t1):
            want = float(RS.integrate_signal(rsig, a, b))
            got = float(PS.integrate_signal(psig, a, b))
            np.testing.assert_allclose(got, want, rtol=2e-5,
                                       atol=1e-3 * max(abs(b - a), 1.0),
                                       err_msg=f"signal {i} [{a}, {b}]")
            np.testing.assert_allclose(
                float(PS.mean_signal(psig, a, b)),
                float(RS.mean_signal(rsig, a, b)), rtol=2e-5, atol=1e-3,
                err_msg=f"signal {i} mean [{a}, {b}]")
    # a stacked (batched) signal: one bound and one integral per replica
    pair = _signal_pairs()[:2]
    stacked = PS.Signal(*(torch.stack([pair[0][1][f], pair[1][1][f]])
                          for f in range(len(PS.Signal._fields))))
    lo, hi = PS.signal_bounds(stacked)
    assert tuple(lo.shape) == (2,)
    assert [float(x) for x in hi] == [float(PS.signal_bounds(p)[1])
                                      for _, p in pair]
    got = PS.integrate_signal(stacked, torch.tensor([0.0, 100.0]),
                              torch.tensor([600.0, 900.0]))
    np.testing.assert_allclose(
        got.numpy(), [float(RS.integrate_signal(pair[0][0], 0.0, 600.0)),
                      float(RS.integrate_signal(pair[1][0], 100.0, 900.0))],
        rtol=2e-5)


def test_to_trace_samples_the_signal():
    rsig, psig = _signal_pairs()[0]
    tr = PS.to_trace(psig, 3600.0, 60.0)
    rtr = RS.to_trace(rsig, 3600.0, 60.0)
    assert float(tr.use_trace) == 1.0 and tr.values.shape == (61,)
    np.testing.assert_allclose(tr.values.numpy(), np.asarray(rtr.values),
                               rtol=RTOL)
    assert math.isclose(float(PS.eval_signal(tr, torch.tensor(90.0))),
                        float(0.5 * (tr.values[1] + tr.values[2])),
                        rel_tol=1e-6)


# --------------------------------------------------------------- fleet
def test_macro_fleet_replicas_equal_themselves_alone_and_reference():
    """E = 6 (two policies x three scenarios, with a binding
    demand-response cap and a thermal trip): the batched macro run equals
    each replica run alone and the JAX package's vmapped macro fleet."""
    rc, pc = rcfg.tiny_cluster(**STRESS), pcfg.tiny_cluster(**STRESS)
    rst, rs, pst, ps, _, _ = make_pair(rc, pc, 24, 600.0, seed=0,
                                       mean_dur_s=150.0)

    def scns(S, cfg):
        return [S.default_scenario(cfg), S.carbon_trace(
            cfg, np.linspace(200.0, 520.0, 9), 120.0),
            S.demand_response(cfg, cap_w=0.25 * cfg.nameplate_it_w,
                              event_start_s=100.0, event_len_s=400.0)]

    rpol = RPL.policy_grid(("fcfs", "easy"), ("first_fit",))[1]
    ppol = PPL.policy_grid(("fcfs", "easy"), ("first_fit",))[1]
    rp, rsc = RF.policy_scenario_grid(rpol, scns(RS, rc))
    pp, psc = PF.policy_scenario_grid(ppol, scns(PS, pc))
    f1, t1 = PF.run_fleet(pc, pst, ps, 300, policies=pp, scenarios=psc,
                          summary_only=True)
    f2, t2 = PF.run_fleet(pc, pst, ps, 300, policies=pp, scenarios=psc,
                          macro=True)
    _assert_bitwise(f1, f2, "fleet state", skip=())
    _assert_bitwise(t1, t2, "fleet telemetry")
    # the replicas segment apart: lockstep leaves them at different t
    assert len(set(t2.macro_steps.tolist())) > 1
    rf, rt = RF.run_fleet(rc, rst, rs, 300, policies=rp, scenarios=rsc,
                          summary_only=True, macro=True)
    assert_state_close(rf, f2, "fleet state vs JAX")
    assert_tree_close(rt, t2, "fleet telemetry vs JAX", skip=("macro_steps",))
    np.testing.assert_array_equal(t2.macro_steps.numpy(),
                                  np.asarray(rt.macro_steps))
    scn_list = PF._scenario_list(psc)
    for e in range(6):
        st = pst._replace(scenario=scn_list[e])
        pol = PPL.Policy(pp.select[e], pp.place[e])
        fa, ta = C.run_episode(pc, st, ps._replace(key=f2.key[e]), 300, pol,
                               macro=True)
        _assert_bitwise(fa, type(f2)(*(v[e] for v in f2)), f"alone {e}",
                        skip=())
        _assert_bitwise(ta, type(t2)(*(v[e] for v in t2)), f"alone {e}",
                        skip=())


def test_batched_replicas_at_different_times():
    """Replicas that start at different ``t`` step as each alone."""
    pc = pcfg.tiny_cluster()
    _, _, pst, ps, _, _ = make_pair(rcfg.tiny_cluster(), pc, 24, 600.0,
                                    seed=2, mean_dur_s=150.0)
    ahead = C.run_episode(pc, pst, ps, 137, "fcfs", summary_only=True)[0]
    both = type(ps)(*(torch.stack([a, b]) for a, b in zip(ps, ahead)))
    fleet_st = pst._replace(scenario=PS.stack_scenarios([pst.scenario] * 2))
    fb, tb = C.run_episode(pc, fleet_st, both, 250, "fcfs", macro=True)
    for e, s0 in enumerate((ps, ahead)):
        fa, ta = C.run_episode(pc, pst, s0, 250, "fcfs", macro=True)
        _assert_bitwise(fa, type(fb)(*(v[e] for v in fb)), f"replica {e}",
                        skip=())
        _assert_bitwise(ta, type(tb)(*(v[e] for v in tb)), f"replica {e}",
                        skip=())


# ------------------------------------------------------------ SchedEnv
def test_sched_env_macro_matches_reference_and_per_tick():
    """``SchedEnv`` defaults to ``macro=True``; four environments of it
    against ``jax.vmap`` of the JAX package's macro env and against the
    port's ``macro=False`` (bitwise), over a scripted episode."""
    rc = rcfg.tiny_cluster(sched_max_candidates=4)
    pc = pcfg.tiny_cluster(sched_max_candidates=4)
    wls = [synth_workload(rc, 24, 900.0, seed=s) for s in range(2)]
    kw = dict(episode_steps=8, sim_steps_per_action=7)
    ref = RefEnv(rc, wls, **kw)
    port = SchedEnv(pc, wls, device="cpu", **kw)
    oracle = SchedEnv(pc, wls, device="cpu", macro=False, **kw)
    assert port.macro and ref.macro and not oracle.macro
    keys = jax.random.split(jax.random.key(3), 4)
    words = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
        np.int64))
    rs, _ = jax.jit(jax.vmap(ref.reset))(keys)
    st, _ = port.reset(words)
    so, _ = oracle.reset(words)
    step = jax.jit(jax.vmap(ref.step))
    PD.reset_host_reads()
    PSIM.reset_macro_ticks()
    for t in range(8):
        a = (np.arange(4) + t) % 5
        rs, robs, rr, rd, ri = step(rs, jnp.asarray(a, jnp.int32))
        st, obs, r, d, info = port.step(st, torch.from_numpy(a))
        so, oobs, orr, od, oinfo = oracle.step(so, torch.from_numpy(a))
        for x, y in ((obs, oobs), (r, orr), (d, od)):
            assert torch.equal(x, y), f"step {t}: macro vs per-tick"
        for f in info:
            assert torch.equal(info[f], oinfo[f]), f"step {t} info.{f}"
            np.testing.assert_allclose(to_numpy(info[f]), np.asarray(ri[f]),
                                       rtol=RTOL, err_msg=f"info.{f}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(robs), rtol=RTOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=RTOL)
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    _assert_bitwise(so.sim, st.sim, "env sim", skip=())
    assert_state_close(rs.sim, st.sim, "env sim vs JAX")
    # the idle ticks were fast-forwarded, through counted reads only
    assert PSIM.MACRO_TICKS["fast"] > 0
    assert PSIM.MACRO_TICKS["event"] < 8 * 6
    assert PD.HOST_READS["count"] >= PSIM.MACRO_TICKS["event"]


# --------------------------------------------------- the counted reads
def test_host_reads_are_counted_and_bounded():
    """Every read goes through ``utils.device.host_read``: per macro step
    one after the event tick and one per chunk of fast ticks, so at most
    1 + ceil(segment / chunk_ticks); the per-tick path reads nothing."""
    pc = pcfg.tiny_cluster()
    _, _, pst, ps, _, _ = make_pair(rcfg.tiny_cluster(), pc, 32, 900.0,
                                    seed=0)
    PD.reset_host_reads()
    C.run_episode(pc, pst, ps, 200, "fcfs", summary_only=True)
    assert PD.HOST_READS["count"] == 0
    got = PD.host_read(torch.arange(3))
    assert isinstance(got, np.ndarray) and PD.HOST_READS["count"] == 1
    for chunk in (4, 16):
        PD.reset_host_reads()
        PSIM.reset_macro_ticks()
        _, telem = C.run_episode(pc, pst, ps, 600, "fcfs", macro=True,
                                 chunk_ticks=chunk)
        events, fast = PSIM.MACRO_TICKS["event"], PSIM.MACRO_TICKS["fast"]
        assert events == float(telem.macro_steps)
        # one replica: every issued fast tick is committed but the last
        # of a segment that stopped early
        assert 600 - events <= fast
        reads = PD.HOST_READS["count"]
        assert events <= reads <= events + math.ceil(fast / chunk) + events
    # a macro step alone: ticks = 1 event tick + its segment
    ms = PSIM.make_macro_step(pc, pst, "fcfs")
    acc = PSIM._telem_zero(torch.device("cpu"))
    _, acc, ticks = ms(ps, acc, 50)
    assert int(ticks) == float(acc.n_steps) and 1 <= int(ticks) <= 50
    assert float(acc.macro_steps) == 1.0


# ------------------------------------------------------------- the pins
@pytest.mark.parametrize("case", ["replay_tx_gaia_1h_macro",
                                  "replay_tx_gaia_1h_thermal_stress_macro"])
def test_macro_pins_are_a_live_reference_run(case):
    """``PINNED_MACRO`` is what the JAX package's macro hour gives now
    (``tests/torch_macro_pins.py`` made it), held by
    ``acceptance.check`` as the card's run is."""
    from repro_torch.configs import acceptance as A

    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       **A.CASES[A.base_case(case)])
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    fs, tel = jax.jit(lambda s: R.run_episode(
        cfg, st, s, A.N_STEPS, A.SCHEDULER, macro=True))(s)
    got = R.summary(fs, tel)
    A.check(case, got)
    assert got["macro_steps_taken"] == A.PINNED_MACRO[case][
        "macro_steps_taken"]
    # a miss is refused: one event tick more, one completion less
    for k, d in (("macro_steps_taken", 1.0), ("completed", -1.0)):
        if k == "macro_steps_taken" and cfg.thermal_enabled:
            continue      # reported, not held, with thermals on
        with pytest.raises(AssertionError, match=k):
            A.check(case, {**got, k: got[k] + d})
