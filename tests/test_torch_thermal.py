"""The port's rack thermal twin against the JAX package.

- the ``rack_thermal`` kernel's plain version against the reference's
  oracle ``ref.rack_thermal_ref`` and its Pallas kernel (interpret mode,
  as the reference's own tests run it), and a float64 numpy trajectory;
- every function of ``core/thermal.py`` against its JAX counterpart;
- the thermal step on a stress-tuned ``tiny_cluster`` whose racks ride the
  throttle ramp and cross the dispatch trip, field by field;
- the single-replica scenario presets and ``data/grid_signals.py``.

Integers match exactly, floats to ``rtol=1e-5`` (the one-hot ``jnp.dot``
of the reference sums rack heat in another order than the port), job
progress as work done (``_torch_parity.assert_state_close``). The CUDA
kernel runs only on the card:
``test_torch_kernels_cuda.py`` holds it against this plain version there.
"""

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
)

import repro.configs.sim as rcfg
import repro.core as R
import repro.core.thermal as RT
from repro.kernels import ops as kops
from repro.kernels.ref import rack_thermal_ref
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
import repro_torch.core.thermal as PT
from repro_torch import interop, kernels
from repro_torch.kernels import rack_thermal as prt

# racks ride the throttle ramp AND cross the dispatch trip inside a short
# episode (the reference's tests/test_thermal.py stress config)
_STRESS = dict(thermal_enabled=True, rack_tau_s=120.0, thermal_trip_c=22.0,
               throttle_start_c=20.0, throttle_full_c=30.0)


def _rand_case(rng, n, r, E):
    heat = (rng.random((E, n), dtype=np.float32) * 800.0).astype(np.float32)
    rack = rng.integers(0, r, n).astype(np.int32)
    t0 = (18.0 + rng.random((E, r)) * 10.0).astype(np.float32)
    sup = (14.0 + rng.random(E) * 6.0).astype(np.float32)
    r_th = (rng.random(r) * 1e-3 + 1e-4).astype(np.float32)
    return heat, rack, t0, sup, r_th


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("n,r", [(16, 1), (100, 7), (672, 21)])
def test_plain_matches_ref_oracle_and_pallas_kernel(n, r, E):
    rng = np.random.default_rng(n * 31 + r + E)
    heat, rack, t0, sup, r_th = _rand_case(rng, n, r, E)
    alpha = 0.117
    got_t, got_h = prt.rack_thermal_torch(*_t(heat, rack, t0, sup, r_th),
                                          alpha=alpha)
    assert got_t.shape == got_h.shape == (E, r)
    assert got_t.dtype == got_h.dtype == torch.float32
    for e in range(E):
        args = (heat[e], rack, t0[e], jnp.float32(sup[e]), r_th)
        for name, fn in (("rack_thermal_ref", rack_thermal_ref),
                         ("rack_thermal_pallas", kops.rack_thermal)):
            want_t, want_h = jax.jit(
                lambda *a, fn=fn: fn(*a, alpha=alpha))(*args)
            np.testing.assert_allclose(got_t[e].numpy(), np.asarray(want_t),
                                       rtol=RTOL, err_msg=f"T vs {name}")
            np.testing.assert_allclose(got_h[e].numpy(), np.asarray(want_h),
                                       rtol=RTOL, err_msg=f"heat vs {name}")


def test_plain_tracks_float64_numpy_trajectory():
    """The float64 oracle of the reference's thermal suite (np.add.at
    scatter, then the explicit RC step), over 200 ticks: the RC update is
    a contraction, so f32 drift stays at the documented tolerance."""
    rng = np.random.default_rng(11)
    n, r, ticks, alpha = 64, 4, 200, 0.035
    _, rack, t0, _, r_th = _rand_case(rng, n, r, 1)
    heat_seq = rng.random((ticks, n), dtype=np.float32) * 600.0
    sup_seq = (16.0 + 4.0 * np.sin(np.arange(ticks) / 30.0)).astype(np.float32)
    T64 = t0[0].astype(np.float64)
    T = torch.tensor(t0)
    for heat, sup in zip(heat_seq, sup_seq):
        rack_heat = np.zeros(r, np.float64)
        np.add.at(rack_heat, rack, heat.astype(np.float64))
        T64 = T64 + alpha * (sup + rack_heat * r_th.astype(np.float64) - T64)
        T, _ = prt.rack_thermal(*_t(heat[None], rack), T,
                                torch.tensor([sup]), torch.tensor(r_th),
                                alpha=alpha)
        np.testing.assert_allclose(T[0].numpy(), T64, rtol=1e-5, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version_per_replica():
    rng = np.random.default_rng(3)
    args = _t(*_rand_case(rng, 100, 7, 4))
    before = dict(kernels.LAUNCHES)
    got = prt.rack_thermal(*args, alpha=0.2)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing
    want = prt.rack_thermal_torch(*args, alpha=0.2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    heat, rack, t0, sup, r_th = args
    for e in range(4):
        one = prt.rack_thermal(heat[e:e + 1], rack, t0[e:e + 1],
                               sup[e:e + 1], r_th, alpha=0.2)
        for g, w in zip(got, one):
            assert torch.equal(g[e:e + 1], w)


@pytest.mark.parametrize("broken", ["rack_dtype", "heat_dtype", "heat_shape",
                                    "outlet_shape", "supply_shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(broken):
    rng = np.random.default_rng(4)
    t = list(_t(*_rand_case(rng, 16, 2, 2)))
    err = ValueError
    if broken == "rack_dtype":
        t[1], err = t[1].long(), TypeError
    elif broken == "heat_dtype":
        t[0], err = t[0].double(), TypeError
    elif broken == "heat_shape":
        t[0] = t[0][:, :-1]
    elif broken == "outlet_shape":
        t[2] = t[2][0]
    elif broken == "supply_shape":
        t[3] = t[3][:1]
    else:
        # no kernel and no fallback off the CPU: a tensor elsewhere raises
        t = [a.to("meta") for a in t]
    with pytest.raises(err):
        prt.rack_thermal(*t, alpha=0.1)


# ------------------------------------------------- core/thermal.py
@pytest.fixture(scope="module")
def hot_pair():
    """A reference mid-episode state of the stress config (racks past the
    trip, jobs placed), carried to the port by interop."""
    rc, pc = rcfg.tiny_cluster(**_STRESS), pcfg.tiny_cluster(**_STRESS)
    rst, rs, _, _, _, _ = make_pair(rc, pc, 24, 600.0, seed=8)
    rs, _ = jax.jit(lambda s: R.run_episode(rc, rst, s, 400, "fcfs"))(rs)
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    ps = interop.state_from_numpy(ref_numpy(rs), device="cpu")
    return rc, pc, rst, rs, pst, ps


def test_thermal_alpha_and_signals_match_reference():
    for kw in ({}, _STRESS, dict(rack_tau_s=1e-9), dict(dt=5.0)):
        assert PT.thermal_alpha(pcfg.tx_gaia(**kw)) == RT.thermal_alpha(
            rcfg.tx_gaia(**kw))
    rc, pc = rcfg.tiny_cluster(**_STRESS), pcfg.tiny_cluster(**_STRESS)
    rng = np.random.default_rng(5)
    wb = (rng.random(64) * 40.0 - 5.0).astype(np.float32)
    load = (rng.random(64) * 1.4).astype(np.float32)
    temps = (rng.random(64) * 60.0 + 5.0).astype(np.float32)
    pairs = [
        (PT.supply_temp(pc, torch.tensor(wb)), RT.supply_temp(rc, wb)),
        (PT.cooling_cop(pc, torch.tensor(wb), torch.tensor(load)),
         RT.cooling_cop(rc, wb, load)),
        (PT.rack_throttle(pc, torch.tensor(temps)),
         RT.rack_throttle(rc, temps)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_state_functions_match_reference_mid_episode(hot_pair):
    rc, pc, rst, rs, pst, ps = hot_pair
    assert float(ps.rack_outlet_c.max()) >= rc.thermal_trip_c
    assert int((ps.placement >= 0).sum()) > 0
    np.testing.assert_array_equal(
        PT.node_trip_ok(pc, ps, pst).numpy(),
        np.asarray(RT.node_trip_ok(rc, rs, rst)))
    th_r = PT.rack_throttle(pc, ps.rack_outlet_c)
    assert float(th_r.min()) < 1.0
    node_th = th_r[pst.node_rack.long()]
    rnode_th = RT.rack_throttle(rc, rs.rack_outlet_c)[rst.node_rack]
    np.testing.assert_allclose(
        PT.job_thermal_rate(ps, pst, node_th).numpy(),
        np.asarray(RT.job_thermal_rate(rs, rst, rnode_th)), rtol=RTOL)
    heat = np.random.default_rng(6).random(pc.n_nodes, np.float32) * 900.0
    sup = jnp.float32(21.5)
    got = PT.rack_thermal_update(pc, pst, ps.rack_outlet_c,
                                 torch.tensor(heat), torch.tensor(21.5))
    want = RT.rack_thermal_update(rc, rst, rs.rack_outlet_c, heat, sup)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


# ------------------------------------------------------- the thermal step
@pytest.fixture(scope="module")
def stress_pair():
    return make_pair(rcfg.tiny_cluster(**_STRESS),
                     pcfg.tiny_cluster(**_STRESS), 24, 600.0, seed=8)


def _assert_trip_and_throttle(cfg, fs):
    assert float(fs.peak_rack_c) >= cfg.thermal_trip_c   # trip crossed
    assert float(fs.thermal_throttle_s) > 0.0           # throttle fired


@pytest.mark.parametrize("sel,place", [("fcfs", "first_fit"),
                                       ("easy", "first_fit"),
                                       ("easy", "partition")])
def test_stress_episode_matches_reference(stress_pair, sel, place):
    rc, pc = rcfg.tiny_cluster(**_STRESS), pcfg.tiny_cluster(**_STRESS)
    rst, rs, pst, ps, _, _ = stress_pair
    rf, rt = jax.jit(lambda s: R.run_episode(
        rc, rst, s, 1500, sel, placement=place, summary_only=True))(rs)
    pf, pt = C.run_episode(pc, pst, ps, 1500, sel, placement=place,
                           summary_only=True)
    _assert_trip_and_throttle(rc, ref_numpy(rf))
    _assert_trip_and_throttle(pc, pf)
    assert float(pf.n_completed) > 0
    tag = f"{sel}+{place}"
    assert_state_close(rf, pf, tag)
    assert_tree_close(rt, pt, f"{tag}.telemetry")
    assert_summary_close(R.summary(rf, rt), C.summary(pf, pt), tag)


def test_rl_step_with_thermals_follows_scripted_actions(stress_pair):
    """make_step(..., "rl") per tick with thermals on: every StepOut field
    (rack_max_c, cop, thermal_throttle_s_step included) and the candidate
    list, tick by tick."""
    rc, pc = rcfg.tiny_cluster(**_STRESS), pcfg.tiny_cluster(**_STRESS)
    rst, rs, pst, ps, _, _ = stress_pair
    k = rc.sched_max_candidates
    actions = [0, 1, k, 2, 0, 3, k, 1] * 40
    rstep = jax.jit(R.make_step(rc, rst, "rl", placement="spread"))
    pstep = C.make_step(pc, pst, "rl", placement="spread")
    for i, a in enumerate(actions):
        rs, ro = rstep(rs, jnp.int32(a))
        ps, po = pstep(ps, a)
        assert_tree_close(ro, po, f"tick {i} stepout")
        np.testing.assert_array_equal(
            np.asarray(R.schedulers.rl_candidates(rc, rs)),
            C.schedulers.rl_candidates(pc, ps).numpy(), err_msg=f"tick {i}")
    assert_state_close(rs, ps, "final state")
    _assert_trip_and_throttle(pc, ps)


def test_none_scheduler_runs_the_hot_clock(hot_pair):
    """No dispatch from a hot mid-episode state: the running jobs go on
    under the throttle and the racks' RC loop, as in the reference."""
    rc, pc, rst, rs, pst, ps = hot_pair
    rf, ro = jax.jit(lambda s: R.run_episode(rc, rst, s, 300, "none"))(rs)
    pf, po = C.run_episode(pc, pst, ps, 300, "none")
    assert_state_close(rf, pf, "state")
    assert_tree_close(ro, po, "stepout")
    assert float(po.thermal_throttle_s_step.sum()) > 0.0
    assert torch.equal(pf.start_t, ps.start_t)      # nothing started


def test_heatwave_scenario_episode_matches_reference():
    """The thermal twin under the ``thermal_stress`` preset's weather and
    demand-response cap, shifted onto the episode (both packages build
    the scenario themselves)."""
    from repro.scenarios import scenario as RS
    from repro_torch.scenarios import scenario as PS

    kw = dict(thermal_enabled=True, throttle_start_c=26.0,
              throttle_full_c=36.0, thermal_trip_c=28.0, rack_tau_s=120.0)
    rc, pc = rcfg.tiny_cluster(**kw), pcfg.tiny_cluster(**kw)
    sc = dict(delta_c=12.0, cap_frac=0.5, event_start_s=200.0,
              event_len_s=300.0)
    jobs_pair = make_pair(rc, pc, 24, 600.0, seed=2)
    jobs, bank = jobs_pair[4], jobs_pair[5]
    rst = R.build_statics(rc, bank, RS.thermal_stress(rc, **sc))
    rs = R.load_jobs(R.init_state(rc, rst, jax.random.key(2)), jobs)
    pst = C.build_statics(pc, bank, PS.thermal_stress(pc, **sc), device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 2), jobs)
    rf, ro = jax.jit(lambda s: R.run_episode(rc, rst, s, 600, "fcfs"))(rs)
    pf, po = C.run_episode(pc, pst, ps, 600, "fcfs")
    assert float(po.power_cap_w.max()) > 0.0
    _assert_trip_and_throttle(pc, pf)
    assert_state_close(rf, pf, "state")
    assert_tree_close(ro, po, "stepout")


# ------------------------------------------- presets and grid signals
def _assert_leaves_equal(ref, got, tag):
    """Every field of the port's NamedTuple equals the reference's field
    of the same name, bitwise (the reference may carry more fields)."""
    for f in got._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if hasattr(g, "_fields"):
            _assert_leaves_equal(r, g, f"{tag}.{f}")
        else:
            g = g.numpy()
            r = np.asarray(r)
            assert g.dtype == r.dtype, f"{tag}.{f}: {g.dtype} vs {r.dtype}"
            np.testing.assert_array_equal(g, r, err_msg=f"{tag}.{f}")


def _preset_cases():
    vals = np.linspace(150.0, 650.0, 13)
    return [
        ("solar_heavy", dict(depth=0.6)),
        ("demand_response", dict(cap_w=3e4, n_days=2, n_events=3)),
        ("heatwave", dict(delta_c=9.5)),
        ("thermal_stress", dict()),
        ("thermal_stress", dict(delta_c=4.0, cap_frac=0.9,
                                event_start_s=600.0, event_len_s=60.0)),
        ("carbon_trace", dict(values=vals, dt=300.0, t0=60.0)),
    ]


@pytest.mark.parametrize("cfg_name", ["tiny_cluster", "tx_gaia"])
def test_scenario_presets_match_reference_exactly(cfg_name):
    from repro.scenarios import scenario as RS
    from repro_torch import scenarios as PS

    rc, pc = getattr(rcfg, cfg_name)(), getattr(pcfg, cfg_name)()
    for name, kw in _preset_cases():
        _assert_leaves_equal(jax.device_get(getattr(RS, name)(rc, **kw)),
                             getattr(PS, name)(pc, **kw), name)


def test_grid_signals_match_reference(tmp_path):
    from repro.data import grid_signals as RG
    from repro_torch.data import grid_signals as PG
    from repro_torch.utils.errors import SignalValidationError
    from repro.utils.errors import SignalValidationError as RefSignalError

    for kind in ("carbon", "price", "wetbulb"):
        for horizon, dt, seed in ((86_400.0, 300.0, 0), (7_200.0, 60.0, 3)):
            rv, rdt = RG.synth_grid_trace(kind, horizon, dt, seed)
            pv, pdt = PG.synth_grid_trace(kind, horizon, dt, seed)
            assert pdt == rdt and pv.dtype == rv.dtype
            np.testing.assert_array_equal(pv, rv, err_msg=kind)
            path = PG.write_signal_csv(str(tmp_path / f"{kind}{seed}.csv"),
                                       pv, pdt, t0=30.0)
            assert open(path).read() == open(RG.write_signal_csv(
                str(tmp_path / f"r_{kind}{seed}.csv"), rv, rdt,
                t0=30.0)).read()
            psig, prep = PG.load_signal_csv(path, return_report=True)
            rsig, rrep = RG.load_signal_csv(path, return_report=True)
            _assert_leaves_equal(jax.device_get(rsig), psig, kind)
            assert prep.n_ok == rrep.n_ok
    with pytest.raises(KeyError):
        PG.synth_grid_trace("wind", 3600.0)
    # a NaN sample: strict raises in both, repair interpolates in both
    v, dt = PG.synth_grid_trace("carbon", 3600.0, 300.0, 1)
    v[4] = np.nan
    bad = PG.write_signal_csv(str(tmp_path / "bad.csv"), v, dt)
    with pytest.raises(SignalValidationError):
        PG.load_signal_csv(bad)
    with pytest.raises(RefSignalError):
        RG.load_signal_csv(bad)
    _assert_leaves_equal(
        jax.device_get(RG.load_signal_csv(bad, validate="repair")),
        PG.load_signal_csv(bad, validate="repair"), "repair")
