"""Fleets on ``tiny_cluster``: the port's ``run_fleet`` (the replay step
batched over a leading replica axis) against the JAX package's vmapped
``run_fleet``, over policy x scenario grids (EASY, partition placement, a
trace-carbon scenario, a binding demand-response cap), a banked workload
axis, the three telemetry modes, a chained sweep and the macro-stepped grid;
the fleet-building helpers leaf for leaf; ``run_fleet``'s refusals word
for word; the power tick over a banked trace; and the threefry key words
of every replica.

Integer state and ``key`` words match exactly, floats to ``RTOL``
(``_torch_parity``).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_close,
    assert_state_close,
    assert_summary_close,
    assert_tree_close,
    make_pair,
    ref_numpy,
    to_numpy,
)

import repro.configs.sim as rcfg
import repro.core as R
from repro import scenarios as RS
from repro.core import fleet as RF
from repro.core import placement as RPL
from repro.data import stack_workloads as ref_stack_workloads
from repro.data import synth_workload as ref_synth
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import interop
from repro_torch import scenarios as PS
from repro_torch.core import fleet as PF
from repro_torch.core import placement as PPL
from repro_torch.core import power as PP
from repro_torch.core.state import key_words
from repro_torch.data import stack_workloads
from repro_torch.kernels import node_power as npw
from repro_torch.utils import prng
from repro_torch.utils.errors import ConfigError

N_TICKS = 300
SELECTS = ("fcfs", "easy")
PLACES = ("first_fit", "partition")
CARBON = np.linspace(200.0, 520.0, 9)


def _scenarios(S, cfg):
    """Default grid, a 2-minute carbon trace, and a demand-response cap
    binding from t = 100 s, in either package (``S`` its scenarios)."""
    return [S.default_scenario(cfg), S.carbon_trace(cfg, CARBON, 120.0),
            S.demand_response(cfg, cap_w=0.25 * cfg.nameplate_it_w,
                              event_start_s=100.0, event_len_s=400.0)]


@pytest.fixture(scope="module")
def pair():
    # short jobs (mean 150 s) so completions happen inside the window
    return make_pair(rcfg.tiny_cluster(), pcfg.tiny_cluster(), 24, 600.0,
                     seed=0, mean_dur_s=150.0)


def _grids():
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    _, rpol = RPL.policy_grid(SELECTS, PLACES)
    _, ppol = PPL.policy_grid(SELECTS, PLACES)
    return (RF.policy_scenario_grid(rpol, _scenarios(RS, rc)),
            PF.policy_scenario_grid(ppol, _scenarios(PS, pc)))


@pytest.fixture(scope="module")
def grid_run(pair):
    """The 12-replica grid (4 policies x 3 scenarios), summary_only, in
    both packages."""
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    (rpol, rscn), (ppol, pscn) = _grids()
    ref = RF.run_fleet(rc, rst, rs, N_TICKS, policies=rpol, scenarios=rscn,
                       summary_only=True)
    got = PF.run_fleet(pc, pst, ps, N_TICKS, policies=ppol, scenarios=pscn,
                       summary_only=True)
    return ref_numpy(ref[0]), ref_numpy(ref[1]), got


def _assert_fleet_close(rf, rt, pf, pt, tag):
    assert_state_close(rf, pf, f"{tag}.state")
    assert_tree_close(rt, pt, f"{tag}.telemetry")
    rows_r = RF.fleet_summary(rf, rt if rt.n_steps.ndim == 1 else None)
    rows_p = PF.fleet_summary(pf, pt if pt.n_steps.dim() == 1 else None)
    assert len(rows_r) == len(rows_p)
    for i, (a, b) in enumerate(zip(rows_r, rows_p)):
        assert_summary_close(a, b, f"{tag}[{i}]")


def test_policy_scenario_grid_matches_reference(grid_run):
    rf, rt, (pf, pt) = grid_run
    assert pf.t.shape == (12,)
    _assert_fleet_close(rf, rt, pf, pt, "grid")
    done = to_numpy(pf.n_completed)
    assert done.min() > 0
    # the demand-response cap binds: every third replica runs throttled
    throttle = to_numpy(pt.mean_throttle)
    assert (throttle[2::3] < 1.0).all() and (throttle[0::3] == 1.0).all()


def test_replicas_equal_their_runs_alone(pair, grid_run):
    """Replica e of the fleet is the same run as ``run_episode`` alone
    under its policy, scenario and key: integers exact, floats RTOL."""
    pc = pcfg.tiny_cluster()
    _, _, pst, ps, _, _ = pair
    _, _, (pf, pt) = grid_run
    (_, _), (ppol, pscn) = _grids()
    for e in (0, 5, 11):
        sel = list(C.schedulers.SELECT_IDS)[int(ppol.select[e])]
        place = list(PPL.PLACE_IDS)[int(ppol.place[e])]
        st = pst._replace(scenario=PF._scenario_list(pscn)[e])
        f1, t1 = C.run_episode(pc, st, ps._replace(key=pf.key[e]), N_TICKS,
                               sel, placement=place, summary_only=True)
        alone = type(pf)(*(v[e] for v in pf))
        for name in pf._fields:
            if name != "key":
                assert_close(to_numpy(getattr(f1, name)),
                             to_numpy(getattr(alone, name)), f"{e}.{name}")
        assert_tree_close(t1, type(pt)(*(v[e] for v in pt)), f"{e}.telem")


@pytest.mark.parametrize("mode", ["stepout", "windows"])
def test_telemetry_modes_match_reference(pair, mode):
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    kw = {"stepout": {}, "windows": dict(telemetry_every=50)}[mode]
    rscn, pscn = _scenarios(RS, rc)[:2], _scenarios(PS, pc)[:2]
    rf, ro = RF.run_fleet(rc, rst, rs, 150, "easy", scenarios=rscn,
                          placement="partition", **kw)
    pf, po = PF.run_fleet(pc, pst, ps, 150, "easy", scenarios=pscn,
                          placement="partition", **kw)
    shape = (2, 150) if mode == "stepout" else (2, 3)
    assert tuple(po.reward.shape) == shape
    assert_state_close(rf, pf, f"{mode}.state")
    assert_tree_close(ro, po, f"{mode}.out")


def test_chained_sweep_folds_the_keys(pair, grid_run):
    """A batched state goes back in: each replica's key advances by
    ``fold_in(key, 1)``, and 100 more ticks match the reference's."""
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, _, pst, _, _, _ = pair
    rf, _, (pf, _) = grid_run
    (rpol, rscn), (ppol, pscn) = _grids()
    rstate = jax.tree.map(jax.numpy.asarray, rf)._replace(
        key=jax.random.wrap_key_data(jax.numpy.asarray(rf.key)))
    before = to_numpy(pf)
    rf2, rt2 = RF.run_fleet(rc, rst, rstate, 100, policies=rpol,
                            scenarios=rscn, telemetry_every=50)
    pf2, pt2 = PF.run_fleet(pc, pst, pf, 100, policies=ppol, scenarios=pscn,
                            telemetry_every=50)
    assert_state_close(rf2, pf2, "chained.state")
    assert_tree_close(rt2, pt2, "chained.windows")
    np.testing.assert_array_equal(to_numpy(pf2.key),
                                  prng.fold_in(before.key, 1))
    # the caller's batched state is left as it was, and shares no memory
    for name, a, b in zip(pf._fields, before, pf):
        np.testing.assert_array_equal(to_numpy(b), a, err_msg=name)
    ptrs = {v.data_ptr() for v in pf}
    assert not ptrs & {v.data_ptr() for v in pf2}


def test_workload_bank_axis_matches_reference():
    """Six replicas over a 3-workload bank (``workloads=``), sharing
    workload 0's job table, against the reference."""
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    wls = [ref_synth(rc, 24, 600.0, seed=s, mean_dur_s=150.0)
           for s in range(3)]
    jobs, bank = stack_workloads(pc, wls)
    rst = R.build_statics(rc, ref_stack_workloads(rc, wls)[1])
    rs = R.load_jobs(R.init_state(rc, rst, jax.random.key(2)), wls[0][0])
    pst = C.build_statics(pc, bank, device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 2), wls[0][0])
    ids = [0, 1, 2, 2, 1, 0]
    pols = [("fcfs", "first_fit")] * 3 + [("sjf", "best_fit")] * 3
    rf, rt = RF.run_fleet(rc, rst, rs, 250, workloads=ids, policies=pols,
                          summary_only=True)
    pf, pt = PF.run_fleet(pc, pst, ps, 250, workloads=ids, policies=pols,
                          summary_only=True)
    _assert_fleet_close(ref_numpy(rf), ref_numpy(rt), pf, pt, "bank")
    energy = to_numpy(pt.energy_kwh)
    assert len(set(energy[:3].tolist())) == 3     # the slices differ


def test_fleet_builders_match_reference():
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    pairs = [
        (RS.stack_scenarios(_scenarios(RS, rc)),
         PS.stack_scenarios(_scenarios(PS, pc))),
        (RS.sample_scenarios(rc, 9, seed=3), PS.sample_scenarios(pc, 9, seed=3)),
        (RPL.policy_grid(("replay", "sjf", "easy"), PLACES)[1],
         PPL.policy_grid(("replay", "sjf", "easy"), PLACES)[1]),
    ]
    pairs += list(zip(*_grids()))
    for i, (ref, got) in enumerate(pairs):
        # the port's Scenario has no traffic or burst fields yet
        assert_tree_close(ref, got, f"builder {i}")
    assert RPL.policy_grid(SELECTS, PLACES)[0] == PPL.policy_grid(
        SELECTS, PLACES)[0]
    assert PS.n_replicas(pairs[1][1]) == 9
    wls = [ref_synth(rc, 20 + 4 * s, 500.0 + 200 * s, seed=s)
           for s in range(3)]
    for a, b in zip(ref_stack_workloads(rc, wls), stack_workloads(pc, wls)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


def _refusal_cases(st_r, s_r, st_p, s_p, banked_r, banked_p, sb_r, sb_p):
    """(reference call, port call) pairs that each raise."""
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    pr, pp = [("fcfs", "first_fit")] * 2, [("fcfs", "first_fit")] * 2
    return {
        "scheduler_and_policies": (
            lambda: RF.run_fleet(rc, st_r, s_r, 5, "fcfs", policies=pr),
            lambda: PF.run_fleet(pc, st_p, s_p, 5, "fcfs", policies=pp)),
        "axes_differ": (
            lambda: RF.run_fleet(rc, st_r, s_r, 5, policies=pr,
                                 scenarios=[st_r.scenario] * 3),
            lambda: PF.run_fleet(pc, st_p, s_p, 5, policies=pp,
                                 scenarios=[st_p.scenario] * 3)),
        "batched_state_size": (
            lambda: RF.run_fleet(rc, st_r, sb_r, 5,
                                 scenarios=[st_r.scenario] * 3),
            lambda: PF.run_fleet(pc, st_p, sb_p, 5,
                                 scenarios=[st_p.scenario] * 3)),
        "workloads_unbanked": (
            lambda: RF.run_fleet(rc, st_r, s_r, 5, workloads=[0]),
            lambda: PF.run_fleet(pc, st_p, s_p, 5, workloads=[0])),
        "workloads_shape": (
            lambda: RF.run_fleet(rc, banked_r, s_r, 5, workloads=[0, 1]),
            lambda: PF.run_fleet(pc, banked_p, s_p, 5, workloads=[0, 1])),
        "workloads_range": (
            lambda: RF.run_fleet(rc, banked_r, s_r, 5, workloads=[2],
                                 scenarios=[banked_r.scenario]),
            lambda: PF.run_fleet(pc, banked_p, s_p, 5, workloads=[2],
                                 scenarios=[banked_p.scenario])),
    }


@pytest.mark.parametrize("case", ["scheduler_and_policies", "axes_differ",
                                  "batched_state_size", "workloads_unbanked",
                                  "workloads_shape", "workloads_range"])
def test_run_fleet_refuses_as_the_reference_does(pair, case):
    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    wls = [ref_synth(rc, 16, 600.0, seed=s) for s in range(2)]
    banked_r = R.build_statics(rc, ref_stack_workloads(rc, wls)[1])
    banked_p = C.build_statics(pc, stack_workloads(pc, wls)[1], device="cpu")
    sb_p = C.state.broadcast_state(ps, 2)
    sb_r = jax.tree.map(lambda a: jax.numpy.stack([a, a]), rs)
    ref_call, port_call = _refusal_cases(rst, rs, pst, ps, banked_r,
                                         banked_p, sb_r, sb_p)[case]
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ConfigError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_macro_fleet_runs_and_matches_per_tick(pair, grid_run):
    """``run_fleet(..., macro=True)`` runs the 12-replica grid in lockstep:
    every replica's final state and telemetry equal the per-tick grid's
    (``macro_steps`` aside), and each replica segments on its own."""
    pc = pcfg.tiny_cluster()
    _, _, pst, ps, _, _ = pair
    _, _, (pf, pt) = grid_run
    (_, _), (ppol, pscn) = _grids()
    mf, mt = PF.run_fleet(pc, pst, ps, N_TICKS, policies=ppol,
                          scenarios=pscn, summary_only=True, macro=True)
    for f in pf._fields:
        assert torch.equal(getattr(pf, f), getattr(mf, f)), f
    for f in pt._fields:
        if f != "macro_steps":
            assert torch.equal(getattr(pt, f), getattr(mt, f)), f
    steps = to_numpy(mt.macro_steps)
    assert (steps < N_TICKS).all() and len(set(steps.tolist())) > 1


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "make_fleet_mesh"),
    (dict(snapshot_every_s=60.0, snapshot_dir="x"), "summary_only"),
    (dict(resume_from="x"), "summary_only"),
])
def test_run_fleet_refuses_what_later_slices_bring(pair, kw, item):
    """``mesh=`` takes a ``launch.mesh.FleetMesh`` and refuses anything
    else, naming ``make_fleet_mesh`` (the sharded fleet itself is
    ``tests/test_torch_mesh.py``'s); snapshots refuse only without an
    episode-wide summary. Both are ``ConfigError``s."""
    _, _, pst, ps, _, _ = pair
    with pytest.raises(ConfigError, match=item):
        PF.run_fleet(pcfg.tiny_cluster(), pst, ps, 5, **kw)


# ------------------------------------------------------- the banked tick
@pytest.fixture(scope="module")
def banked_tick():
    """A 3-workload bank and a mid-episode 4-replica state of it."""
    pc = pcfg.tiny_cluster(thermal_enabled=True)
    wls = [ref_synth(rcfg.tiny_cluster(), 24, 600.0, seed=s,
                     mean_dur_s=300.0) for s in range(3)]
    jobs, bank = stack_workloads(pc, wls)
    pst = C.build_statics(pc, bank, device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 0), wls[0][0])
    pols = [("fcfs", "first_fit"), ("sjf", "spread")] * 2
    fs, _ = PF.run_fleet(pc, pst, ps, 120, workloads=[2, 0, 1, 2],
                         policies=pols, summary_only=True)
    assert int((fs.placement >= 0).sum()) > 0
    return pc, pst, bank, fs


def _tick_args(state, wb):
    return (state.jstate, state.t, state.start_t, state.placement, state.req,
            state.node_up, state.rack_outlet_c, wb, state.workload)


def test_banked_power_tick_is_each_replicas_own_bank(banked_tick):
    """power_tick_torch over the (W, J, Q) bank equals, replica by replica,
    the unbanked call on that replica's own (J, Q) slice, bitwise."""
    pc, pst, bank, fs = banked_tick
    wb = torch.linspace(12.0, 20.0, 4)
    got = npw.power_tick_torch(PP.tick_statics(pc, pst), *_tick_args(fs, wb))
    for e, w in enumerate(to_numpy(fs.workload)):
        one = C.build_statics(pc, {k: v[w] for k, v in bank.items()},
                              device="cpu")
        s = type(fs)(*(v[e] for v in fs))._replace(
            workload=torch.tensor(0, dtype=torch.int32))
        want = npw.power_tick_torch(PP.tick_statics(pc, one),
                                    *_tick_args(s, wb[e]))
        for i, (g, x) in enumerate(zip(got, want)):
            assert torch.equal(g[e], x), (e, i)
    assert not torch.equal(got[0][0], got[0][1])


def test_single_bank_is_a_bank_of_one(banked_tick):
    """A (J, Q) bank and the same bank as (1, J, Q) give the same bits,
    and an id outside [0, W) is refused on the CPU."""
    pc, pst, bank, fs = banked_tick
    one = {k: v[1] for k, v in bank.items()}
    flat = C.build_statics(pc, one, device="cpu")
    w1 = C.build_statics(pc, {k: v[None] for k, v in one.items()},
                         device="cpu")
    s = fs._replace(workload=torch.zeros(4, dtype=torch.int32))
    wb = torch.full((4,), 16.0)
    for g, x in zip(npw.power_tick(PP.tick_statics(pc, flat),
                                   *_tick_args(s, wb)),
                    npw.power_tick(PP.tick_statics(pc, w1),
                                   *_tick_args(s, wb))):
        assert torch.equal(g, x)
    with pytest.raises(ConfigError, match=r"must be in \[0, 3\)"):
        npw.power_tick(PP.tick_statics(pc, pst), *_tick_args(
            fs._replace(workload=torch.tensor([0, 1, 3, 0],
                                              dtype=torch.int32)), wb))


def test_interop_takes_batched_states_and_banked_statics(banked_tick):
    pc, pst, _, fs = banked_tick
    st2 = interop.statics_from_numpy(to_numpy(pst), "cpu")
    assert_tree_close(to_numpy(pst), st2, "statics")
    s2 = interop.state_from_numpy(to_numpy(fs), "cpu")
    for name, a, b in zip(fs._fields, fs, s2):
        assert torch.equal(a, b), name
    _, rscn = RF.policy_scenario_grid(
        RPL.policy_grid(SELECTS, PLACES)[1], _scenarios(RS, rcfg.tiny_cluster()))
    scn = interop.scenario_from_numpy(ref_numpy(rscn), "cpu")
    assert_tree_close(rscn, scn, "batched scenario")
    assert PS.n_replicas(scn) == 12
    pol = interop.policy_from_numpy(
        {"select": np.array([0, 4], np.int32), "place": np.array([1, 3])})
    assert pol.select.dtype == torch.int32 and pol.place.tolist() == [1, 3]


# ------------------------------------------------------------- threefry
SEEDS = [0, 1, 2, 7, 42, 99, 1234, 65535, 2**16 + 1, 2**31 - 1, 2**31,
         2**32 - 1, 2**32, 2**32 + 5, 3 * 2**32 + 17, 2**40 + 3, 10**12,
         123456789, 987654321, 2**63 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_split_and_fold_in_match_jax(seed):
    """Key words, ``split`` and ``fold_in`` as the JAX package's (64-bit
    mode off keeps ``seed mod 2**32``), in numpy and in torch."""
    key = jax.random.key(seed)
    words = np.asarray(jax.random.key_data(key))
    np.testing.assert_array_equal(key_words(seed), words)
    n = 1 + seed % 7
    want = np.asarray(jax.random.key_data(jax.random.split(key, n)))
    np.testing.assert_array_equal(prng.split(key_words(seed), n), want)
    np.testing.assert_array_equal(
        prng.split(torch.tensor(key_words(seed)), n).numpy(), want)
    keys = jax.random.split(key, 3)
    folded = np.asarray(jax.random.key_data(
        jax.vmap(lambda k: jax.random.fold_in(k, seed % 5))(keys)))
    np.testing.assert_array_equal(
        prng.fold_in(np.asarray(jax.random.key_data(keys)), seed % 5),
        folded)
