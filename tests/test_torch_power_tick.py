"""The replay tick's fused entries against what they replace.

- ``power_tick_torch`` (the plain version of ``power_tick``, which the
  CPU runs) against the composition it replaces in the port, bitwise:
  ``compute_power`` plus, with thermals, the tail's derate from the
  previous tick's rack temperatures and ``job_thermal_rate``;
- the same against the JAX package's ``compute_power`` (the Pallas
  scatter in interpret mode) and its tail's derate, to ``rtol=1e-5``;
- ``rack_tick_torch`` against the RC update, throttled seconds and peak
  it replaces, bitwise, and against the JAX package to ``rtol=1e-5``;
- the racks' CSR (``core.state.rack_csr``) against the rack ids, racks
  that are not contiguous included;
- the wrappers' refusals.

Mid-episode states come from the reference's own episodes (``tiny_cluster``
and a reduced ``tx_gaia``, thermals off, on, and stressed so the throttle
binds), carried across by ``interop``. The CUDA kernels run only on the
card: ``test_torch_kernels_cuda.py`` holds them to these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import RTOL, make_pair, ref_numpy

import repro.configs.sim as rcfg
import repro.core as R
import repro.core.power as RP
import repro.core.thermal as RT
from repro.scenarios.signals import eval_signal as ref_eval_signal
import repro_torch.configs.sim as pcfg
import repro_torch.core.power as PP
import repro_torch.core.thermal as PT
from repro_torch import interop, kernels
from repro_torch.core.state import rack_csr
from repro_torch.kernels import node_power as npw
from repro_torch.kernels import rack_thermal as prt
from repro_torch.kernels.throttle import Throttle
from repro_torch.scenarios.signals import eval_signal

# racks ride the throttle ramp and cross the trip (test_torch_thermal.py's
# stress config, and the acceptance stress hour's thresholds for tx_gaia)
_TINY_STRESS = dict(thermal_enabled=True, rack_tau_s=120.0,
                    thermal_trip_c=22.0, throttle_start_c=20.0,
                    throttle_full_c=30.0)
_GAIA = dict(max_jobs=64, max_nodes_per_job=8)
_GAIA_STRESS = dict(thermal_enabled=True, rack_tau_s=120.0,
                    thermal_trip_c=26.0, throttle_start_c=24.0,
                    throttle_full_c=34.0)
# (name, cfg factory name, config kwargs, jobs, ticks before the state)
CASES = {
    "tiny": ("tiny_cluster", {}, 40, 90),
    "tiny_thermal": ("tiny_cluster", dict(thermal_enabled=True), 40, 200),
    "tiny_stress": ("tiny_cluster", _TINY_STRESS, 24, 400),
    "tx_gaia": ("tx_gaia", _GAIA, 60, 300),
    "tx_gaia_stress": ("tx_gaia", {**_GAIA, **_GAIA_STRESS}, 60, 600),
}


@pytest.fixture(scope="module", params=list(CASES))
def mid_episode(request):
    """A reference mid-episode state of one case, on both sides."""
    fn, kw, n_jobs, ticks = CASES[request.param]
    rc, pc = getattr(rcfg, fn)(**kw), getattr(pcfg, fn)(**kw)
    rst, rs, _, _, _, _ = make_pair(rc, pc, n_jobs, 600.0, seed=3,
                                    mean_dur_s=400.0)
    rs, _ = jax.jit(lambda s: R.run_episode(rc, rst, s, ticks, "fcfs"))(rs)
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    ps = interop.state_from_numpy(ref_numpy(rs), device="cpu")
    assert int((ps.placement >= 0).sum()) > 0
    return request.param, rc, pc, rst, rs, pst, ps


def _port_composition(cfg, state, statics, wb):
    """What the tick computed before the fused entry: ``compute_power``,
    then with thermals the tail's derate (previous tick's temperatures),
    the dynamic COP and ``job_thermal_rate``; else the static COP."""
    p = PP.compute_power(cfg, state, statics)
    idle = torch.sum(statics.idle_w * state.node_up)
    if not cfg.thermal_enabled:
        cop = torch.clamp(
            cfg.cop_base + cfg.cop_wetbulb_coef * (wb - cfg.wetbulb_ref_c),
            min=cfg.cop_min)
        return p, cop, idle, None
    nameplate = torch.tensor(max(cfg.nameplate_it_w, 1.0))
    th_r = PT.rack_throttle(cfg, state.rack_outlet_c)
    node_th = th_r.index_select(0, statics.node_rack.long())
    node_idle = statics.idle_w * state.node_up
    node_dyn = torch.clamp(p.node_it_w - node_idle, min=0.0)
    node_it = node_idle + node_th * node_dyn
    node_input = p.node_input_w * (node_it / torch.clamp(p.node_it_w,
                                                         min=1e-9))
    it_w = torch.sum(node_it)
    input_w = torch.sum(node_input)
    dyn_tot = torch.sum(node_dyn)
    gscale = torch.where(
        dyn_tot > 0.0,
        torch.sum(node_th * node_dyn) / torch.clamp(dyn_tot, min=1e-9), 1.0)
    cop = PT.cooling_cop(cfg, wb, it_w / nameplate)
    cooling_w = input_w / cop
    facility_w = input_w + cooling_w
    pue = torch.where(it_w > 1.0, facility_w / torch.clamp(it_w, min=1.0),
                      1.0)
    p = PP.PowerOut(node_it, node_input, it_w, input_w, cooling_w,
                    facility_w, pue, p.gflops * gscale)
    return p, cop, idle, PT.job_thermal_rate(state, statics, node_th)


def _ref_composition(cfg, state, statics):
    """The JAX package's ``compute_power`` (Pallas scatter) and its tail's
    derate (src/repro/core/sim.py, the thermal branch of ``_make_tail``)."""
    p = RP.compute_power(cfg, state, statics, use_kernel=True)
    wb = ref_eval_signal(statics.scenario.wetbulb, state.t)
    idle = jnp.sum(statics.idle_w * state.node_up)
    if not cfg.thermal_enabled:
        cop = jnp.maximum(
            cfg.cop_base + cfg.cop_wetbulb_coef * (wb - cfg.wetbulb_ref_c),
            cfg.cop_min)
        return p, cop, idle, None
    th_r = RT.rack_throttle(cfg, state.rack_outlet_c)
    node_th = th_r[statics.node_rack]
    node_idle = statics.idle_w * state.node_up
    node_dyn = jnp.maximum(p.node_it_w - node_idle, 0.0)
    node_it = node_idle + node_th * node_dyn
    node_input = p.node_input_w * (node_it / jnp.maximum(p.node_it_w, 1e-9))
    it_w = jnp.sum(node_it)
    input_w = jnp.sum(node_input)
    dyn_tot = jnp.sum(node_dyn)
    gscale = jnp.where(dyn_tot > 0.0, jnp.sum(node_th * node_dyn)
                       / jnp.maximum(dyn_tot, 1e-9), 1.0)
    cop = RT.cooling_cop(cfg, wb, it_w / max(cfg.nameplate_it_w, 1.0))
    cooling_w = input_w / cop
    facility_w = input_w + cooling_w
    pue = jnp.where(it_w > 1.0, facility_w / jnp.maximum(it_w, 1.0), 1.0)
    p = p._replace(node_it_w=node_it, node_input_w=node_input, it_w=it_w,
                   input_w=input_w, cooling_w=cooling_w,
                   facility_w=facility_w, pue=pue, gflops=p.gflops * gscale)
    return p, cop, idle, RT.job_thermal_rate(state, statics, node_th)


def _tick(pc, ps, pst):
    wb = eval_signal(pst.scenario.wetbulb, ps.t)
    return PP.power_tick(PP.tick_statics(pc, pst), ps, wb), wb


def test_plain_tick_is_the_composition_it_replaces_bitwise(mid_episode):
    name, _, pc, _, _, pst, ps = mid_episode
    before = dict(kernels.LAUNCHES)
    (p, cop, idle, job_th), wb = _tick(pc, ps, pst)
    assert kernels.LAUNCHES == before      # the CPU path launches nothing
    want_p, want_cop, want_idle, want_th = _port_composition(pc, ps, pst, wb)
    for f in p._fields:
        assert torch.equal(getattr(p, f), getattr(want_p, f)), f"{name}.{f}"
    assert torch.equal(cop, want_cop) and torch.equal(idle, want_idle)
    if pc.thermal_enabled:
        assert torch.equal(job_th, want_th), name
    else:
        assert job_th is None
    if name.endswith("stress"):
        # the throttle binds: some job runs below full clock
        assert float(job_th.min()) < 1.0, name


def test_plain_tick_matches_the_reference(mid_episode):
    name, rc, pc, rst, rs, pst, ps = mid_episode
    (p, cop, idle, job_th), _ = _tick(pc, ps, pst)
    want_p, want_cop, want_idle, want_th = _ref_composition(rc, rs, rst)
    for f in p._fields:
        np.testing.assert_allclose(getattr(p, f).numpy(),
                                   np.asarray(getattr(want_p, f)),
                                   rtol=RTOL, err_msg=f"{name}.{f}")
    for g, w, tag in ((cop, want_cop, "cop"), (idle, want_idle, "idle"),
                      (job_th, want_th, "job factor")):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       err_msg=f"{name}.{tag}")


def _stack_states(states):
    return type(states[0])(*(torch.stack(v) for v in zip(*states)))


def test_plain_tick_of_replicas_is_the_per_replica_tick(mid_episode):
    """E replicas in one call (the fleets' shape) give each replica's own
    one-replica result, bitwise."""
    name, _, pc, _, _, pst, ps = mid_episode
    ts = PP.tick_statics(pc, pst)
    states = [ps, ps._replace(t=ps.t + 37.0, node_up=torch.flip(
        ps.node_up, (0,))), ps._replace(rack_outlet_c=ps.rack_outlet_c + 3.5)]
    wbs = [eval_signal(pst.scenario.wetbulb, s.t) for s in states]
    b = _stack_states(states)
    got = npw.power_tick(ts, b.jstate, b.t, b.start_t, b.placement, b.req,
                         b.node_up, b.rack_outlet_c, torch.stack(wbs))
    for e, (s, wb) in enumerate(zip(states, wbs)):
        one = npw.power_tick(ts, s.jstate, s.t, s.start_t, s.placement,
                             s.req, s.node_up, s.rack_outlet_c, wb)
        for g, w in zip(got, one):
            assert (g is None and w is None) or torch.equal(g[e], w), name


def test_plain_rack_tick_is_the_update_it_replaces(mid_episode):
    """rack_tick_torch against rack_thermal_update + the throttled seconds
    and peak of the tail it replaces, bitwise; and against the reference's
    rack_thermal_update, to rtol."""
    name, rc, pc, rst, rs, pst, ps = mid_episode
    rng = np.random.default_rng(4)
    heat = torch.tensor(rng.uniform(100.0, 1500.0, pc.n_nodes)
                        .astype(np.float32))
    r = torch.tensor(np.float32(0.83))
    wb = eval_signal(pst.scenario.wetbulb, ps.t)
    before = dict(kernels.LAUNCHES)
    state, th_step, rack_max = PT.rack_tick(PT.rack_tick_statics(pc, pst), ps,
                                            heat, r, wb)
    assert kernels.LAUNCHES == before
    want_t, _ = PT.rack_thermal_update(pc, pst, ps.rack_outlet_c, heat * r,
                                       PT.supply_temp(pc, wb))
    th_r = PT.rack_throttle(pc, ps.rack_outlet_c)
    assert torch.equal(state.rack_outlet_c, want_t)
    assert torch.equal(th_step,
                       torch.where(torch.any(th_r < 1.0), pc.dt, 0.0))
    assert torch.equal(state.thermal_throttle_s,
                       ps.thermal_throttle_s + th_step)
    assert torch.equal(rack_max, torch.max(want_t))
    assert torch.equal(state.peak_rack_c,
                       torch.maximum(ps.peak_rack_c, torch.max(want_t)))
    if name.endswith("stress"):
        assert float(th_step) == pc.dt
    ref_t, _ = RT.rack_thermal_update(
        rc, rst, rs.rack_outlet_c, heat.numpy() * np.float32(0.83),
        RT.supply_temp(rc, ref_eval_signal(rst.scenario.wetbulb, rs.t)))
    np.testing.assert_allclose(state.rack_outlet_c.numpy(), np.asarray(ref_t),
                               rtol=RTOL)


@pytest.mark.parametrize("node_rack,n_racks", [
    (np.arange(12) // 4, 3),                          # contiguous racks
    (np.array([2, 0, 1, 0, 2, 2, 1, 0, 1]), 3),       # interleaved
    (np.array([3, 3, 0, 0, 3]), 5),                   # empty racks 1, 2, 4
])
def test_rack_csr_lists_each_racks_nodes_ascending(node_rack, n_racks):
    ptr, nodes = rack_csr(node_rack, n_racks)
    assert ptr.dtype == nodes.dtype == np.int32
    assert ptr.shape == (n_racks + 1,) and nodes.shape == node_rack.shape
    for r in range(n_racks):
        np.testing.assert_array_equal(nodes[ptr[r]:ptr[r + 1]],
                                      np.flatnonzero(node_rack == r))


def test_rack_tick_on_racks_that_are_not_contiguous():
    """Hand-made statics whose racks interleave: the rack tick sums each
    rack's own nodes (against a float64 sum), and the CSR drives it."""
    cfg = pcfg.tiny_cluster(thermal_enabled=True)
    n, R = cfg.n_nodes, cfg.n_racks
    node_rack = (np.arange(n) * 7) % R
    ptr, nodes = rack_csr(node_rack, R)
    rs = prt.rack_statics(torch.tensor(ptr), torch.tensor(nodes),
                          torch.tensor(node_rack.astype(np.int32)),
                          torch.full((R,), 1e-3), consts=prt.RackConsts(
                              0.0, -100.0, 1.0, 1.0,
                              Throttle(50.0, 10.0, 0.6, 0.4)))
    heat = np.random.default_rng(2).uniform(0, 900, n).astype(np.float32)
    outlet = torch.full((R,), 20.0)
    new_t, _, rack_max, _ = prt.rack_tick(
        rs, torch.tensor(heat), torch.tensor(1.0), torch.tensor(15.0),
        outlet, torch.tensor(0.0))
    # alpha = 1: T' = supply + heat * r_th
    want = 15.0 + np.bincount(node_rack, heat.astype(np.float64), R) * 1e-3
    np.testing.assert_allclose(new_t.numpy(), want, rtol=RTOL)
    assert float(rack_max) == float(new_t.max())


def test_rack_csr_rejects_ids_out_of_range():
    with pytest.raises(ValueError):
        rack_csr(np.array([0, 3, 1]), 3)
    with pytest.raises(ValueError):
        rack_csr(np.array([0, -1]), 2)


@pytest.mark.parametrize("broken", ["swapped", "descending", "ptr_shifted",
                                    "rack_out_of_range"])
def test_rack_statics_refuse_a_csr_that_is_not_node_racks(broken):
    """The kernel walks the CSR and the plain version reads ``node_rack``:
    hand-made statics where the two disagree are refused, not run."""
    node_rack = np.array([2, 0, 1, 0, 2, 2, 1, 0, 1])
    R = 3
    ptr, nodes = rack_csr(node_rack, R)
    if broken == "swapped":           # nodes 1 and 2 trade racks
        nodes[[0, 3]] = nodes[[3, 0]]
    elif broken == "descending":      # rack 0's nodes out of order
        nodes[:3] = nodes[:3][::-1]
    elif broken == "ptr_shifted":
        ptr[1] += 1
    else:
        node_rack = node_rack.copy()
        node_rack[0] = R
    consts = prt.RackConsts(0.0, -100.0, 1.0, 1.0,
                            Throttle(50.0, 10.0, 0.6, 0.4))
    with pytest.raises(RuntimeError, match="not the CSR of node_rack"):
        prt.rack_statics(torch.tensor(ptr), torch.tensor(nodes),
                         torch.tensor(node_rack.astype(np.int32)),
                         torch.full((R,), 1e-3), consts=consts)


# ------------------------------------------------------------ refusals
@pytest.fixture(scope="module")
def tiny_tick():
    cfg = pcfg.tiny_cluster(thermal_enabled=True)
    import repro_torch.core as C
    from repro_torch.data import synth_workload

    jobs, bank = synth_workload(cfg, 8, 300.0, seed=0)
    st = C.build_statics(cfg, bank, device="cpu")
    s = C.load_jobs(C.init_state(cfg, st, 0), jobs)
    return cfg, st, s


_TICK_ARGS = ("jstate", "t", "start_t", "placement", "req", "node_up",
              "rack_outlet_c", "wetbulb")


@pytest.mark.parametrize("arg,broken,err", [
    ("jstate", "int64", TypeError),
    ("placement", "float", TypeError),
    ("req", "shape", ValueError),
    ("node_up", "shape", ValueError),
    ("rack_outlet_c", "shape", ValueError),
    ("start_t", "strided", ValueError),
    ("t", "batched_alone", ValueError),
    ("wetbulb", "device", ValueError),
])
def test_power_tick_rejects_what_the_kernel_does_not_take(tiny_tick, arg,
                                                          broken, err):
    cfg, st, s = tiny_tick
    ts = PP.tick_statics(cfg, st)
    args = {f: getattr(s, f) for f in _TICK_ARGS[:-1]}
    args["wetbulb"] = eval_signal(st.scenario.wetbulb, s.t)
    x = args[arg]
    args[arg] = {"int64": lambda: x.long(), "float": lambda: x.float(),
                 "shape": lambda: x[..., :-1].contiguous(),
                 "strided": lambda: torch.stack([x, x], -1)[..., 0],
                 "batched_alone": lambda: x.reshape(1),
                 "device": lambda: x.to("meta")}[broken]()
    with pytest.raises(err):
        npw.power_tick(ts, *(args[f] for f in _TICK_ARGS))


@pytest.mark.parametrize("broken", ["rack_dtype", "trace_shape", "device",
                                    "node_vec"])
def test_tick_statics_reject_what_the_kernel_does_not_take(tiny_tick, broken):
    cfg, st, _ = tiny_tick
    err = ValueError
    if broken == "rack_dtype":
        st, err = st._replace(node_rack=st.node_rack.long()), TypeError
    elif broken == "trace_shape":
        st = st._replace(gpu_trace=st.gpu_trace[:, :-1].contiguous())
    elif broken == "node_vec":
        st = st._replace(peak_gflops=st.peak_gflops[:-1])
    else:
        # no kernel and no fallback off the CPU and the card
        st = st._replace(**{f: getattr(st, f).to("meta") for f in (
            "cpu_trace", "gpu_trace", "capacity", "idle_w", "cpu_dyn_w",
            "gpu_dyn_w", "node_max_w", "peak_gflops", "node_rack")})
    with pytest.raises(err):
        PP.tick_statics(cfg, st)


@pytest.mark.parametrize("broken", ["heat_dtype", "heat_shape",
                                    "outlet_shape", "peak_batched",
                                    "ptr_shape", "ptr_dtype", "device"])
def test_rack_tick_rejects_what_the_kernel_does_not_take(tiny_tick, broken):
    cfg, st, s = tiny_tick
    rs = PT.rack_tick_statics(cfg, st)
    heat = torch.ones(cfg.n_nodes)
    args = dict(node_input=heat, r=torch.tensor(1.0), wetbulb=torch.tensor(
        15.0), outlet=s.rack_outlet_c, peak=s.peak_rack_c)
    err = ValueError
    if broken == "heat_dtype":
        args["node_input"], err = heat.double(), TypeError
    elif broken == "heat_shape":
        args["node_input"] = heat[:-1]
    elif broken == "outlet_shape":
        args["outlet"] = s.rack_outlet_c[:-1]
    elif broken == "peak_batched":
        args["peak"] = s.peak_rack_c.reshape(1)
    elif broken in ("ptr_shape", "ptr_dtype", "device"):
        fix = {"ptr_shape": dict(rack_ptr=st.rack_ptr[:-1]),
               "ptr_dtype": dict(rack_ptr=st.rack_ptr.long()),
               "device": {f: getattr(st, f).to("meta") for f in (
                   "rack_ptr", "rack_nodes", "node_rack", "rack_r_th")}}
        err = TypeError if broken == "ptr_dtype" else ValueError
        with pytest.raises(err):
            PT.rack_tick_statics(cfg, st._replace(**fix[broken]))
        return
    with pytest.raises(err):
        prt.rack_tick(rs, **args)
