"""Set-up parity: build_statics -> init_state -> load_jobs of the port
against the JAX package, every field of ``Statics`` and ``SimState``; the
copied numpy input layer; ``interop`` carrying the reference's state
across; and the flags this slice refuses."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_close, make_pair, ref_numpy, to_numpy

import repro.configs.sim as rcfg
import repro.core as R
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch.utils.errors import ConfigError
from repro_torch import interop

CONFIGS = {
    "tiny": dict(),
    "tx_gaia": dict(max_jobs=256, max_nodes_per_job=16),
}


def _cfgs(name, **kw):
    fn = "tiny_cluster" if name == "tiny" else "tx_gaia"
    kw = {**CONFIGS[name], **kw}
    return getattr(rcfg, fn)(**kw), getattr(pcfg, fn)(**kw)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_setup_matches_reference_field_by_field(name):
    rc, pc = _cfgs(name)
    rst, rs, pst, ps, _, _ = make_pair(rc, pc, 40, 600.0, seed=7)
    assert_tree_close(rst, pst, "statics", skip=_PORT_ONLY)
    _assert_rack_csr(rst, pst)
    assert_tree_close(rs, ps, "state")


# the racks' CSR, which only the port keeps: checked against the
# reference's rack ids
_PORT_ONLY = ("rack_ptr", "rack_nodes")


def _assert_rack_csr(rst, pst):
    rack = np.asarray(rst.node_rack)
    ptr, nodes = pst.rack_ptr.numpy(), pst.rack_nodes.numpy()
    assert ptr.dtype == nodes.dtype == np.int32
    assert ptr.shape == (np.shape(rst.rack_r_th)[0] + 1,)
    for r in range(ptr.shape[0] - 1):
        np.testing.assert_array_equal(nodes[ptr[r]:ptr[r + 1]],
                                      np.flatnonzero(rack == r))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_copied_synth_workload_is_identical(name):
    from repro.data import synth_workload as ref_synth
    from repro_torch.data import synth_workload as port_synth

    rc, pc = _cfgs(name)
    rj, rb = ref_synth(rc, 30, 900.0, seed=3)
    pj, pb = port_synth(pc, 30, 900.0, seed=3)
    for k in rj:
        np.testing.assert_array_equal(pj[k], rj[k], err_msg=k)
    for k in rb:
        np.testing.assert_array_equal(pb[k], rb[k], err_msg=k)


def test_key_words_are_the_reference_key_data():
    cfg = pcfg.tiny_cluster()
    st = C.build_statics(cfg, device="cpu")
    for seed in (0, 5, -1, 2**33 + 7):
        got = C.init_state(cfg, st, seed).key.numpy()
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_load_jobs_validates_strictly():
    from repro_torch.data import synth_workload
    from repro_torch.utils.errors import TraceValidationError

    cfg = pcfg.tiny_cluster()
    jobs, bank = synth_workload(cfg, 8, 300.0, seed=0)
    jobs["dur"] = jobs["dur"].copy()
    jobs["dur"][3] = np.nan
    st = C.build_statics(cfg, bank, device="cpu")
    with pytest.raises(TraceValidationError):
        C.load_jobs(C.init_state(cfg, st, 0), jobs)


def test_interop_round_trips_and_continues_in_lockstep():
    """The reference's mid-episode state carried across by ``interop``
    equals it bitwise, and both packages then advance it alike."""
    rc, pc = _cfgs("tiny")
    rst, rs, _, _, _, _ = make_pair(rc, pc, 48, 600.0, seed=2,
                                    mean_dur_s=150.0)
    rs, _ = jax.jit(lambda s: R.run_episode(rc, rst, s, 120, "fcfs"))(rs)
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    ps = interop.state_from_numpy(ref_numpy(rs), device="cpu")
    for want, got in ((ref_numpy(rs), ps), (jax.device_get(rst), pst)):
        for f in got._fields:
            if f == "scenario" or f in _PORT_ONLY:
                continue
            np.testing.assert_array_equal(
                to_numpy(getattr(got, f)).astype(np.float64),
                np.asarray(getattr(want, f)).astype(np.float64), err_msg=f)
    _assert_rack_csr(jax.device_get(rst), pst)
    rs2, _ = jax.jit(lambda s: R.run_episode(rc, rst, s, 80, "easy"))(rs)
    ps2, _ = C.run_episode(pc, pst, ps, 80, "easy")
    assert_tree_close(rs2, ps2, "state after 80 more ticks")


@pytest.mark.parametrize("flag", [
    # thermals run now; with a fault flag beside them the step still raises
    dict(thermal_enabled=True, rack_mtbf_hours=10.0),
    dict(node_mtbf_hours=10.0),
    dict(rack_mtbf_hours=10.0),
    dict(outages_enabled=True),
    dict(degrade_enabled=True),
    dict(serving_enabled=True, serving_nodes=4),
])
def test_flags_of_later_slices_raise(flag):
    cfg = pcfg.tiny_cluster(**flag)
    st = C.build_statics(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        C.init_state(cfg, st, 0)
    with pytest.raises(NotImplementedError, match="slice"):
        C.make_step(cfg, st, "fcfs")


def test_banked_trace_raises():
    """A banked (W, J, Q) bank builds (``tests/test_torch_fleet.py`` runs
    it); a bank whose two traces differ in shape, or a workload id outside
    [0, W), raises."""
    cfg = pcfg.tiny_cluster()
    bank = {"cpu": np.zeros((2, 64, 8), np.float32),
            "gpu": np.zeros((2, 64, 8), np.float32),
            "net_tx": np.zeros((2, 64), np.float32)}
    st = C.build_statics(cfg, bank, device="cpu")
    assert tuple(st.cpu_trace.shape) == (2, 64, 8)
    s = C.init_state(cfg, st, 0)
    C.run_episode(cfg, st, s, 2, "fcfs")
    with pytest.raises(ConfigError, match=r"workload ids must be in \[0, 2\)"):
        C.run_episode(cfg, st, s._replace(workload=torch.tensor(
            2, dtype=torch.int32)), 2, "fcfs")
    bad = dict(bank, gpu=np.zeros((3, 64, 8), np.float32))
    with pytest.raises(ValueError, match="trace bank"):
        C.make_step(cfg, C.build_statics(cfg, bad, device="cpu"), "fcfs")


def test_state_dtypes_are_f32_and_int32():
    cfg = pcfg.tiny_cluster()
    st = C.build_statics(cfg, device="cpu")
    s = C.init_state(cfg, st, 0)
    ints = {"jstate", "n_nodes", "part", "placement", "n_failures",
            "degrade_level", "workload"}
    for f, v in s._asdict().items():
        if f == "key":
            assert v.dtype == torch.int64
        elif f in ints:
            assert v.dtype == torch.int32, f
        else:
            assert v.dtype == torch.float32, f


def test_signals_and_cap_schedule_match_reference():
    import jax.numpy as jnp
    from repro import scenarios as RS
    from repro_torch import scenarios as PS

    ts = [0.0, 1.0, 59.5, 3600.0, 43_210.0, 86_399.0, 200_000.0]
    vals = np.linspace(200.0, 500.0, 17)
    pairs = [
        (RS.sinusoid(380.0, 120.0, 86_400.0, 1.3, noise_amp=12.0,
                     noise_seed=4.0),
         PS.sinusoid(380.0, 120.0, 86_400.0, 1.3, noise_amp=12.0,
                     noise_seed=4.0)),
        (RS.from_trace(vals, 900.0, 600.0), PS.from_trace(vals, 900.0, 600.0)),
        (RS.constant(7.5), PS.constant(7.5)),
    ]
    for rsig, psig in pairs:
        for t in ts:
            want = float(RS.eval_signal(rsig, jnp.float32(t)))
            got = float(PS.eval_signal(psig, torch.tensor(t)))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=f"t={t}")
    rcap = RS.cap_events([100.0, 500.0], [400.0, 900.0], [5e5, 3e5],
                         base_cap_w=8e5, n_events=3)
    pcap = PS.cap_events([100.0, 500.0], [400.0, 900.0], [5e5, 3e5],
                         base_cap_w=8e5, n_events=3)
    for t in [0.0, 100.0, 399.0, 400.0, 600.0, 900.0, 1e4]:
        for rf, pf in ((RS.power_cap_at, PS.power_cap_at),
                       (RS.next_cap_event, PS.next_cap_event)):
            assert float(pf(pcap, torch.tensor(t))) == float(
                rf(rcap, jnp.float32(t))), (rf.__name__, t)


def test_supercloud_csv_loader_matches_reference(tmp_path):
    from repro.data import load_supercloud as ref_load
    from repro_torch.data import load_supercloud, write_supercloud_csvs

    cfg_r, cfg_p = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    path = write_supercloud_csvs(str(tmp_path), cfg_p, 20, 1200.0, seed=4)
    rj, rb = ref_load(path, cfg_r)
    pj, pb = load_supercloud(path, cfg_p)
    for k in rj:
        np.testing.assert_array_equal(pj[k], rj[k], err_msg=k)
    for k in rb:
        np.testing.assert_array_equal(pb[k], rb[k], err_msg=k)
