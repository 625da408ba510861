"""The thermal twin at the full TX-GAIA size (672 nodes, 21 racks, the
256 x 16 job table): the stress case's first 900 ticks field by field
against the reference (by tick 900 the trip has gated dispatch and the
throttle has fired), and the pinned ``replay_tx_gaia_1h_thermal[_stress]``
values that ``chip_smoke.py`` holds the card to, against live reference
runs and against the port's own CPU path."""

import jax
import pytest

from _torch_parity import (
    RTOL,
    assert_pins,
    assert_state_close,
    assert_summary_close,
    assert_tree_close,
)

import repro.configs.sim as rcfg
import repro.core as R
import repro_torch.core as C
from repro_torch.configs import acceptance

THERMAL_CASES = ["replay_tx_gaia_1h_thermal", "replay_tx_gaia_1h_thermal_stress"]


def _ref_setup(case):
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                       **acceptance.CASES[case])
    jobs, bank = acceptance.workload(acceptance.config(case))
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(acceptance.SEED)),
                    jobs)
    return cfg, st, s


def _port_setup(case):
    cfg = acceptance.config(case)
    jobs, bank = acceptance.workload(cfg)
    st = C.build_statics(cfg, bank, device="cpu")
    return cfg, st, C.load_jobs(C.init_state(cfg, st, acceptance.SEED), jobs)


def test_stress_first_900_ticks_match_reference():
    case = "replay_tx_gaia_1h_thermal_stress"
    rc, rst, rs = _ref_setup(case)
    pc, pst, ps = _port_setup(case)
    rf, rt = jax.jit(lambda s: R.run_episode(
        rc, rst, s, 900, acceptance.SCHEDULER, summary_only=True))(rs)
    pf, pt = C.run_episode(pc, pst, ps, 900, acceptance.SCHEDULER,
                           summary_only=True)
    assert float(pf.peak_rack_c) >= pc.thermal_trip_c
    assert float(pf.thermal_throttle_s) == 320.0
    assert float(pf.n_completed) == 6.0
    assert_state_close(rf, pf, "state")
    assert_tree_close(rt, pt, "telemetry")
    assert_summary_close(R.summary(rf, rt), C.summary(pf, pt), "summary")


@pytest.mark.parametrize("case", THERMAL_CASES)
def test_pinned_values_are_a_live_reference_run(case):
    cfg, st, s = _ref_setup(case)
    fs, tel = jax.jit(lambda s: R.run_episode(
        cfg, st, s, acceptance.N_STEPS, acceptance.SCHEDULER,
        summary_only=True))(s)
    assert_pins(R.summary(fs, tel), case, "reference")


def test_port_cpu_path_reproduces_stress_pins():
    case = "replay_tx_gaia_1h_thermal_stress"
    cfg, st, s = _port_setup(case)
    fs, tel = C.run_episode(cfg, st, s, acceptance.N_STEPS,
                            acceptance.SCHEDULER, summary_only=True)
    got = C.summary(fs, tel)
    assert_pins(got, case, "port (CPU)")
    acceptance.check(case, got)


def test_acceptance_check_refuses_a_miss():
    case = "replay_tx_gaia_1h_thermal_stress"
    good = dict(acceptance.PINNED[case])
    acceptance.check(case, good)
    for k, bump in (("completed", 1.0), ("thermal_throttle_s", 1.0),
                    ("energy_kwh", 1e-2)):
        with pytest.raises(AssertionError, match=k):
            acceptance.check(case, {**good, k: good[k] + bump})
    assert RTOL == acceptance.RTOL
