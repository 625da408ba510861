"""The main path at the full TX-GAIA size (672 nodes, 256 x 16 job table):
the port against the reference run with its Pallas power-scatter kernel
(interpret mode), and the pinned ``replay_tx_gaia_1h`` values that
``chip_smoke.py`` holds the card to, against a live reference run and
against the port's own CPU path."""

import jax
import pytest

from _torch_parity import (
    assert_pins,
    assert_summary_close,
    assert_tree_close,
    make_pair,
)

import repro.configs.sim as rcfg
import repro.core as R
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch.configs import acceptance


@pytest.fixture(scope="module")
def tx_pair():
    kw = dict(max_jobs=256, max_nodes_per_job=16)
    return make_pair(rcfg.tx_gaia(**kw), pcfg.tx_gaia(**kw), 64, 300.0,
                     seed=1)


@pytest.mark.parametrize("sel", ["replay", "easy"])
def test_tx_gaia_slice_matches_reference_kernel_path(tx_pair, sel):
    kw = dict(max_jobs=256, max_nodes_per_job=16)
    rcfg_, pcfg_ = rcfg.tx_gaia(**kw), pcfg.tx_gaia(**kw)
    rst, rs, pst, ps, _, _ = tx_pair
    rf, rt = jax.jit(lambda s: R.run_episode(
        rcfg_, rst, s, 300, sel, summary_only=True,
        use_power_kernel=True))(rs)
    pf, pt = C.run_episode(pcfg_, pst, ps, 300, sel, summary_only=True)
    assert float(pt.mean_running) > 0
    assert_tree_close(rf, pf, sel)
    assert_tree_close(rt, pt, f"{sel}.telemetry")
    assert_summary_close(R.summary(rf, rt), C.summary(pf, pt), sel)


def _acceptance_inputs(cfg_mod):
    cfg = cfg_mod.tx_gaia(max_jobs=256, max_nodes_per_job=16)
    assert cfg == acceptance.config() or cfg_mod is rcfg
    jobs, bank = acceptance.workload(acceptance.config())
    return cfg, jobs, bank


def test_pinned_values_are_a_live_reference_run():
    cfg, jobs, bank = _acceptance_inputs(rcfg)
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(acceptance.SEED)),
                    jobs)
    fs, tel = jax.jit(lambda s: R.run_episode(
        cfg, st, s, acceptance.N_STEPS, acceptance.SCHEDULER,
        summary_only=True))(s)
    assert_pins(R.summary(fs, tel), "replay_tx_gaia_1h", "reference")


def test_port_cpu_path_reproduces_pinned_values():
    cfg, jobs, bank = _acceptance_inputs(pcfg)
    st = C.build_statics(cfg, bank, device="cpu")
    s = C.load_jobs(C.init_state(cfg, st, acceptance.SEED), jobs)
    fs, tel = C.run_episode(cfg, st, s, acceptance.N_STEPS,
                            acceptance.SCHEDULER, summary_only=True)
    assert_pins(C.summary(fs, tel), "replay_tx_gaia_1h", "port (CPU)")
