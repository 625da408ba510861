"""Episode parity on ``tiny_cluster``: the port's step and episode runner
against the JAX package across the full 5 x 5 selection x placement grid,
the three telemetry modes, the macro-stepped episode, and the RL-driven
step.

On the JAX side the grid runs through ONE jitted runner taking a
``make_policy`` Policy argument (policy-as-data), so the 25 cases share a
compile; ``tests/test_placement.py`` holds that mode equal to the
reference's string modes. Integer state matches exactly, floats to 1e-5.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_summary_close,
    assert_tree_close,
    make_pair,
    ref_numpy,
)

import repro.configs.sim as rcfg
import repro.core as R
from repro.core.placement import make_policy
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch.utils.errors import ConfigError

SELECTS = ["replay", "fcfs", "sjf", "priority", "easy"]
PLACES = ["first_fit", "best_fit", "spread", "partition", "green"]
N_TICKS = 200


@pytest.fixture(scope="module")
def pair():
    # short jobs (mean 150 s) so completions happen inside the window
    return make_pair(rcfg.tiny_cluster(), pcfg.tiny_cluster(), 48, 600.0,
                     seed=3, mean_dur_s=150.0)


@pytest.fixture(scope="module")
def ref_grid_runner(pair):
    cfg = rcfg.tiny_cluster()
    rst = pair[0]
    return jax.jit(lambda pol, s: R.run_episode(cfg, rst, s, N_TICKS, pol,
                                                summary_only=True))


def test_policy_grid_is_the_reference_grid():
    assert list(C.SCHEDULERS) == list(R.SCHEDULERS) == SELECTS
    assert list(C.PLACEMENTS) == list(R.PLACEMENTS) == PLACES


@pytest.mark.parametrize("sel,place", list(itertools.product(SELECTS, PLACES)))
def test_grid_matches_reference(pair, ref_grid_runner, sel, place):
    _, rs, pst, ps, _, _ = pair
    rf, rt = ref_grid_runner(make_policy(sel, place), rs)
    pf, pt = C.run_episode(pcfg.tiny_cluster(), pst, ps, N_TICKS, sel,
                           placement=place, summary_only=True)
    tag = f"{sel}+{place}"
    assert_tree_close(rf, pf, tag)
    assert_tree_close(rt, pt, f"{tag}.telemetry")
    assert_summary_close(R.summary(rf, rt), C.summary(pf, pt), tag)


@pytest.mark.parametrize("sel,place", [("fcfs", "first_fit"),
                                       ("easy", "partition")])
def test_stacked_stepout_matches_tick_by_tick(pair, sel, place):
    cfg, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    rf, ro = jax.jit(lambda s: R.run_episode(cfg, rst, s, 150, sel,
                                             placement=place))(rs)
    pf, po = C.run_episode(pc, pst, ps, 150, sel, placement=place)
    assert po.facility_w.shape == (150,)
    assert_tree_close(ro, po, f"{sel}+{place}.stepout")
    assert_tree_close(rf, pf, f"{sel}+{place}.state")


def test_windowed_telemetry_matches(pair):
    cfg, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    rf, rw = jax.jit(lambda s: R.run_episode(cfg, rst, s, 200, "sjf",
                                             telemetry_every=25))(rs)
    pf, pw = C.run_episode(pc, pst, ps, 200, "sjf", telemetry_every=25)
    assert pw.mean_facility_w.shape == (8,)
    assert pw.srv_lat_hist.shape == (8, 8)
    assert_tree_close(rw, pw, "windows")
    assert_tree_close(rf, pf, "state")
    assert_summary_close(R.summary(rf, rw), C.summary(pf, pw), "summary")


def test_rl_step_follows_scripted_actions(pair):
    """make_step(..., "rl") against the reference for a scripted action
    sequence: candidate picks, out-of-range picks and the no-op (k)."""
    cfg, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    k = cfg.sched_max_candidates
    actions = [0, 1, k, 2, 0, 3, k, 1] * 25
    rstep = jax.jit(R.make_step(cfg, rst, "rl", placement="best_fit"))
    pstep = C.make_step(pc, pst, "rl", placement="best_fit")
    for i, a in enumerate(actions):
        rs, ro = rstep(rs, jnp.int32(a))
        ps, po = pstep(ps, a)
        assert_tree_close(ro, po, f"tick {i} stepout")
        np.testing.assert_array_equal(
            np.asarray(R.schedulers.rl_candidates(cfg, rs)),
            C.schedulers.rl_candidates(pc, ps).numpy(), err_msg=f"tick {i}")
    assert_tree_close(rs, ps, "final state")
    assert float(ref_numpy(rs).n_completed) > 0


def test_none_scheduler_only_runs_the_clock(pair):
    cfg, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    rf, _ = jax.jit(lambda s: R.run_episode(cfg, rst, s, 40, "none"))(rs)
    pf, _ = C.run_episode(pc, pst, ps, 40, "none")
    assert_tree_close(rf, pf, "state")
    assert int((pf.jstate == C.RUNNING).sum()) == 0


def test_macro_episode_runs_and_matches_reference(pair):
    """``macro=True`` runs: the episode-wide summary of the macro path
    (stacked ``StepOut`` summarises, as in the JAX package), its state
    and telemetry against the JAX package's macro episode, and its state
    bitwise equal to the port's per-tick episode
    (``tests/test_torch_macro.py`` holds the rest)."""
    cfg, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, pst, ps, _, _ = pair
    rf, rt = jax.jit(lambda s: R.run_episode(cfg, rst, s, N_TICKS, "fcfs",
                                             macro=True))(rs)
    pf, pt = C.run_episode(pc, pst, ps, N_TICKS, "fcfs", macro=True)
    assert isinstance(pt, C.TelemetrySummary)
    assert_tree_close(rf, pf, "state")
    assert_tree_close(rt, pt, "telemetry")
    per_tick, _ = C.run_episode(pc, pst, ps, N_TICKS, "fcfs",
                                summary_only=True)
    for f in pf._fields:
        assert torch.equal(getattr(pf, f), getattr(per_tick, f)), f


@pytest.mark.parametrize("kw,err,match", [
    (dict(snapshot_every_s=60.0, snapshot_dir="x"), NotImplementedError,
     "durable"),
    (dict(resume_from="x"), NotImplementedError, "durable"),
    (dict(summary_only=True, telemetry_every=5), ConfigError, "summary_only"),
    (dict(telemetry_every=7), ConfigError, "divisible"),
    (dict(reward_weights=(1, 1, 1, 0.05, 0, 0.5, 1.0, 1.0)), ConfigError,
     "4 to 7"),
])
def test_run_episode_refuses_what_the_slice_lacks(pair, kw, err, match):
    _, _, pst, ps, _, _ = pair
    with pytest.raises(err, match=match):
        C.run_episode(pcfg.tiny_cluster(), pst, ps, 20, "fcfs", **kw)


def test_policy_scheduler_raises(pair):
    """A Policy runs as the scheduler (``tests/test_torch_fleet.py`` holds
    it to the reference); what is neither a name nor a Policy, or a Policy
    beside ``placement=``, raises."""
    from repro_torch.core.placement import make_policy

    _, _, pst, _, _, _ = pair
    with pytest.raises(KeyError, match="unknown scheduler"):
        C.make_step(pcfg.tiny_cluster(), pst, (0, 0))
    with pytest.raises(ConfigError, match="placement"):
        C.make_step(pcfg.tiny_cluster(), pst, make_policy("fcfs", "spread"),
                    placement="spread")
