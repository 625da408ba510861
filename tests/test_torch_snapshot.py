"""The port's durable contract on the CPU (``tests/test_snapshot.py``),
and the slice held to the JAX package (the SIGKILL cases are in
``tests/test_torch_checkpoint.py``).

Inside the port, bit for bit: a snapshotted run equals the plain one
(macro-stepped: the state, and the telemetry but ``macro_steps``); kill
after any snapshot, resume, and the final ``SimState`` (key words
included), ``TelemetrySummary`` and ``summary()`` equal the uninterrupted
snapshotted run's, over {base, thermal, faults+serving} x {per tick,
macro}, for a fleet of 3 with its own fault clocks, and for PPO. Against
the JAX package's uninterrupted run of the same inputs
(``_torch_parity``: integers exact, floats to ``RTOL``): each resumed
episode and the resumed fleet; and a snapshot the JAX package writes
mid-run, resumed in the port, against the JAX package's whole run. The
resumed PPO against the JAX package's is in ``tests/test_torch_ppo.py``.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_state_close,
    assert_tree_close,
    make_pair,
)

import repro.checkpoint as RCK
import repro.configs.sim as rcfg
import repro.core as R
from repro.core import sim as RSIM
from repro.data import synth_workload
from repro.scenarios import default_scenario as ref_default_scenario
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import interop
from repro_torch.checkpoint import restore
from repro_torch.core import sim as PSIM
from repro_torch.utils import device as PD
from repro_torch.utils.errors import CheckpointError, ConfigError
from repro_torch.utils.tree import tree_leaves_with_names

N_STEPS = 400
SNAP_S = 100.0     # the kill-and-resume cases' interval: four equal segments
VARIANTS = {
    "base": {},
    "thermal": {"thermal_enabled": True},
    "faults+serving": {"node_mtbf_hours": 0.3, "serving_enabled": True,
                       "serving_nodes": 4},
}
CASES = [(v, m) for v in VARIANTS for m in (False, True)]
FLEET_E = 3
_cache = {}


def _pair(variant):
    """(ref cfg, ref statics, ref state, port cfg, port statics, port
    state): 32 jobs over 1200 s on ``tiny_cluster``, key 0."""
    if variant not in _cache:
        rc = rcfg.tiny_cluster(**VARIANTS[variant])
        pc = pcfg.tiny_cluster(**VARIANTS[variant])
        rst, rs, pst, ps, _, _ = make_pair(rc, pc, 32, 1200.0, 0)
        _cache[variant] = (rc, rst, rs, pc, pst, ps)
    return _cache[variant]


def _setup(variant):
    return _pair(variant)[3:]


def _mode(macro):
    return dict(macro=True) if macro else dict(summary_only=True)


def _reference(variant, macro):
    """The port's plain (snapshot-free) run, memoised."""
    key = ("plain", variant, macro)
    if key not in _cache:
        cfg, statics, state = _setup(variant)
        _cache[key] = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                                    **_mode(macro))
    return _cache[key]


def _assert_tree_equal(a, b, what, allow=()):
    la, lb = tree_leaves_with_names(a), tree_leaves_with_names(b)
    assert [n for n, _ in la] == [n for n, _ in lb], what
    for (name, x), (_, y) in zip(la, lb):
        if not torch.equal(x, y) and not any(t in name for t in allow):
            raise AssertionError(f"{what}: leaf {name} differs")


def _kill_after_first_snapshot(snapshot_dir):
    snaps = sorted(os.listdir(snapshot_dir))
    assert len(snaps) > 1, "need >1 snapshot to simulate a mid-run kill"
    for s in snaps[1:]:
        shutil.rmtree(os.path.join(snapshot_dir, s))


def test_per_tick_snapshotting_is_invisible(tmp_path):
    """summary_only, per tick: snapshotted == plain, bitwise (state,
    telemetry, summary); one counted read for the fingerprint and one a
    snapshot."""
    cfg, statics, state = _setup("base")
    fs0, t0 = _reference("base", macro=False)
    PD.reset_host_reads()
    fs1, t1 = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                            summary_only=True, snapshot_every_s=120.0,
                            snapshot_dir=str(tmp_path))
    assert PD.HOST_READS["count"] == 1 + 4
    _assert_tree_equal(fs0, fs1, "SimState")
    _assert_tree_equal(t0, t1, "TelemetrySummary")
    assert C.summary(fs0) == C.summary(fs1)


def test_macro_snapshotting_state_bitwise(tmp_path):
    """Macro-stepped: a snapshot's edge clamps the fast-forward as a
    telemetry window's does, so the state stays bitwise; only the
    ``macro_steps`` count may differ."""
    cfg, statics, state = _setup("base")
    fs0, t0 = _reference("base", macro=True)
    fs1, t1 = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                            macro=True, snapshot_every_s=150.0,
                            snapshot_dir=str(tmp_path))
    _assert_tree_equal(fs0, fs1, "SimState")
    _assert_tree_equal(t0, t1, "TelemetrySummary", allow=("macro_steps",))
    assert C.summary(fs0) == C.summary(fs1)


def _killed_and_resumed(variant, macro, tmp):
    """(uninterrupted snapshotted run, the run killed after its first
    snapshot and resumed), memoised."""
    key = ("resumed", variant, macro)
    if key not in _cache:
        cfg, statics, state = _setup(variant)
        full = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                             snapshot_every_s=SNAP_S, snapshot_dir=str(tmp),
                             snapshot_keep=99, **_mode(macro))
        _kill_after_first_snapshot(str(tmp))
        resumed = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                                snapshot_every_s=SNAP_S,
                                resume_from=str(tmp), **_mode(macro))
        _cache[key] = full, resumed
    return _cache[key]


@pytest.mark.parametrize("variant,macro", CASES)
def test_kill_and_resume_is_bit_identical(variant, macro, tmp_path):
    """Kill after a snapshot, resume from the newest: the final SimState
    (key words included), TelemetrySummary and summary() equal the
    uninterrupted snapshotted run's, bit for bit."""
    (fs1, t1), (fs2, t2) = _killed_and_resumed(variant, macro, tmp_path)
    _assert_tree_equal(fs1, fs2, f"SimState[{variant}, macro={macro}]")
    _assert_tree_equal(t1, t2, f"TelemetrySummary[{variant}, "
                       f"macro={macro}]")
    assert C.summary(fs1, t1) == C.summary(fs2, t2)


@pytest.mark.parametrize("variant,macro", CASES)
def test_resumed_run_matches_the_jax_package(variant, macro,
                                             tmp_path_factory):
    """The port's killed-and-resumed run against the JAX package's
    uninterrupted run of the same inputs (integers exact, floats to
    RTOL). Macro-stepped, the telemetry's ``macro_steps`` is held to the
    JAX package's run snapshotted at the same interval: the segment
    edges add the same event ticks in both packages."""
    tmp = tmp_path_factory.mktemp(f"jax_{variant.replace('+', '_')}")
    _, (fs, ts) = _killed_and_resumed(variant, macro, tmp)
    rc, rst, rs = _pair(variant)[:3]
    rf, rt = R.run_episode(rc, rst, rs, N_STEPS, "fcfs", **_mode(macro))
    assert_state_close(rf, fs, f"state[{variant}, macro={macro}]")
    assert_tree_close(rt, ts, f"telemetry[{variant}, macro={macro}]",
                      skip=("macro_steps",) if macro else ())
    if macro:
        _, rst_snap = R.run_episode(
            rc, rst, rs, N_STEPS, "fcfs", macro=True,
            snapshot_every_s=SNAP_S,
            snapshot_dir=str(tmp_path_factory.mktemp("jax_snap")))
        assert float(rst_snap.macro_steps) == float(ts.macro_steps)
        assert float(rt.macro_steps) < float(ts.macro_steps)


def test_resume_from_empty_dir_runs_from_scratch(tmp_path):
    """A kill before the first snapshot leaves nothing on disk; resume
    starts from t = 0 and still equals the plain run."""
    cfg, statics, state = _setup("base")
    fs0, t0 = _reference("base", macro=False)
    fs1, t1 = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                            summary_only=True, resume_from=str(tmp_path))
    _assert_tree_equal(fs0, fs1, "SimState")
    _assert_tree_equal(t0, t1, "TelemetrySummary")


def test_infinite_interval_snapshots_once_at_end(tmp_path):
    """snapshot_every_s=inf never cuts the episode: one segment, one
    final snapshot, results bitwise equal to the plain run."""
    cfg, statics, state = _setup("base")
    fs0, t0 = _reference("base", macro=False)
    fs1, t1 = C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                            summary_only=True, snapshot_every_s=math.inf,
                            snapshot_dir=str(tmp_path))
    _assert_tree_equal(fs0, fs1, "SimState")
    _assert_tree_equal(t0, t1, "TelemetrySummary")
    assert sorted(os.listdir(tmp_path)) == [f"step_{N_STEPS:010d}"]


def _fleet_runs(tmp):
    """(plain fleet, uninterrupted snapshotted fleet, the snapshotted fleet
    killed after its first snapshot and resumed): 3 replicas of
    faults+serving, memoised."""
    from repro_torch.scenarios import default_scenario

    if "fleet" not in _cache:
        cfg, statics, state = _setup("faults+serving")
        kw = dict(scenarios=[default_scenario(cfg)] * FLEET_E,
                  summary_only=True)
        plain = C.run_fleet(cfg, statics, state, N_STEPS, "fcfs", **kw)
        full = C.run_fleet(cfg, statics, state, N_STEPS, "fcfs",
                           snapshot_every_s=120.0, snapshot_dir=str(tmp),
                           snapshot_keep=99, **kw)
        _kill_after_first_snapshot(str(tmp))
        resumed = C.run_fleet(cfg, statics, state, N_STEPS, "fcfs",
                              snapshot_every_s=120.0, resume_from=str(tmp),
                              **kw)
        _cache["fleet"] = plain, full, resumed
    return _cache["fleet"]


def test_fleet_kill_and_resume(tmp_path):
    """A fleet's snapshot holds the whole batch with its keys installed,
    so a killed sweep resumes to the exact per-replica results; with the
    fault engine on, each replica's clocks come from those keys."""
    (fs0, t0), (fs1, t1), (fs2, t2) = _fleet_runs(tmp_path)
    _assert_tree_equal(fs0, fs1, "fleet SimState vs plain")
    _assert_tree_equal(t0, t1, "fleet telemetry vs plain")
    assert not torch.equal(fs1.key[0], fs1.key[1])
    _assert_tree_equal(fs1, fs2, "fleet SimState killed+resumed")
    _assert_tree_equal(t1, t2, "fleet telemetry killed+resumed")


def test_resumed_fleet_matches_the_jax_package(tmp_path_factory):
    """The port's killed-and-resumed fleet against the JAX package's
    uninterrupted ``run_fleet`` of the same inputs: the replicas' keys,
    their fault clocks and results (integers exact, floats to RTOL)."""
    _, _, (fs, ts) = _fleet_runs(tmp_path_factory.mktemp("fleet"))
    rc, rst, rs = _pair("faults+serving")[:3]
    rf, rt = R.run_fleet(rc, rst, rs, N_STEPS, "fcfs",
                         scenarios=[ref_default_scenario(rc)] * FLEET_E,
                         summary_only=True)
    assert fs.t.shape == (FLEET_E,)
    assert_state_close(rf, fs, "fleet state")
    assert_tree_close(rt, ts, "fleet telemetry")


def test_fingerprint_mismatch_raises_typed_error(tmp_path):
    """Resuming with another scheduler or n_steps names the component in
    a CheckpointError (a ValueError too)."""
    cfg, statics, state = _setup("base")
    C.run_episode(cfg, statics, state, N_STEPS, "fcfs", summary_only=True,
                  snapshot_every_s=120.0, snapshot_dir=str(tmp_path))
    with pytest.raises(CheckpointError, match="scheduler"):
        C.run_episode(cfg, statics, state, N_STEPS, "sjf",
                      summary_only=True, resume_from=str(tmp_path))
    with pytest.raises(ValueError, match="n_steps"):
        C.run_episode(cfg, statics, state, N_STEPS + 1, "fcfs",
                      summary_only=True, resume_from=str(tmp_path))


def test_snapshot_kwargs_validated(tmp_path):
    """Snapshotting needs an episode-wide accumulator and a positive
    interval; both misuses are ConfigErrors that write nothing."""
    cfg, statics, state = _setup("base")
    d = str(tmp_path / "nope")
    with pytest.raises(ConfigError, match="summary_only"):
        C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                      snapshot_every_s=120.0, snapshot_dir=d)
    with pytest.raises(ConfigError, match="summary_only"):
        C.run_episode(cfg, statics, state, N_STEPS, "fcfs", macro=True,
                      telemetry_every=10, snapshot_every_s=120.0,
                      snapshot_dir=d)
    with pytest.raises(ConfigError, match="positive"):
        C.run_episode(cfg, statics, state, N_STEPS, "fcfs",
                      summary_only=True, snapshot_every_s=0.0,
                      snapshot_dir=d)
    assert not os.path.exists(d)


def test_ppo_exact_resume(tmp_path):
    """``ppo_train`` checkpoints the whole training state: stopped after
    iteration 3 and resumed, params and the history's tail equal the
    uninterrupted run's bit for bit; another seed raises. (The resumed
    run against the JAX package's: ``tests/test_torch_ppo.py``.)"""
    from repro_torch.envs import SchedEnv
    from repro_torch.rl import PPOConfig, ppo_train

    cfg = pcfg.tiny_cluster(sched_max_candidates=4)
    wls = [synth_workload(cfg, 24, 900.0, seed=s) for s in range(2)]
    env = SchedEnv(cfg, wls, episode_steps=8, sim_steps_per_action=5,
                   device="cpu")
    pcfg_ = PPOConfig(n_envs=4, rollout_len=8, n_epochs=2, n_minibatches=2)
    d_full, d_cut = str(tmp_path / "full"), str(tmp_path / "cut")
    p_full, h_full = ppo_train(env, cfg=pcfg_, n_iterations=6,
                               checkpoint_dir=d_full, checkpoint_every=2)
    ppo_train(env, cfg=pcfg_, n_iterations=4, checkpoint_dir=d_cut,
              checkpoint_every=2)
    p_res, h_res = ppo_train(env, cfg=pcfg_, n_iterations=6,
                             checkpoint_dir=d_cut, checkpoint_every=2,
                             resume=True)
    _assert_tree_equal(p_full, p_res, "PPO params")
    assert h_full[4:] == h_res
    with pytest.raises(CheckpointError, match="seed"):
        ppo_train(env, cfg=pcfg_, n_iterations=6, seed=1,
                  checkpoint_dir=d_cut, checkpoint_every=2, resume=True)


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """The JAX package runs 200 macro ticks of faults+serving through
    ``run_segment`` and snapshots them; the port restores the snapshot
    into numpy, carries it across (``interop``), runs 200 more and
    finalises: held to the JAX package's uninterrupted 400 ticks."""
    rc, rst, rs, pc, pst, ps = _pair("faults+serving")
    acc0 = RSIM._telem_zero(rc.resilience_on, rc.serving_on)
    s200, a200 = RSIM.run_segment(rc, rst, rs, acc0, 200, "fcfs",
                                  macro=True)
    RCK.save(str(tmp_path), 200, {"state": s200, "acc": a200})

    def numpy_like(tree):
        return type(tree)(*(None if v is None else v.numpy() for v in tree))

    like = {"state": numpy_like(ps),
            "acc": numpy_like(PSIM._telem_zero(torch.device("cpu"), (),
                                               pc.resilience_on,
                                               pc.serving_on))}
    host = restore(str(tmp_path), 200, like)
    state = interop.state_from_numpy(host["state"], device="cpu")
    acc = PSIM.TelemetrySummary(*(None if v is None else torch.from_numpy(
        np.array(v)) for v in host["acc"]))
    fs, ta = C.run_segment(pc, pst, state, acc, 200, "fcfs", macro=True)
    ts = PSIM._telem_finalize(ta)
    rf, rt = R.run_episode(rc, rst, rs, N_STEPS, "fcfs", macro=True)
    assert_state_close(rf, fs, "state")
    assert_tree_close(rt, ts, "telemetry", skip=("macro_steps",))
