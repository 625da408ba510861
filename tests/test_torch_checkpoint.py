"""The port's durable substrate on the CPU: crash-atomic checkpoints
(``repro_torch.checkpoint.ckpt``) in the JAX package's format, the
invariant harness (``repro_torch.utils.invariants``) against the JAX
package's checkify suite, and the kill-loop's semantics
(``repro_torch.utils.chaos``).

- The checkpoint cases of ``tests/test_checkpoint.py`` on port trees that
  hold f32, int32, int64 key words, bool, bfloat16 and ``None`` leaves;
  a tree either package writes restores in the other with equal bytes.
- The invariant cases of ``tests/test_invariants.py``: gating, a clean
  state, eight corruptions (each also caught by the JAX package's
  checkify), a batch with one bad replica, ``run_episode`` per tick and
  macro with faults on and on a corrupt state, the ``run_fleet`` audit;
  with the gate off a corrupt state sails through and an episode runs
  the aten operations of a bare ``make_step`` loop.
- The three fast ``chaos_run`` cases of ``tests/test_chaos.py``, and its
  two SIGKILL cases (``slow``, as there) with the workers on the CPU.
"""

import json
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.checkify import JaxRuntimeError

import _torch_parity  # noqa: F401  (one intra-op thread per worker)

import repro.checkpoint as RCK
import repro.configs.sim as rcfg
import repro.core as R
from repro.data import synth_workload
from repro.utils import invariants as RINV
import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import interop
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
from repro_torch.core import sim as PSIM
from repro_torch.core.state import broadcast_state
from repro_torch.utils import invariants
from repro_torch.utils.chaos import ChaosResult, chaos_run, chaos_smoke
from repro_torch.utils.errors import CheckpointError, InvariantError


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g),
                   "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "key": torch.tensor([0, 42], dtype=torch.int64),
        "mask": torch.tensor([True, False, True]),
        "off": None,
    }


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    out = restore(str(tmp_path), 7, _tree(1))
    assert out["off"] is None
    for k in ("step", "key", "mask"):
        _assert_same(out[k], t[k])
    for k in ("w", "b"):
        _assert_same(out["params"][k], t["params"][k])
    meta = json.loads((tmp_path / "step_0000000007" / "manifest.json")
                      .read_text())
    assert meta["leaves"]["params__b"] == {"shape": [4],
                                           "dtype": "bfloat16"}
    assert meta["leaves"]["key"]["dtype"] == "int64"
    assert sorted(meta["leaves"]) == ["key", "mask", "params__b",
                                      "params__w", "step"]


def test_latest_step_and_gc(tmp_path):
    t = _tree()
    for s in (1, 5, 9, 12):
        save(str(tmp_path), s, t, keep=2)
    assert latest_step(str(tmp_path)) == 12
    kept = sorted(os.listdir(tmp_path))
    assert len([d for d in kept if d.startswith("step_")]) == 2


def test_no_tmp_dir_left_behind(tmp_path):
    save(str(tmp_path), 3, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, {"w": torch.zeros(5)})


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    t = _tree()
    ck.save(4, t)
    ck.wait()
    assert latest_step(str(tmp_path)) == 4
    _assert_same(restore(str(tmp_path), 4, t)["params"]["w"],
                 t["params"]["w"])


def test_missing_manifest_raises_checkpoint_error(tmp_path):
    with pytest.raises(CheckpointError, match="manifest"):
        restore(str(tmp_path), 9, {"w": torch.zeros(2)})


def test_corrupt_manifest_raises_checkpoint_error(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with open(tmp_path / "step_0000000001" / "manifest.json", "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointError, match="manifest"):
        restore(str(tmp_path), 1, {"w": torch.zeros(2)})


def test_manifest_leaf_mismatch_raises_checkpoint_error(tmp_path):
    """A leaf in the template but not in the snapshot is a manifest/leaf
    mismatch, not a silent zero-fill."""
    save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(CheckpointError, match="mismatch"):
        restore(str(tmp_path), 1, {"w": torch.zeros(2),
                                   "extra": torch.zeros(3)})


def test_stale_tmp_dir_is_invisible_and_swept(tmp_path):
    save(str(tmp_path), 2, {"w": torch.zeros(2)})
    stale = tmp_path / "step_0000000007.tmp"
    stale.mkdir()
    (stale / "w.npy").write_bytes(b"torn write")
    assert latest_step(str(tmp_path)) == 2
    assert not stale.exists(), "stale tmp dir should be swept"


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A tree ``repro.checkpoint.save`` writes (f32, bf16, int32, bool, a
    typed key) restores in the port with equal bytes; the key's uint32
    words come back as the port's int64 words, and a numpy template gets
    host arrays."""
    k = jax.random.key(42)
    t = {"params": {"w": jax.random.normal(k, (8, 4)),
                    "b": jnp.arange(4, dtype=jnp.bfloat16)},
         "step": jnp.int32(7), "mask": jnp.array([True, False]), "key": k}
    RCK.save(str(tmp_path), 3, t)
    like = {"params": {"w": torch.zeros(8, 4),
                       "b": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32),
            "mask": torch.zeros(2, dtype=torch.bool),
            "key": torch.zeros(2, dtype=torch.int64)}
    out = restore(str(tmp_path), 3, like)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  np.asarray(t["params"]["w"]))
    np.testing.assert_array_equal(
        out["params"]["b"].view(torch.int16).numpy(),
        np.asarray(t["params"]["b"]).view(np.int16))
    assert int(out["step"]) == 7 and out["mask"].tolist() == [True, False]
    np.testing.assert_array_equal(
        out["key"].numpy(),
        np.asarray(jax.random.key_data(k)).astype(np.int64))
    host = restore(str(tmp_path), 3, {"params": {"w": np.zeros((8, 4),
                                                                np.float32)}})
    np.testing.assert_array_equal(host["params"]["w"],
                                  np.asarray(t["params"]["w"]))


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    """A tree the port writes restores with ``repro.checkpoint.restore``
    with equal bytes (bf16 as JAX's bfloat16)."""
    t = _tree()
    save(str(tmp_path), 5, t)
    like = {"params": {"w": jnp.zeros((8, 4)),
                       "b": jnp.zeros((4,), jnp.bfloat16)},
            "step": jnp.int32(0), "mask": jnp.zeros((3,), bool)}
    out = RCK.restore(str(tmp_path), 5, like)
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]),
                                  t["params"]["w"].numpy())
    assert out["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(out["params"]["b"]).view(np.int16),
        t["params"]["b"].view(torch.int16).numpy())
    assert int(out["step"]) == 7
    np.testing.assert_array_equal(np.asarray(out["mask"]),
                                  [True, False, True])


def test_snapshot_state_restores_across(tmp_path):
    """A ``SimState`` the JAX package snapshots restores in the port as
    numpy and crosses with ``interop.state_from_numpy`` field for field."""
    cfg = rcfg.tiny_cluster(node_mtbf_hours=0.3)
    jobs, bank = synth_workload(cfg, 16, 600.0, seed=0)
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(3)), jobs)
    RCK.save(str(tmp_path), 0, {"state": s})
    pc = pcfg.tiny_cluster(node_mtbf_hours=0.3)
    pst = C.build_statics(pc, bank, device="cpu")
    ps = C.load_jobs(C.init_state(pc, pst, 3), jobs)
    like = {"state": type(ps)(*(v.numpy() for v in ps))}
    got = interop.state_from_numpy(restore(str(tmp_path), 0, like)["state"],
                                   device="cpu")
    for f in ps._fields:
        assert torch.equal(getattr(got, f), getattr(ps, f)), f


# ---------------------------------------------------------- invariants
def _setup(seed=0, **cfg_kw):
    cfg = pcfg.tiny_cluster(**cfg_kw)
    jobs, bank = synth_workload(cfg, 16, 600.0, seed=seed)
    statics = C.build_statics(cfg, bank, device="cpu")
    state = C.load_jobs(C.init_state(cfg, statics, seed), jobs)
    return cfg, statics, state


def _ref_setup(seed=0, **cfg_kw):
    cfg = rcfg.tiny_cluster(**cfg_kw)
    jobs, bank = synth_workload(cfg, 16, 600.0, seed=seed)
    statics = R.build_statics(cfg, bank)
    state = R.load_jobs(R.init_state(cfg, statics, jax.random.key(seed)),
                        jobs)
    return cfg, statics, state


def test_env_gating(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    assert not invariants.enabled()
    monkeypatch.setenv("REPRO_CHECKIFY", "0")
    assert not invariants.enabled()
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    assert invariants.enabled()


def test_clean_state_passes_eagerly():
    cfg, statics, state = _setup()
    invariants.check_state(cfg, statics, state)   # must not raise


def _set(t, idx, v):
    t = t.clone()
    t[idx] = v
    return t


# (corruption on the port's state, the same on the JAX package's, the
# check's message the port must name)
CORRUPTIONS = {
    "free exceeds capacity": (
        lambda s: s._replace(free=s.free + 100.0),
        lambda s: s._replace(free=s.free + 100.0), "exceeds capacity"),
    "negative free": (
        lambda s: s._replace(free=s.free - 1.0),
        lambda s: s._replace(free=s.free - 1.0), "negative free pool"),
    "bad jstate": (
        lambda s: s._replace(jstate=_set(s.jstate, 0, 9)),
        lambda s: s._replace(jstate=s.jstate.at[0].set(9)),
        "EMPTY..FAILED"),
    "node_up": (
        lambda s: s._replace(node_up=_set(s.node_up, 0, 0.5)),
        lambda s: s._replace(node_up=s.node_up.at[0].set(0.5)),
        "node_up not boolean"),
    "NaN energy": (
        lambda s: s._replace(energy_kwh=torch.tensor(float("nan"))),
        lambda s: s._replace(energy_kwh=jnp.float32(jnp.nan)),
        "NaN/Inf in power"),
    "thermal": (
        lambda s: s._replace(rack_outlet_c=s.rack_outlet_c + 1e4),
        lambda s: s._replace(rack_outlet_c=s.rack_outlet_c + 1e4),
        "rack outlet temperature"),
    "lost work": (
        lambda s: s._replace(lost_node_s=torch.tensor(-1.0)),
        lambda s: s._replace(lost_node_s=jnp.float32(-1.0)),
        "negative resilience"),
    "placement without RUNNING": (
        lambda s: s._replace(placement=_set(s.placement, (0, 0), 0)),
        lambda s: s._replace(placement=s.placement.at[0, 0].set(0)),
        "placement/jstate"),
}


@pytest.mark.parametrize("label", sorted(CORRUPTIONS))
def test_corruption_detected(label):
    """Each corruption class fails the port's suite with the JAX package's
    message, and the JAX package's checkify suite on the same state."""
    port, ref, msg = CORRUPTIONS[label]
    cfg, statics, state = _setup()
    with pytest.raises(InvariantError, match=msg) as err:
        invariants.check_state(cfg, statics, port(state))
    assert err.value.tick is None
    rcfg_, rstatics, rstate = _ref_setup()
    with pytest.raises(JaxRuntimeError, match=msg):
        RINV.check_state(rcfg_, rstatics, ref(rstate))


def test_batched_state_checked():
    """The suite broadcasts over a leading replica axis: one corrupt
    replica in a batch fails it, and the error names the replica."""
    cfg, statics, state = _setup()
    batched = broadcast_state(state, 3)
    invariants.check_state(cfg, statics, batched)
    free = batched.free.clone()
    free[1] += 50.0
    with pytest.raises(InvariantError, match=r"replicas \[1\]"):
        invariants.check_state(cfg, statics, batched._replace(free=free))


def test_run_episode_checked_clean(monkeypatch):
    """REPRO_CHECKIFY=1: the suite runs on every committed tick, per tick
    and macro, with faults on; a healthy run passes and returns the same
    bits as the unchecked run."""
    cfg, statics, state = _setup(node_mtbf_hours=0.5, node_repair_hours=0.1)
    plain = C.run_episode(cfg, statics, state, 300, "fcfs",
                          summary_only=True)
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    checked = C.run_episode(cfg, statics, state, 300, "fcfs",
                            summary_only=True)
    for a, b in zip(plain, checked):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    C.run_episode(cfg, statics, state, 300, "fcfs", summary_only=True,
                  macro=True)


@pytest.mark.parametrize("macro", [False, True])
def test_run_episode_checked_catches_corruption(monkeypatch, macro):
    """A corrupt state fails the first check: the error names it and
    the tick, read once at the end of the run. Per tick that is tick 0;
    macro-stepped the suite runs after each macro step (as the JAX
    package's), so the tick is the first macro step's last."""
    from repro_torch.utils import device as PD

    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    cfg, statics, state = _setup()
    bad = state._replace(free=state.free + 100.0)
    PD.reset_host_reads()
    with pytest.raises(InvariantError, match="exceeds capacity") as err:
        C.run_episode(cfg, statics, bad, 10, "fcfs", summary_only=True,
                      macro=macro)
    tick = err.value.tick
    assert f"after tick {tick} " in str(err.value)
    if macro:
        assert 0 <= tick < 10
    else:
        assert tick == 0 and PD.HOST_READS["count"] == 1


def test_run_fleet_posthoc_audit(monkeypatch):
    """REPRO_CHECKIFY=1 ``run_fleet`` audits every replica's final state."""
    from repro_torch.scenarios import default_scenario

    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    cfg, statics, state = _setup(node_mtbf_hours=0.5, node_repair_hours=0.1)
    calls = []
    real = invariants.check_state
    monkeypatch.setattr(invariants, "check_state",
                        lambda *a: calls.append(a[2].t.shape) or real(*a))
    C.run_fleet(cfg, statics, state, 200, "fcfs",
                scenarios=[default_scenario(cfg)] * 2, summary_only=True)
    assert calls == [torch.Size([2])]


def _ops_per_tick(fn) -> int:
    """Non-view aten operations of ``fn(n)`` per tick, as ``tools/
    tick_ops`` counts them: the difference between 6 and 3 ticks, over 3."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False) \
                    and func.namespace != "profiler":
                Count.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for n in (3, 6):
        Count.n = 0
        with Count():
            fn(n)
        counts.append(Count.n)
    return (counts[1] - counts[0]) / 3


def test_disabled_means_zero_overhead_program(monkeypatch):
    """With the gate off a corrupt state sails through, and ``run_episode``
    runs the aten operations of a bare ``make_step`` loop a tick."""
    monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    cfg, statics, state = _setup()
    bad = state._replace(free=state.free + 100.0)
    C.run_episode(cfg, statics, bad, 5, "fcfs", summary_only=True)

    def bare(n):
        step = C.make_step(cfg, statics, "fcfs")
        action = torch.full((), -1, dtype=torch.int64)
        s, acc = state, PSIM._telem_zero(torch.device("cpu"))
        for _ in range(n):
            s, out = step(s, action)
            acc = PSIM._telem_update(acc, out)

    episode = _ops_per_tick(lambda n: C.run_episode(
        cfg, statics, state, n, "fcfs", summary_only=True))
    assert episode == _ops_per_tick(bare) > 0
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    assert _ops_per_tick(lambda n: C.run_episode(
        cfg, statics, state, n, "fcfs", summary_only=True)) > episode


# ---------------------------------------------------------- chaos loop
def test_chaos_run_kill_loop_semantics(tmp_path):
    """The kill-loop on a trivial resumable worker: each launch appends
    one line then either dies or finishes; the loop delivers exactly the
    configured kills, and the final launch is not killed quietly.

    The worker is a POSIX shell script, which writes its line within
    milliseconds of its launch, then completes a snapshot: the kill timer
    starts at that snapshot (``snapshot_dir``), so the killed launch has
    written its line whatever its start-up costs, and the final launch
    has written its line long before it overruns."""
    import shlex

    marker = tmp_path / "progress.txt"
    snaps = tmp_path / "snaps"
    script = tmp_path / "worker.sh"
    script.write_text(textwrap.dedent(f"""
        echo attempt >> {shlex.quote(str(marker))}
        step={shlex.quote(str(snaps))}/step_$$
        mkdir -p "$step.tmp" && : > "$step.tmp/manifest.json"
        mv "$step.tmp" "$step"
        exec sleep 30   # long enough that every kill window hits
    """))
    with pytest.raises(RuntimeError, match="overran"):
        chaos_run(["/bin/sh", str(script)], kills=1, min_delay_s=0.2,
                  max_delay_s=0.4, seed=1, timeout_s=2.0,
                  snapshot_dir=str(snaps))
    assert marker.read_text().count("attempt") == 2  # killed + final


def test_chaos_run_kills_after_the_launchs_first_snapshot(tmp_path):
    """With ``snapshot_dir`` a kill timer starts at the first snapshot the
    launch completes there, not at the launch: a worker that takes 0.5 s
    to start is killed after its snapshot, and the relaunch finds it."""
    snaps = tmp_path / "snaps"
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time
        step = os.path.join({str(snaps)!r}, "step_0000000001")
        if os.path.isdir(step):
            sys.exit(0)     # resumed: the run is done
        time.sleep(0.5)     # start-up
        os.makedirs(step + ".tmp")
        open(os.path.join(step + ".tmp", "manifest.json"), "w").close()
        os.rename(step + ".tmp", step)
        time.sleep(30)
    """))
    res = chaos_run([sys.executable, str(script)], kills=1, min_delay_s=0.1,
                    max_delay_s=0.1, timeout_s=10.0, snapshot_dir=str(snaps))
    first, final = res.attempts
    assert res.n_kills == 1 and first["killed"] and not final["killed"]
    assert 0.5 <= first["first_snapshot_s"] <= first["wall_s"]
    assert final["returncode"] == 0


def test_chaos_run_reports_nonzero_exit(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; print('boom'); sys.exit(3)")
    with pytest.raises(RuntimeError, match="exited 3"):
        chaos_run([sys.executable, str(script)], kills=0)


def test_chaos_result_stats_roundtrip(tmp_path):
    p = tmp_path / "s.json"
    p.write_text(json.dumps({"a": 1}))
    assert ChaosResult(n_kills=0, stats_path=str(p)).stats() == {"a": 1}


@pytest.mark.slow
def test_replay_survives_sigkill_mid_write(tmp_path):
    """A macro replay (faults and serving on) on the CPU is SIGKILLed
    with the rename window stretched so kills can land mid-write (each
    kill after the launch's first snapshot); the resumed run's state and
    telemetry digests and summary() reprs equal the uninterrupted run's,
    and its final launch resumed from a snapshot."""
    out = chaos_smoke("replay", str(tmp_path), kills=1, seed=0,
                      slow_save_s=0.2, n_steps=400, snapshot_every_s=60.0,
                      device="cpu")
    assert out["n_kills"] == 1
    assert out["attempts"][-1]["killed"] is False
    assert out["resumed_from"] > 0


@pytest.mark.slow
def test_ppo_survives_sigkill(tmp_path):
    """The same for PPO training: killed mid-run, resumed from the newest
    checkpoint, the params digest and the history's tail are the
    uninterrupted run's."""
    out = chaos_smoke("ppo", str(tmp_path), kills=1, seed=0, iters=6,
                      ckpt_every=2, device="cpu")
    assert out["n_kills"] == 1
    assert out["attempts"][-1]["returncode"] == 0
    assert out["resumed_from"] is not None
