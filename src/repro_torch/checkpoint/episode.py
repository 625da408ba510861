"""Mid-episode snapshot and resume of ``run_episode`` / ``run_fleet``,
as the JAX package's ``repro/checkpoint/episode.py`` does it.

A long replay or fleet sweep dies to preemption hours in; this module
makes it durable without touching the tick. The episode is cut on the
host into segments of ``round(snapshot_every_s / cfg.dt)`` ticks, each
run by ``sim.run_segment`` with a RAW (un-finalised) telemetry
accumulator, and after every segment a crash-atomic checkpoint
(``checkpoint.ckpt``: write, then rename) holds

    {"state": SimState (the PRNG key words included), "acc": the raw
     accumulator}

with the segment's tick count and a run *fingerprint* in its manifest:
digests of the config, the scheduler or policies, the statics, the
caller's job table, the initial key words, ``n_steps`` and the forwarded
keywords (and, for a fleet, the replica count, scenarios and policies).
Resume computes the fingerprint again from the caller's arguments and
refuses, with ``CheckpointError`` naming the components that differ, to
splice a snapshot into another run. An empty or missing directory
resumes from t = 0.

Kill at any snapshot, resume, and the final ``SimState`` (key words
included), ``TelemetrySummary`` and ``summary()`` equal the uninterrupted
run's bit for bit: per-tick segments split the tick loop at tick
boundaries, a segment's edge clamps the macro fast-forward as a
``telemetry_every`` window edge does, the accumulator is finalised once
at the end, and a fleet's keys are derived once (``prepare_fleet``) and
then carried through the snapshots.

On the card the fingerprint and each snapshot are one counted read each
(``utils.device.drain``); nothing else of this module reads the device.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.utils.device import drain
from repro_torch.utils.errors import CheckpointError, ConfigError
from repro_torch.utils.tree import tree_leaves_with_names

FINGERPRINT_SCHEMA = 1

# SimState fields that define the WORKLOAD a run was started with: the job
# table installed by load_jobs and the banked-trace selector
_WORKLOAD_FIELDS = ("submit_t", "dur_est", "n_nodes", "req", "part",
                    "priority", "ckpt_interval", "workload")


def _digest(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def _tree_digest(host_tree: Any) -> str:
    """Order-stable digest over a host tree's leaf names, dtypes, shapes
    and bytes."""
    h = hashlib.sha256()
    for name, leaf in tree_leaves_with_names(host_tree):
        arr, dtype_name = ckpt._to_numpy(leaf)
        h.update(name.encode())
        h.update(dtype_name.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def _sched_token(scheduler) -> str:
    if isinstance(scheduler, str):
        return f"name:{scheduler}"
    # a placement.Policy (possibly batched): host-side int32 ids
    return f"policy:{scheduler.select.tolist()}/{scheduler.place.tolist()}"


def run_fingerprint(kind: str, cfg, scheduler, statics, state, n_steps: int,
                    kw: Dict[str, Any], *,
                    trees: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Component-wise fingerprint of a (fleet) episode's arguments.

    Computed from the CALLER's arguments at the start and again at resume,
    never from a snapshot, so every component is a function of "which run
    was asked for"; kept per component so that a mismatch names the part
    that differs. Every tensor it digests (the statics, the job table, the
    key words, tensor keywords and the ``trees``, each a component of its
    own) reaches the host in one counted read."""
    tensor_kw = {k: v for k, v in kw.items() if isinstance(v, torch.Tensor)}
    host = drain({
        "statics": statics,
        "workload": {f: getattr(state, f) for f in _WORKLOAD_FIELDS},
        "prng": {"key": state.key},
        "kw": tensor_kw,
        "trees": trees or {},
    })
    kw_tokens = tuple(sorted(
        (k, "tensor:" + _tree_digest(host["kw"][k]) if k in tensor_kw
         else repr(v)) for k, v in kw.items()))
    fp = {
        "schema": FINGERPRINT_SCHEMA,
        "kind": kind,
        "cfg": _digest(repr(cfg)),
        "scheduler": _digest(_sched_token(scheduler)),
        "statics": _tree_digest(host["statics"]),
        "workload": _tree_digest(host["workload"]),
        "prng": _tree_digest(host["prng"]),
        "n_steps": int(n_steps),
        "kw": _digest(repr(kw_tokens)),
    }
    fp.update({k: _tree_digest(v) for k, v in host["trees"].items()})
    fp.update(extra or {})
    return fp


def check_fingerprint(saved: Dict[str, Any], want: Dict[str, Any],
                      directory: str) -> None:
    """Raise a ``CheckpointError`` naming every component that differs."""
    bad = sorted(k for k in set(saved) | set(want)
                 if saved.get(k) != want.get(k))
    if bad:
        detail = "; ".join(
            f"{k}: checkpoint={saved.get(k)!r} vs current={want.get(k)!r}"
            for k in bad)
        raise CheckpointError(
            f"snapshot in {directory} belongs to a different run — "
            f"mismatched fingerprint component(s) {bad} ({detail}). "
            "Pass the same cfg/scheduler/statics/workload/seed/n_steps "
            "the snapshot was written with, or point resume_from at the "
            "right directory.", field=",".join(bad))


def _restore_latest(directory: str, like: Dict[str, Any],
                    want_fp: Dict[str, Any]):
    """(tree, ticks) from the newest snapshot, or (None, 0) if none yet:
    a run killed before its first snapshot resumes from t = 0."""
    step = ckpt.latest_step(directory)
    if step is None:
        return None, 0
    meta = ckpt.read_meta(directory, step)
    extra = meta.get("extra", {})
    check_fingerprint(extra.get("fingerprint", {}), want_fp, directory)
    return ckpt.restore(directory, step, like), int(extra["ticks"])


def _snapshot_plan(cfg, n_steps: int, snapshot_every_s, telemetry_every: int,
                   summary_only: bool, macro: bool) -> int:
    """Check the mode and return a segment's length in ticks."""
    if telemetry_every > 1 or not (summary_only or macro):
        raise ConfigError(
            "snapshot/resume needs an episode-wide summary so the "
            "telemetry accumulator can ride in the checkpoint: pass "
            "summary_only=True (or macro=True) and telemetry_every<=1; "
            f"got summary_only={summary_only}, macro={macro}, "
            f"telemetry_every={telemetry_every}")
    if snapshot_every_s is None or not np.isfinite(snapshot_every_s):
        return int(n_steps)
    if snapshot_every_s <= 0:
        raise ConfigError(
            f"snapshot_every_s must be positive (or None/inf to snapshot "
            f"only at episode end), got {snapshot_every_s}")
    return max(1, int(round(float(snapshot_every_s) / float(cfg.dt))))


def _segments(cfg, statics, state, n_steps, scheduler, macro, kw, fp,
              seg_ticks, snapshot_dir, resume_from, snapshot_keep):
    """The segmented drive shared by episodes and fleets: resume, then
    segments with a snapshot after each. Returns (state, finalised
    telemetry)."""
    from repro_torch.core import sim

    acc = sim._telem_zero(state.t.device, tuple(state.t.shape),
                          cfg.resilience_on, cfg.serving_on)
    ticks = 0
    if resume_from is not None:
        tree, ticks = _restore_latest(
            resume_from, {"state": state, "acc": acc}, fp)
        if tree is not None:
            state, acc = tree["state"], tree["acc"]
    if snapshot_dir is None:
        snapshot_dir = resume_from
    while ticks < n_steps:
        n = int(min(seg_ticks, n_steps - ticks))
        state, acc = sim.run_segment(cfg, statics, state, acc, n, scheduler,
                                     macro=macro, **kw)
        ticks += n
        if snapshot_dir is not None:
            ckpt.save(snapshot_dir, ticks, {"state": state, "acc": acc},
                      extra_meta={"ticks": ticks, "fingerprint": fp},
                      keep=snapshot_keep)
    return state, sim._telem_finalize(acc)


def run_episode_snapshotted(
    cfg,
    statics,
    state,
    n_steps: int,
    scheduler,
    *,
    telemetry_every: int,
    summary_only: bool,
    macro: bool,
    snapshot_every_s,
    snapshot_dir: Optional[str],
    resume_from: Optional[str],
    snapshot_keep: int,
    kw: Dict[str, Any],
):
    """``run_episode`` with snapshots (see the module docstring)."""
    seg_ticks = _snapshot_plan(cfg, n_steps, snapshot_every_s,
                               telemetry_every, summary_only, macro)
    fp = run_fingerprint("episode", cfg, scheduler, statics, state, n_steps,
                         kw)
    return _segments(cfg, statics, state, n_steps, scheduler, macro, kw, fp,
                     seg_ticks, snapshot_dir, resume_from, snapshot_keep)


_EPISODE_MODES = ("summary_only", "telemetry_every", "macro")


def run_fleet_snapshotted(
    cfg,
    statics,
    fleet_statics,
    state,
    n_steps: int,
    scheduler,
    kw: Dict[str, Any],
    *,
    snapshot_every_s,
    snapshot_dir: Optional[str],
    resume_from: Optional[str],
    snapshot_keep: int,
):
    """A fleet sweep with snapshots: one snapshot holds the whole batch.

    ``state`` comes from ``prepare_fleet`` with every replica's keys
    already derived and installed in ``state.key``; the segments, and a
    resumed run, carry them on and never derive them again, so each
    replica's key stream is the single call's. ``statics`` is the
    caller's, ``fleet_statics`` it with the batched scenario, and
    ``scheduler`` the name or batched ``placement.Policy`` the ticks
    run."""
    seg_ticks = _snapshot_plan(
        cfg, n_steps, snapshot_every_s, kw.get("telemetry_every", 1),
        kw.get("summary_only", False), kw.get("macro", False))
    trees = {"scenarios": fleet_statics.scenario}
    if not isinstance(scheduler, str):
        trees["policies"] = scheduler
    fp = run_fingerprint(
        "fleet", cfg, scheduler, statics, state, n_steps, kw, trees=trees,
        extra={"replicas": int(state.t.shape[0])})
    fp.setdefault("policies", "none")
    seg_kw = {k: v for k, v in kw.items() if k not in _EPISODE_MODES}
    return _segments(cfg, fleet_statics, state, n_steps, scheduler,
                     kw.get("macro", False), seg_kw, fp, seg_ticks,
                     snapshot_dir, resume_from, snapshot_keep)


__all__ = [
    "run_fingerprint",
    "check_fingerprint",
    "run_episode_snapshotted",
    "run_fleet_snapshotted",
]
