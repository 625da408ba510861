"""Crash-chaos harness: SIGKILL long runs at random points and show that
resume is bit-identical, as the JAX package's ``repro/utils/chaos.py``.

A replay or PPO run killed at ANY instant — mid-checkpoint-write
included — resumes from the newest complete snapshot and ends with the
SAME bits as a run never interrupted. This module is the executable form
of that claim:

- ``chaos_run`` launches a worker subprocess, SIGKILLs it after a seeded
  random delay (in ``chaos_smoke``, counted from the first snapshot the
  launch writes), relaunches it (it resumes), and repeats until a launch
  survives to its end. Delays come from a seeded RNG, so a failure
  replays exactly.
- The workers (``python -m repro_torch.utils.chaos replay|ppo``) run a
  snapshotted replay episode or checkpointed PPO training, on the card
  unless ``--device`` names another, and write their final stats as JSON:
  full ``repr`` floats and tree digests, so the comparison is bitwise,
  and the step the launch resumed from, which the comparison leaves out.
  ``replay --case <acceptance case>`` runs that case (its config,
  workload, scenario and scheduler) instead of the tiny cluster.
- ``python -m repro_torch.utils.chaos smoke`` is the self-contained entry:
  reference run (uninterrupted) -> chaos-killed run -> assert equal.

``REPRO_CHAOS_SLOW_SAVE=<seconds>`` stretches the window between a
checkpoint's tmp-dir write and its atomic rename; kills landing there
show that torn writes are invisible (``ckpt.latest_step`` sweeps stale
``*.tmp`` dirs, resume sees only complete snapshots).

    PYTHONPATH=src python -m repro_torch.utils.chaos smoke --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# how often ``chaos_run`` looks for a launch's first snapshot
_POLL_S = 0.02
# ``chaos_smoke``'s kill delays, counted from a launch's first snapshot:
# short against a snapshot interval's wall time, so a kill lands between
# snapshots or inside a write, and the killed launch has made progress
KILL_DELAY_S = (0.0, 0.5)


@dataclass
class ChaosResult:
    """Outcome of one ``chaos_run`` kill-loop."""

    n_kills: int
    attempts: List[Dict[str, object]] = field(default_factory=list)
    stats_path: Optional[str] = None

    def stats(self) -> Dict[str, object]:
        with open(self.stats_path) as f:
            return json.load(f)


def chaos_run(
    cmd: Sequence[str],
    *,
    kills: int = 3,
    min_delay_s: float = 0.5,
    max_delay_s: float = 6.0,
    seed: int = 0,
    env: Optional[Dict[str, str]] = None,
    timeout_s: float = 600.0,
    stats_path: Optional[str] = None,
    snapshot_dir: Optional[str] = None,
) -> ChaosResult:
    """Run ``cmd`` under the kill-loop.

    The first ``kills`` launches are SIGKILLed after a seeded random delay
    in ``[min_delay_s, max_delay_s]``, counted from the launch or, with
    ``snapshot_dir``, from the first snapshot the launch completes there
    (a ``step_*`` directory with its manifest that was not there before
    it), so each kill comes after progress of its own whatever the
    worker's start-up costs. A launch that finishes before its kill counts
    as done early; once the kill budget is spent the final launch runs to
    its end. ``cmd`` must resume: each relaunch picks up from whatever
    snapshots the previous one left. Raises ``RuntimeError`` if the
    surviving launch exits non-zero, or a launch overruns ``timeout_s``.
    """
    rng = random.Random(seed)
    run_env = dict(os.environ)
    if env:
        run_env.update(env)
    result = ChaosResult(n_kills=0, stats_path=stats_path)
    attempt = 0
    while True:
        is_final = result.n_kills >= kills
        delay = None if is_final else rng.uniform(min_delay_s, max_delay_s)
        before = _complete_snapshots(snapshot_dir)
        t0 = time.monotonic()
        with tempfile.TemporaryFile() as log:
            proc = subprocess.Popen(list(cmd), env=run_env, stdout=log,
                                    stderr=subprocess.STDOUT)
            try:
                killed, snap_s = _wait_or_kill(proc, delay, snapshot_dir,
                                               before, t0, timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                which = "final (uninterrupted)" if is_final else "killed"
                raise RuntimeError(
                    f"chaos worker overran {timeout_s}s on the {which} "
                    f"launch {attempt}: {' '.join(cmd)}") from None
            log.seek(0)
            out = log.read()
        rc = proc.returncode
        result.n_kills += killed
        result.attempts.append({
            "attempt": attempt, "killed": killed, "returncode": rc,
            "delay_s": delay, "first_snapshot_s": snap_s,
            "wall_s": round(time.monotonic() - t0, 3)})
        attempt += 1
        if not killed:
            if rc != 0:
                tail = out.decode(errors="replace")[-2000:]
                raise RuntimeError(f"chaos worker exited {rc}:\n{tail}")
            return result


def _complete_snapshots(directory: Optional[str]) -> set:
    """The complete snapshots in ``directory``: ``step_*`` directories
    holding their manifest (a write in flight is a ``.tmp`` directory).
    Unlike ``ckpt.latest_step`` this sweeps nothing, as a live worker may
    be writing there."""
    if directory is None or not os.path.isdir(directory):
        return set()
    return {d for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(directory, d, "manifest.json"))}


def _wait_or_kill(proc, delay, snapshot_dir, before, t0, timeout_s):
    """Wait for ``proc``; with a ``delay``, SIGKILL it that long after its
    launch at ``t0`` or, with ``snapshot_dir``, after its first snapshot
    there that is not in ``before``, and at the latest when a second new
    snapshot completes (a worker whose snapshots come closer together
    than the delay would otherwise be killed after its last one, leaving
    its relaunch nothing to redo). Returns (killed, seconds from the
    launch to the first snapshot or None); ``subprocess.TimeoutExpired``
    past ``timeout_s`` from the launch."""
    def left():
        return timeout_s - (time.monotonic() - t0)

    if delay is None:
        proc.wait(timeout=max(left(), 0.0))
        return False, None
    snap_s = None
    if snapshot_dir is not None:
        while not _complete_snapshots(snapshot_dir) - before:
            if proc.poll() is not None:
                return False, None
            if left() <= 0:
                raise subprocess.TimeoutExpired(proc.args, timeout_s)
            time.sleep(_POLL_S)
        snap_s = round(time.monotonic() - t0, 3)
        deadline = time.monotonic() + min(delay, max(left(), 0.0))
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                return False, snap_s
            if len(_complete_snapshots(snapshot_dir) - before) > 1:
                break
            time.sleep(_POLL_S)
    else:
        try:
            proc.wait(timeout=delay)
            return False, snap_s
        except subprocess.TimeoutExpired:
            pass
    if proc.poll() is not None:
        return False, snap_s
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    return True, snap_s


def tree_digest_hex(tree) -> str:
    """Order-stable sha256 over every leaf's name, dtype, shape and raw
    bytes (``None`` subtrees have no leaf): the bit-identity token the
    workers write into their stats. The tree reaches the host in one
    counted read (``utils.device.drain``)."""
    from repro_torch.checkpoint.ckpt import _to_numpy
    from repro_torch.utils.device import drain
    from repro_torch.utils.tree import tree_leaves_with_names

    h = hashlib.sha256()
    for name, leaf in tree_leaves_with_names(drain(tree)):
        a, dtype_name = _to_numpy(leaf)
        h.update(f"{name}:{dtype_name}:{tuple(a.shape)}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# worker roles (subprocess entry points)
# ---------------------------------------------------------------------------


def _one_thread_on_cpu(device) -> None:
    """On the CPU a worker runs one intra-op thread: every launch, killed
    or not, then sums in one order (a loaded host can change the threads a
    BLAS call takes, and with them the last bits)."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)


def _replay_setup(args):
    """(cfg, statics, state, scheduler) of the replay worker: the tiny
    cluster with faults and serving on (the JAX package's worker), or an
    acceptance case."""
    from repro_torch.core import build_statics, init_state, load_jobs

    if args.case:
        from repro_torch.configs import acceptance as A

        cfg = A.config(args.case)
        base = A.base_case(args.case)
        jobs, bank = A.workload(cfg)
        scenario = (A.serving_scenario(cfg) if base == A.SERVING_CASE
                    else A.fault_scenario(base, cfg))
        statics = build_statics(cfg, bank, scenario, device=args.device)
        state = load_jobs(init_state(cfg, statics, args.seed), jobs)
        if base == A.SERVING_CASE:
            state = A.half_asleep(state)
        return cfg, statics, state, A.SCHEDULER
    from repro_torch.configs.sim import tiny_cluster
    from repro_torch.data import synth_workload

    cfg = tiny_cluster(node_mtbf_hours=0.3, serving_enabled=True,
                       serving_nodes=4)
    jobs, bank = synth_workload(cfg, 32, 1200.0, seed=args.seed)
    statics = build_statics(cfg, bank, device=args.device)
    state = load_jobs(init_state(cfg, statics, args.seed), jobs)
    return cfg, statics, state, "fcfs"


def _resumed_from(directory):
    """The step a worker resumes from (None: it starts afresh)."""
    from repro_torch.checkpoint import latest_step

    return latest_step(directory) if directory else None


def _replay_worker(args) -> None:
    from repro_torch.core import run_episode, summary

    _one_thread_on_cpu(args.device)
    resumed_from = _resumed_from(args.dir)
    cfg, statics, state, scheduler = _replay_setup(args)
    snap = None if args.snapshot_every_s <= 0 else args.snapshot_every_s
    fs, telem = run_episode(
        cfg, statics, state, args.n_steps, scheduler, macro=True,
        snapshot_every_s=snap,
        resume_from=args.dir if args.dir else None,
        snapshot_dir=args.dir if args.dir else None,
        snapshot_keep=args.keep)
    stats = {
        "role": "replay",
        "state_digest": tree_digest_hex(fs),
        "telem_digest": tree_digest_hex(telem),
        "summary": {k: repr(float(v)) for k, v in summary(fs).items()},
        "resumed_from": resumed_from,
    }
    with open(args.out, "w") as f:
        json.dump(stats, f, indent=1)


def _ppo_worker(args) -> None:
    from repro_torch.configs.sim import tiny_cluster
    from repro_torch.data import synth_workload
    from repro_torch.envs import SchedEnv
    from repro_torch.rl import PPOConfig, ppo_train

    _one_thread_on_cpu(args.device)
    resumed_from = _resumed_from(args.dir)
    cfg = tiny_cluster(sched_max_candidates=4)
    wls = [synth_workload(cfg, 24, 900.0, seed=s) for s in range(2)]
    env = SchedEnv(cfg, wls, episode_steps=8, sim_steps_per_action=5,
                   device=args.device)
    pcfg = PPOConfig(n_envs=4, rollout_len=8, n_epochs=2, n_minibatches=2)
    params, hist = ppo_train(
        env, cfg=pcfg, n_iterations=args.iters, seed=args.seed,
        checkpoint_dir=args.dir, checkpoint_every=args.ckpt_every,
        resume=bool(args.dir))
    stats = {
        "role": "ppo",
        "params_digest": tree_digest_hex(params),
        "history_tail": {k: repr(v) for k, v in (hist[-1] if hist else
                                                 {}).items()},
        "resumed_from": resumed_from,
    }
    with open(args.out, "w") as f:
        json.dump(stats, f, indent=1)


def _worker_cmd(role: str, workdir: str, out: str, *,
                seed: int = 0, n_steps: int = 400,
                snapshot_every_s: float = 60.0, iters: int = 6,
                ckpt_every: int = 2, device: Optional[str] = None,
                case: Optional[str] = None) -> List[str]:
    cmd = [sys.executable, "-m", "repro_torch.utils.chaos", role,
           "--dir", workdir, "--out", out, "--seed", str(seed)]
    if device:
        cmd += ["--device", device]
    if role == "replay":
        cmd += ["--n-steps", str(n_steps),
                "--snapshot-every-s", str(snapshot_every_s)]
        if case:
            cmd += ["--case", case]
    else:
        cmd += ["--iters", str(iters), "--ckpt-every", str(ckpt_every)]
    return cmd


def _package_env() -> Dict[str, str]:
    """The workers' ``PYTHONPATH``: this package's root first."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rest = os.environ.get("PYTHONPATH")
    return {"PYTHONPATH": root + (os.pathsep + rest if rest else "")}


def chaos_smoke(role: str, tmpdir: str, *, kills: int = 2, seed: int = 0,
                slow_save_s: float = 0.0, **worker_kw) -> Dict[str, object]:
    """Reference (uninterrupted) run vs chaos-killed run; raises
    ``AssertionError`` on any stats mismatch, or if the final launch of a
    killed run resumed from no snapshot. Returns the chaos record, with
    the step the final launch resumed from.

    Each kill comes ``KILL_DELAY_S`` (seeded) after the launch's first
    snapshot, so it follows the worker's start-up, however long that
    takes on the host or the card."""
    ref_dir = os.path.join(tmpdir, f"{role}_ref")
    ref_out = os.path.join(tmpdir, f"{role}_ref.json")
    chaos_dir = os.path.join(tmpdir, f"{role}_chaos")
    chaos_out = os.path.join(tmpdir, f"{role}_chaos.json")
    env = _package_env()

    t0 = time.monotonic()
    ref = subprocess.run(
        _worker_cmd(role, ref_dir, ref_out, seed=seed, **worker_kw),
        capture_output=True, env={**os.environ, **env})
    ref_wall = time.monotonic() - t0
    if ref.returncode != 0:
        raise RuntimeError("reference run failed:\n"
                           + ref.stdout.decode(errors="replace")[-2000:]
                           + ref.stderr.decode(errors="replace")[-2000:])
    if slow_save_s > 0:
        env["REPRO_CHAOS_SLOW_SAVE"] = str(slow_save_s)
    res = chaos_run(
        _worker_cmd(role, chaos_dir, chaos_out, seed=seed, **worker_kw),
        kills=kills, seed=seed, env=env, stats_path=chaos_out,
        min_delay_s=KILL_DELAY_S[0], max_delay_s=KILL_DELAY_S[1],
        snapshot_dir=chaos_dir)
    with open(ref_out) as f:
        want = json.load(f)
    got = res.stats()
    # where each run started from is not part of its result
    want.pop("resumed_from")
    resumed_from = got.pop("resumed_from")
    if want != got:
        diff = {k: (want.get(k), got.get(k))
                for k in set(want) | set(got) if want.get(k) != got.get(k)}
        raise AssertionError(
            f"chaos {role}: killed+resumed stats differ from "
            f"uninterrupted run after {res.n_kills} kill(s): {diff}")
    if res.n_kills and resumed_from is None:
        raise AssertionError(f"chaos {role}: the final launch after "
                             f"{res.n_kills} kill(s) resumed from no "
                             "snapshot")
    return {"role": role, "n_kills": res.n_kills,
            "resumed_from": resumed_from, "attempts": res.attempts,
            "reference_wall_s": ref_wall}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.utils.chaos",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="role", required=True)

    rp = sub.add_parser("replay", help="snapshotted replay worker")
    rp.add_argument("--dir", required=True)
    rp.add_argument("--out", required=True)
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--n-steps", type=int, default=400)
    rp.add_argument("--snapshot-every-s", type=float, default=60.0)
    rp.add_argument("--keep", type=int, default=3)
    rp.add_argument("--case", default=None,
                    help="an acceptance replay case (default: the tiny "
                    "cluster with faults and serving)")
    rp.add_argument("--device", default=None, help="default: the CUDA card")

    pp = sub.add_parser("ppo", help="checkpointed PPO worker")
    pp.add_argument("--dir", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--iters", type=int, default=6)
    pp.add_argument("--ckpt-every", type=int, default=2)
    pp.add_argument("--device", default=None, help="default: the CUDA card")

    sm = sub.add_parser("smoke", help="kill-loop: replay + ppo")
    sm.add_argument("--tmpdir", default=None)
    sm.add_argument("--kills", type=int, default=2)
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--slow-save-s", type=float, default=0.0)
    sm.add_argument("--roles", default="replay,ppo")
    sm.add_argument("--device", default=None, help="default: the CUDA card")

    args = ap.parse_args(argv)
    if args.role == "replay":
        _replay_worker(args)
    elif args.role == "ppo":
        _ppo_worker(args)
    else:
        import tempfile

        tmpdir = args.tmpdir or tempfile.mkdtemp(prefix="repro_chaos_")
        for role in args.roles.split(","):
            out = chaos_smoke(role.strip(), tmpdir, kills=args.kills,
                              seed=args.seed, slow_save_s=args.slow_save_s,
                              device=args.device)
            print(f"[chaos] {role}: OK after {out['n_kills']} kill(s); "
                  f"attempts={len(out['attempts'])}; final launch resumed "
                  f"from step {out['resumed_from']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
