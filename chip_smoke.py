#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each; any failure ends the run with a non-zero exit
and no result line:

1. env       torch/CUDA versions, the card's name and power limit; TF32 off.
2. build     compile every CUDA kernel of the path from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, all at once).
3. kernel    each kernel against its plain PyTorch version on the card, at
             the main path's shapes (power_scatter: E=1 and E=64 replicas
             of the TX-GAIA job table), and timed (CUDA events, median).
4. main      ``replay_tx_gaia_1h`` through build_statics -> init_state ->
             load_jobs -> run_episode(summary_only) -> summary, the ticks
             under ``torch.cuda.set_sync_debug_mode("error")``; held to the
             JAX package's pinned values and to one kernel launch per tick.
5. determinism  the first 600 ticks twice: every state field bitwise equal.

Then the ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. It needs no network, and exits non-zero
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
KERNEL_RTOL = 1e-5
TIMING_REPS = 50               # timed batches (median over these)
TIMING_BATCH = 20              # back-to-back calls per timed batch
DETERMINISM_TICKS = 600
INF_CLOCKS = {"next_fail_t", "rack_fail_t", "srv_retry_t", "srv_wake_t"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median per-call milliseconds of ``fn`` over TIMING_REPS batches of
    TIMING_BATCH back-to-back calls, timed with CUDA events after warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMING_BATCH)
    times.sort()
    return times[len(times) // 2]


def power_scatter_inputs(torch, np, statics, n_rep: int, jk: int, seed: int):
    """Seeded job tables at the main path's shapes: the TX-GAIA node
    vectors, ids in [-1, N) (about a third of the slots unused, as in a
    replay), per-slot amounts zero on unused slots, and ~5% nodes down."""
    rng = np.random.default_rng(seed)
    n = statics.idle_w.shape[0]
    place = rng.integers(-1, n, (n_rep, jk))
    place[rng.random((n_rep, jk)) < 0.33] = -1
    valid = place >= 0
    cabs = rng.uniform(0.0, 24.0, (n_rep, jk)) * valid
    gabs = rng.uniform(0.0, 2.0, (n_rep, jk)) * valid
    up = (rng.random((n_rep, n)) > 0.05).astype(np.float32)
    dev = statics.idle_w.device

    def t(a, dt):
        return torch.tensor(np.array(a, dt, order="C"), device=dev)

    return (t(place, np.int32), t(cabs, np.float32), t(gabs, np.float32),
            statics.capacity[0].contiguous(), statics.capacity[1].contiguous(),
            statics.idle_w, statics.cpu_dyn_w, statics.gpu_dyn_w,
            t(up, np.float32), statics.node_max_w)


def power_scatter_bound(args) -> tuple[float, str]:
    """Least time the card could take: each input read once and each
    output written once at the HBM rate, against the f32 operations this
    data needs (2 adds per used slot, ~25 per node of the chain)."""
    place = args[0]
    n_rep, n = args[8].shape
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    out_bytes = 4 * n_rep * n * 4
    ops = 2 * int((place >= 0).sum()) + 25 * n_rep * n
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core import run_episode, summary
    from repro_torch.kernels import build
    from repro_torch.kernels import node_power as npw

    # 1. env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         nvidia_smi=card)

    # 2. build
    kernel_names = ["power_scatter"]
    secs = build.build(kernel_names)
    emit("build", seconds=secs,
         ptxas=[ln for name in kernel_names
                for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln])

    # 3. kernels against their plain versions
    cfg = acceptance.config()
    jobs, bank = acceptance.workload(cfg)
    statics = build_statics(cfg, bank)
    chain = dict(rect_peak=cfg.rect_eff_peak, rect_load=cfg.rect_eff_load,
                 rect_curv=cfg.rect_eff_curv, conv_eff=cfg.conv_eff)
    jk = cfg.max_jobs * cfg.max_nodes_per_job
    record = {}
    for n_rep in (1, 64):
        args = power_scatter_inputs(torch, np, statics, n_rep, jk, seed=n_rep)
        got = npw.power_scatter(*args, **chain)
        want = npw.power_scatter_torch(*args, **chain)
        torch.cuda.synchronize()
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                      for g, w in zip(got, want))
        for name, g, w in zip(("node_it_w", "node_input_w", "cpu_frac",
                               "gpu_frac"), got, want):
            torch.testing.assert_close(g, w, rtol=KERNEL_RTOL, atol=0.0,
                                       msg=lambda m, n=name: f"{n}: {m}")
        ms = time_ms(torch, lambda: npw.power_scatter(*args, **chain))
        plain_ms = time_ms(torch,
                           lambda: npw.power_scatter_torch(*args, **chain))
        bound_ms, bound_by = power_scatter_bound(args)
        emit("kernel", name="power_scatter", replicas=n_rep, slots=jk,
             nodes=int(statics.idle_w.shape[0]), max_abs_err=abs_err,
             max_rel_err=rel_err, rtol=KERNEL_RTOL, ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by)
        record[n_rep] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)

    # 4. main path: replay_tx_gaia_1h on the card
    t0 = time.perf_counter()
    state = load_jobs(init_state(cfg, statics, seed=acceptance.SEED), jobs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    final, telem = run_episode(cfg, statics, state, acceptance.N_STEPS,
                               acceptance.SCHEDULER, summary_only=True)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got = summary(final, telem)
    emit("main", case="replay_tx_gaia_1h", ticks=acceptance.N_STEPS,
         setup_s=setup_s, wall_s=wall_s,
         ms_per_tick=1e3 * wall_s / acceptance.N_STEPS, launches=launches,
         **{k: got[k] for k in acceptance.PINNED},
         pinned=acceptance.PINNED)
    if got["completed"] != acceptance.PINNED["completed"]:
        raise AssertionError(f"completed {got['completed']} != pinned "
                             f"{acceptance.PINNED['completed']}")
    for k, v in acceptance.PINNED.items():
        if abs(got[k] - v) > acceptance.RTOL * abs(v):
            raise AssertionError(f"{k}: {got[k]!r} vs pinned {v!r} "
                                 f"(rtol {acceptance.RTOL})")
    if launches["power_scatter"] != acceptance.N_STEPS:
        raise AssertionError(f"power_scatter launched {launches} times, "
                             f"expected {acceptance.N_STEPS}")
    for name, v in final._asdict().items():
        # the fault and serving clocks stay at +inf while those models are off
        ok = (~torch.isnan(v) if name in INF_CLOCKS else torch.isfinite(v))
        if v.is_floating_point() and not bool(ok.all()):
            raise AssertionError(f"final state field {name}: bad values")

    # 5. determinism: the same ticks twice, bitwise
    runs = [run_episode(cfg, statics, state, DETERMINISM_TICKS,
                        acceptance.SCHEDULER, summary_only=True)
            for _ in range(2)]
    (sa, ta), (sb, tb) = runs
    differ = [f for f in sa._fields
              if not torch.equal(getattr(sa, f), getattr(sb, f))]
    differ += [f"telemetry.{f}" for f in ta._fields
               if not torch.equal(getattr(ta, f), getattr(tb, f))]
    emit("determinism", ticks=DETERMINISM_TICKS, fields_differing=differ)
    if differ:
        raise AssertionError(f"runs differ in {differ}")

    main_rec = record[1]
    print(json.dumps({"kernels": [{
        "name": "power_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/power_scatter.cu",
        "replaces": "src/repro/kernels/node_power.py:145",
        "launches": launches["power_scatter"],
        "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
