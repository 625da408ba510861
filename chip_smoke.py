#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each; any failure ends the run with a non-zero exit
and no result line:

1. env       torch/CUDA versions, the card's name and power limit; TF32 off.
2. build     compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, all at once).
3. kernel    each kernel against its plain PyTorch version on the card, at
             the paths' shapes (E=1 and E=64 replicas of the TX-GAIA job
             table, nodes and racks), and timed (CUDA events, median).
4. main      ``replay_tx_gaia_1h`` through build_statics -> init_state ->
             load_jobs -> run_episode(summary_only) -> summary, the ticks
             under ``torch.cuda.set_sync_debug_mode("error")``; held to the
             JAX package's pinned values and to one kernel launch per tick.
5. thermal   the same for ``replay_tx_gaia_1h_thermal`` and
             ``replay_tx_gaia_1h_thermal_stress`` (the rack thermal twin):
             pinned values, and one power_scatter and one rack_thermal
             launch per tick.
6. determinism  the first 600 ticks of the main path and the first 900 of
             the thermal stress hour, each twice: every field bitwise equal.

The launch counts are set to 0 just before each path and read just after.
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
DETERMINISM = (("replay_tx_gaia_1h", 600),
               ("replay_tx_gaia_1h_thermal_stress", 900))
THERMAL_CASES = ("replay_tx_gaia_1h_thermal",
                 "replay_tx_gaia_1h_thermal_stress")
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
    """The f32 operations this data needs: 2 adds per used slot, ~25 per
    node of the chain."""
    place = args[0]
    n_rep, n = args[8].shape
    ops = 2 * int((place >= 0).sum()) + 25 * n_rep * n
    return bound(nbytes(args), 4 * n_rep * n * 4, ops)


def bound(in_bytes: int, out_bytes: int, ops: int) -> tuple[float, str]:
    """Least milliseconds the card could take: each input read once and
    each output written once at the HBM rate, against ``ops`` f32
    operations at the f32 peak."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rack_thermal_inputs(torch, np, statics, n_rep: int, seed: int):
    """Seeded rack-thermal inputs at the thermal path's shapes: per-node
    input power of a loaded TX-GAIA node, outlet temperatures around the
    stress case's thresholds, the TX-GAIA racks."""
    rng = np.random.default_rng(seed)
    n = statics.node_rack.shape[0]
    r = statics.rack_r_th.shape[0]
    dev = statics.idle_w.device

    def t(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device=dev)

    return (t(rng.uniform(150.0, 1400.0, (n_rep, n))), statics.node_rack,
            t(rng.uniform(18.0, 34.0, (n_rep, r))),
            t(rng.uniform(14.0, 24.0, n_rep)), statics.rack_r_th)


def node_power_inputs(torch, np, statics, n_rep: int, seed: int):
    """Seeded (E, N) load fractions and ~5% nodes down, with the TX-GAIA
    node constants."""
    rng = np.random.default_rng(seed)
    n = statics.idle_w.shape[0]
    dev = statics.idle_w.device

    def t(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device=dev)

    return (t(rng.random((n_rep, n))), t(rng.random((n_rep, n))),
            statics.idle_w, statics.cpu_dyn_w, statics.gpu_dyn_w,
            t(rng.random((n_rep, n)) > 0.05), statics.node_max_w)


def check_kernel(torch, name, got, want, fn, plain, bound_ms, bound_by,
                 **shape):
    """Hold a kernel's outputs to its plain version's (rtol), time both,
    emit the phase line and return the record."""
    torch.cuda.synchronize()
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                  for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=KERNEL_RTOL, atol=0.0,
                                   msg=lambda m, i=i: f"{name}[{i}]: {m}")
    rec = dict(max_abs_err=abs_err, ms=time_ms(torch, fn),
               plain_ms=time_ms(torch, plain), bound_ms=bound_ms,
               bound_by=bound_by)
    emit("kernel", name=name, **shape, max_rel_err=rel_err,
         rtol=KERNEL_RTOL, **rec)
    return rec


def drive(torch, case: str, cfg, statics, jobs, phase: str) -> dict:
    """One hour of ``case`` on the card, the ticks under sync-debug
    "error": held to the pinned values, one power_scatter launch per tick
    and, with the thermal twin on, one rack_thermal launch per tick."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance
    from repro_torch.core import init_state, load_jobs, run_episode, summary

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
    pins = acceptance.PINNED[case]
    emit(phase, case=case, ticks=acceptance.N_STEPS, setup_s=setup_s,
         wall_s=wall_s, ms_per_tick=1e3 * wall_s / acceptance.N_STEPS,
         launches=launches, **{k: got[k] for k in pins}, pinned=pins)
    acceptance.check(case, got)
    want = {"power_scatter": acceptance.N_STEPS, "node_power": 0,
            "rack_thermal": acceptance.N_STEPS if cfg.thermal_enabled else 0}
    if launches != want:
        raise AssertionError(f"{case}: launches {launches}, expected {want}")
    for name, v in final._asdict().items():
        # the fault and serving clocks stay at +inf while those models are off
        ok = (~torch.isnan(v) if name in INF_CLOCKS else torch.isfinite(v))
        if v.is_floating_point() and not bool(ok.all()):
            raise AssertionError(f"{case}: final state field {name}: "
                                 "bad values")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core import run_episode
    from repro_torch.core.thermal import thermal_alpha
    from repro_torch.kernels import build
    from repro_torch.kernels import node_power as npw
    from repro_torch.kernels import rack_thermal as prt

    # 1. env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         nvidia_smi=card)

    # 2. build
    kernel_names = ["power_scatter", "rack_thermal", "node_power"]
    secs = build.build(kernel_names)
    emit("build", seconds=secs,
         ptxas=[ln for name in kernel_names
                for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln])

    # 3. kernels against their plain versions, at the paths' shapes
    cfg = acceptance.config()
    jobs, bank = acceptance.workload(cfg)
    statics = build_statics(cfg, bank)
    chain = dict(rect_peak=cfg.rect_eff_peak, rect_load=cfg.rect_eff_load,
                 rect_curv=cfg.rect_eff_curv, conv_eff=cfg.conv_eff)
    jk = cfg.max_jobs * cfg.max_nodes_per_job
    n_nodes, n_racks = cfg.n_nodes, cfg.n_racks
    alpha = thermal_alpha(acceptance.config("replay_tx_gaia_1h_thermal"))
    record = {}
    for n_rep in (1, 64):
        a = power_scatter_inputs(torch, np, statics, n_rep, jk, seed=n_rep)
        record["power_scatter", n_rep] = check_kernel(
            torch, "power_scatter", npw.power_scatter(*a, **chain),
            npw.power_scatter_torch(*a, **chain),
            lambda: npw.power_scatter(*a, **chain),
            lambda: npw.power_scatter_torch(*a, **chain),
            *power_scatter_bound(a), replicas=n_rep, slots=jk, nodes=n_nodes)

        a = rack_thermal_inputs(torch, np, statics, n_rep, seed=n_rep)
        # one add per node, ~5 operations per rack of the RC step
        rt_bound = bound(nbytes(a), 2 * 4 * n_rep * n_racks,
                         n_rep * (n_nodes + 5 * n_racks))
        record["rack_thermal", n_rep] = check_kernel(
            torch, "rack_thermal", prt.rack_thermal(*a, alpha=alpha),
            prt.rack_thermal_torch(*a, alpha=alpha),
            lambda: prt.rack_thermal(*a, alpha=alpha),
            lambda: prt.rack_thermal_torch(*a, alpha=alpha),
            *rt_bound, replicas=n_rep, nodes=n_nodes, racks=n_racks)

        a = node_power_inputs(torch, np, statics, n_rep, seed=n_rep)
        # ~15 f32 operations per node of the chain
        np_bound = bound(nbytes(a), 2 * 4 * n_rep * n_nodes,
                         15 * n_rep * n_nodes)
        record["node_power", n_rep] = check_kernel(
            torch, "node_power", npw.node_power(*a, **chain),
            npw.node_chain(*a, **chain),
            lambda: npw.node_power(*a, **chain),
            lambda: npw.node_chain(*a, **chain),
            *np_bound, replicas=n_rep, nodes=n_nodes)

    # 4. main path: replay_tx_gaia_1h on the card
    launches = drive(torch, "replay_tx_gaia_1h", cfg, statics, jobs, "main")

    # 5. the thermal twin: both hours; the kernels line reports the first
    # hour's rack_thermal launches
    thermal = []
    for case in THERMAL_CASES:
        tcfg = acceptance.config(case)
        thermal.append(drive(torch, case, tcfg, build_statics(tcfg, bank),
                             jobs, "thermal"))
    launches["rack_thermal"] = thermal[0]["rack_thermal"]

    # 6. determinism: the same ticks twice, bitwise
    for case, ticks in DETERMINISM:
        dcfg = acceptance.config(case)
        dstatics = build_statics(dcfg, bank)
        state = load_jobs(init_state(dcfg, dstatics, seed=acceptance.SEED),
                          jobs)
        (sa, ta), (sb, tb) = [
            run_episode(dcfg, dstatics, state, ticks, acceptance.SCHEDULER,
                        summary_only=True) for _ in range(2)]
        differ = [f for f in sa._fields
                  if not torch.equal(getattr(sa, f), getattr(sb, f))]
        differ += [f"telemetry.{f}" for f in ta._fields
                   if not torch.equal(getattr(ta, f), getattr(tb, f))]
        emit("determinism", case=case, ticks=ticks, fields_differing=differ)
        if differ:
            raise AssertionError(f"{case}: runs differ in {differ}")

    sources = {
        "power_scatter": "src/repro/kernels/node_power.py:145",
        "rack_thermal": "src/repro/kernels/rack_thermal.py:47",
        "node_power": "src/repro/kernels/node_power.py:45",
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        **{k: record[name, 1][k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")},
        "library_ms": None,
    } for name, replaces in sources.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
