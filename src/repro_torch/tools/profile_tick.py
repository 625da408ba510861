"""Where a tick's time goes on the card: the main path under torch.profiler.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick \
        [--case replay_tx_gaia_1h_thermal] [--ticks 100]

Runs an acceptance case (``configs/acceptance.py``; default
``replay_tx_gaia_1h``) on the card up to tick ``--start`` (so jobs are
running), then times ``--ticks`` more ticks twice: once on the host
clock around a synchronised loop, once under ``torch.profiler`` with CPU
and CUDA activities. Prints one JSON line: ms per tick, CUDA kernels per
tick (and launches of the port's own kernels per tick), the device's
busy share (sum of kernel times over the profiled wall time; the rest is
idle, waiting on the host), and the top CUDA kernels and host ops by
time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _advance(step, state, action, n):
    for _ in range(n):
        state, _ = step(state, action)
    return state


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as port_kernels
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core.sim import make_step
    from repro_torch.utils.device import full

    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="replay_tx_gaia_1h",
                    choices=sorted(acceptance.CASES))
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: needs a CUDA device", file=sys.stderr)
        return 1

    cfg = acceptance.config(args.case)
    jobs, bank = acceptance.workload(cfg)
    statics = build_statics(cfg, bank)
    state = load_jobs(init_state(cfg, statics, acceptance.SEED), jobs)
    step = make_step(cfg, statics, acceptance.SCHEDULER)
    action = full(-1, torch.int64, statics.capacity.device)
    state = _advance(step, state, action, args.start)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    _advance(step, state, action, args.ticks)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / args.ticks

    port_kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _advance(step, state, action, args.ticks)
        torch.cuda.synchronize()
        prof_wall_us = 1e6 * (time.perf_counter() - t0)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # a device event's own time range is the kernel's time on the card
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    host_ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    out = {
        "case": args.case, "start_tick": args.start,
        "ticks": args.ticks, "device": torch.cuda.get_device_name(0),
        "ms_per_tick": host_ms,
        "ms_per_tick_profiled": prof_wall_us / 1e3 / args.ticks,
        "cuda_kernels_per_tick": len(kernels) / args.ticks,
        "port_kernel_launches_per_tick": {
            k: v / args.ticks for k, v in port_kernels.LAUNCHES.items()},
        # device time of the port's own kernels (csrc/<name>.cu)
        "port_kernel_us_per_tick": {
            k: sum(tot for name, (tot, _) in by_name.items()
                   if f"{k}_kernel" in name) / args.ticks
            for k in port_kernels.LAUNCHES},
        "device_busy_share": (dev_us / prof_wall_us) if kernels else None,
        "device_us_per_tick": dev_us / args.ticks if kernels else None,
        "top_kernels_us_per_tick": [
            [name[:80], tot / args.ticks, n / args.ticks]
            for name, (tot, n) in top_dev],
        "top_host_ops_us_per_tick": [
            [a.key, a.self_cpu_time_total / args.ticks, a.count / args.ticks]
            for a in host_ops[:args.top]],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
