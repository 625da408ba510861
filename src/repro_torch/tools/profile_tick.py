"""Where a tick's time goes on the card: the main path under torch.profiler.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick \
        [--case replay_tx_gaia_1h_thermal] [--ticks 100] [--replicas 72]

Runs an acceptance case (``configs/acceptance.py``; default
``replay_tx_gaia_1h``) on the card up to tick ``--start`` (so jobs are
running), with ``--replicas E`` > 1 as a fleet of E replicas (the fleet
case's policy x scenario grid, ``acceptance.fleet_grid``, tiled to E),
then times ``--ticks`` more ticks twice: once on the host
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
import re
import sys
import time


def device_summary(prof, wall_us: float, per: int, top: int) -> dict:
    """What a ``torch.profiler`` run over ``per`` repetitions (ticks, decode
    steps) spent on the card, per repetition: CUDA kernels, device time,
    the device's busy share of the profiled wall time, the port's own
    kernels' device time, and the top kernels and host ops."""
    import torch

    from repro_torch import kernels as port_kernels

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # a device event's own time range is the kernel's time on the card
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    host_ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    # the port's own kernels (csrc/<name>.cu: a kernel named <name>_kernel
    # or <name>_<variant>_kernel), by entry
    own = {}
    for name, (tot, n) in by_name.items():
        for k in port_kernels.LAUNCHES:
            found = re.search(rf"\b{k}_(\w+_)?kernel\b", name)
            if found:
                key = found.group(0)
                us, count = own.get(key, (0.0, 0))
                own[key] = (us + tot, count + n)
    return {
        "cuda_kernels": len(kernels) / per,
        "port_kernel_us": {
            k: sum(us for key, (us, _) in own.items()
                   if key.startswith(f"{k}_")) / per
            for k in port_kernels.LAUNCHES},
        "port_kernel_launches": {key: n / per
                                 for key, (_, n) in sorted(own.items())},
        "device_busy_share": (dev_us / wall_us) if kernels else None,
        "device_us": dev_us / per if kernels else None,
        "top_kernels_us": [[name[:80], tot / per, n / per]
                           for name, (tot, n) in top_dev],
        "top_host_ops_us": [[a.key, a.self_cpu_time_total / per,
                             a.count / per] for a in host_ops[:top]],
    }


def _advance(step, state, action, n):
    for _ in range(n):
        state, _ = step(state, action)
    return state


def setup_case(case: str, start: int, device=None, replicas: int = 1):
    """An acceptance case (``configs/acceptance.py``) built on ``device``
    (the card when ``None``) and run to tick ``start``: returns (step,
    state, action). With ``replicas`` > 1, a fleet of that many replicas
    of the case under the fleet grid (``acceptance.fleet_grid`` tiled,
    set up as ``run_fleet`` does). Shared by the tick tools, so each
    reads the same tick."""
    import torch

    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core.sim import make_step
    from repro_torch.utils.device import full

    cfg = acceptance.config(case)
    jobs, bank = acceptance.workload(cfg)
    statics = build_statics(cfg, bank, device=device)
    state = load_jobs(init_state(cfg, statics, acceptance.SEED), jobs)
    who = acceptance.SCHEDULER
    if replicas > 1:
        from repro_torch.core.fleet import prepare_fleet

        _, pol, scn = acceptance.fleet_grid(cfg, replicas)
        statics, state, who = prepare_fleet(cfg, statics, state,
                                            policies=pol, scenarios=scn)
    step = make_step(cfg, statics, who)
    action = full(-1, torch.int64, statics.capacity.device)
    return step, _advance(step, state, action, start), action


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as port_kernels
    from repro_torch.configs import acceptance

    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="replay_tx_gaia_1h",
                    choices=sorted(acceptance.CASES))
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: needs a CUDA device", file=sys.stderr)
        return 1

    step, state, action = setup_case(args.case, args.start,
                                     replicas=args.replicas)
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

    summary = device_summary(prof, prof_wall_us, args.ticks, args.top)
    out = {
        "case": args.case, "replicas": args.replicas,
        "start_tick": args.start,
        "ticks": args.ticks, "device": torch.cuda.get_device_name(0),
        "ms_per_tick": host_ms,
        "us_per_replica_tick": 1e3 * host_ms / args.replicas,
        "ms_per_tick_profiled": prof_wall_us / 1e3 / args.ticks,
        "port_kernel_launches_per_tick": {
            k: v / args.ticks for k, v in port_kernels.LAUNCHES.items()},
        **{k if k == "device_busy_share" else f"{k}_per_tick": v
           for k, v in summary.items()},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
