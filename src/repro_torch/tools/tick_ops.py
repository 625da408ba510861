"""Where a tick's launches come from: the aten operations of one replay
tick, counted stage by stage.

    PYTHONPATH=src python3 -m repro_torch.tools.tick_ops \
        [--case replay_tx_gaia_1h_thermal] [--start 600] [--ticks 5] \
        [--device cpu] [--replicas 72]

Runs an acceptance case on the card (or on ``--device``), as a fleet of
``--replicas`` under the fleet grid when that is > 1, up to tick
``--start`` (``profile_tick.setup_case``), then counts the non-view
aten operations of ``--ticks`` more ticks under a ``TorchDispatchMode``
and prints one JSON line of operations per tick: in total and by stage
(completions, dispatch, grid signals, power chain, thermal derate, rack
update, congestion, telemetry counts, and the rest of the accounting
tail). Almost every such operation is one CUDA kernel on the card, so the
split shows where a tick's launches go; ``profile_tick`` counts the
kernels themselves. A stage is a function of ``core`` that the step calls
through a module attribute: the tool wraps whichever of them the tree
has, so it reads a tree from before the fused tick entries as well, and
an operation counts for the innermost stage running. On the card a
kernel's launch is not an aten operation, so a fused entry counts only
its wrapper's output allocation; with ``--device cpu`` the plain
versions run instead and their operations count, so the CPU's numbers
are not the card's.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

# (stage, module, attribute): what each stage runs, old and new names
STAGES = (
    ("completions", "sim", "_complete_jobs"),
    ("dispatch", "sim", "_try_start"),
    ("dispatch", "thermal", "node_trip_ok"),
    ("grid signals", "sim", "_grid_signals"),
    ("grid signals", "sim", "eval_signal"),
    ("grid signals", "sim", "power_cap_at"),
    ("power chain", "sim", "power_tick"),
    ("power chain", "sim", "compute_power"),
    ("thermal derate", "thermal", "rack_throttle"),
    ("thermal derate", "thermal", "cooling_cop"),
    ("thermal derate", "thermal", "job_thermal_rate"),
    ("rack update", "thermal", "rack_tick"),
    ("rack update", "thermal", "rack_thermal_update"),
    ("rack update", "thermal", "supply_temp"),
    ("congestion", "sim", "congestion_slowdown"),
    ("telemetry counts", "sim", "_counts_and_util"),
)


def main(argv=None) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import acceptance
    from repro_torch.core import schedulers as sched
    from repro_torch.core import sim, thermal
    from repro_torch.tools.profile_tick import setup_case

    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="replay_tx_gaia_1h",
                    choices=sorted(acceptance.CASES))
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args(argv)

    stack = ["rest of the tail"]
    counts = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            if not getattr(func, "is_view", False):
                counts[stack[-1]] += 1
            return func(*fargs, **(kwargs or {}))

    def staged(stage, fn):
        def run(*a, **kw):
            stack.append(stage)
            try:
                return fn(*a, **kw)
            finally:
                stack.pop()
        return run

    modules = {"sim": sim, "thermal": thermal}
    saved = []
    for stage, mod, name in STAGES:
        if hasattr(modules[mod], name):
            fn = getattr(modules[mod], name)
            saved.append((modules[mod], name, fn))
            setattr(modules[mod], name, staged(stage, fn))
    select = dict(sched.SCHEDULERS)
    for k, fn in select.items():
        sched.SCHEDULERS[k] = staged("dispatch", fn)
    try:
        step, state, action = setup_case(args.case, args.start, args.device,
                                         args.replicas)
        counts.clear()
        with Count():
            for _ in range(args.ticks):
                state, _ = step(state, action)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        sched.SCHEDULERS.update(select)
    per_tick = {k: v / args.ticks for k, v in sorted(counts.items())}
    print(json.dumps({"case": args.case, "replicas": args.replicas,
                      "start_tick": args.start,
                      "ticks": args.ticks, "device": str(state.t.device),
                      "aten_ops_per_tick": sum(per_tick.values()),
                      "by_stage": per_tick}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
