"""Where a tick's launches come from: the aten operations of one replay
tick, counted stage by stage.

    PYTHONPATH=src python3 -m repro_torch.tools.tick_ops \
        [--case replay_tx_gaia_1h_thermal] [--start 600] [--ticks 5] \
        [--device cpu] [--replicas 72]
    PYTHONPATH=src python3 -m repro_torch.tools.tick_ops \
        --case rl_tx_gaia [--replicas 8] [--device cpu]
    PYTHONPATH=src python3 -m repro_torch.tools.tick_ops --macro \
        [--case replay_tx_gaia_1h] [--ticks 600] [--device cpu]

Runs an acceptance case on the card (or on ``--device``), as a fleet of
``--replicas`` under the fleet grid when that is > 1, up to tick
``--start`` (``profile_tick.setup_case``), then counts the non-view
aten operations of ``--ticks`` more ticks under a ``TorchDispatchMode``
and prints one JSON line of operations per tick: in total and by stage
(the fault engine ``apply_faults`` on a fault hour, the serving ladder
``apply_serving``, the serving flow and the serving power on the serving
hour, completions, dispatch, grid signals, power chain, thermal derate,
rack update, congestion, telemetry counts, and the rest of the
accounting tail). Almost every such operation is one CUDA kernel on the
card, so the
split shows where a tick's launches go; ``profile_tick`` counts the
kernels themselves. A stage is a function of ``core`` that the step calls
through a module attribute: the tool wraps whichever of them the tree
has, so it reads a tree from before the fused tick entries as well, and
an operation counts for the innermost stage running. On the card a
kernel's launch is not an aten operation, so a fused entry counts only
its wrapper's output allocation; with ``--device cpu`` the plain
versions run instead and their operations count, so the CPU's numbers
are not the card's.

With an RL case (``acceptance.RL_CASES``) it counts the operations of
one PPO iteration over ``--replicas`` environments instead (one episode
of decisions, its auto-reset and the update; ``profile_tick.setup_rl``)
per env step, by ``profile_tick.rl_stages``' stages (the outermost stage
running takes an operation): sampling, key splits, the ``"rl"`` tick, the
idle ticks, observe, reset, update and the rest of the rollout.

``--macro`` macro-steps (``core.sim.make_macro_step``; the RL env with
``macro=True``, whose macro advance is the stage "idle ticks"). For a
replay case it runs ``--ticks`` simulated ticks through the macro step
and prints the operations per event tick and per fast tick, each by
stage (the fast tick's commit and the event tick's horizons are stages
of their own), the macro loop's own operations per macro step (the
reads' reductions), and the host reads per macro step.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

# (stage, module, attribute): what each stage runs, old and new names
STAGES = (
    ("apply_faults", "faults", "apply_faults"),
    ("apply_serving", "serving", "apply_serving"),
    ("serving flow", "serving", "serving_flow"),
    ("serving power", "serving", "serving_power"),
    ("serving trigger", "serving", "serving_trigger"),
    ("horizon", "serving", "serving_crossing_horizon"),
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
    ("horizon", "sim", "_horizon_parts"),
    ("horizon", "thermal", "thermal_crossing_horizon"),
    ("commit", "sim", "_where_tree"),
    ("commit", "sim", "_where_leaf"),
)


def main(argv=None) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    import importlib

    from repro_torch.configs import acceptance
    from repro_torch.core import schedulers as sched
    from repro_torch.tools.profile_tick import setup_case

    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="replay_tx_gaia_1h",
                    choices=sorted(acceptance.CASES)
                    + sorted(acceptance.FAULT_CASES)
                    + [acceptance.SERVING_CASE]
                    + sorted(acceptance.RL_CASES))
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--macro", action="store_true",
                    help="macro-step (replay: --ticks simulated ticks; "
                    "RL: the macro env)")
    args = ap.parse_args(argv)

    stack = ["rest of the tail"]
    counts = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            # a profiler range's markers (the macro engine's ticks) are
            # not operations of the tick
            if not getattr(func, "is_view", False) \
                    and func.namespace != "profiler":
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

    if args.case in acceptance.RL_CASES:
        return rl_ops(args, Count, stack, counts)

    modules = {}
    for mod in {m for _, m, _ in STAGES}:
        try:
            modules[mod] = importlib.import_module(f"repro_torch.core.{mod}")
        except ImportError:      # a tree from before that module
            modules[mod] = None
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
                                         args.replicas, args.macro)
        if args.macro:
            return macro_ops(args, step, state, stack, counts)
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


def macro_ops(args, ms, state, stack, counts) -> int:
    """Operations per event tick and per fast tick by stage, the loop's
    own per macro step, and host reads per macro step, over ``--ticks``
    simulated ticks of the macro step ``ms``: each operation counts for
    the kind of tick running and the innermost stage ("kind: stage")."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import acceptance
    from repro_torch.core import sim
    from repro_torch.tools.profile_tick import telem_zero
    from repro_torch.utils import device as D

    # the kind of tick running: the engine runs each tick inside its
    # profiler range (``sim.TICK_RANGES``), whose markers pass through here
    kinds = {name: f"{k} tick" for k, name in sim.TICK_RANGES.items()}
    ranges = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            if func.namespace == "profiler":
                if func.__name__.startswith("_record_function_enter"):
                    ranges.append(fargs[0])
                elif ranges:
                    ranges.pop()
            elif not getattr(func, "is_view", False):
                now = next((kinds[r] for r in reversed(ranges)
                            if r in kinds), "macro loop")
                counts[f"{now}: {stack[-1]}"] += 1
            return func(*fargs, **(kwargs or {}))

    acc = telem_zero(acceptance.config(args.case), state)
    sim.reset_macro_ticks()
    D.reset_host_reads()
    counts.clear()
    with Count():
        ms.run(state, acc, args.ticks)
    n = {"event tick": sim.MACRO_TICKS["event"],
         "fast tick": sim.MACRO_TICKS["fast"],
         "macro loop": sim.MACRO_TICKS["event"]}
    per = {k: {} for k in n}
    for key, v in sorted(counts.items()):
        k, stage = key.split(": ", 1)
        per[k][stage] = v / max(n[k], 1)
    print(json.dumps({
        "case": args.case, "replicas": args.replicas,
        "start_tick": args.start, "ticks": args.ticks,
        "device": str(state.t.device), "event_ticks": n["event tick"],
        "fast_ticks_issued": n["fast tick"],
        "host_reads_per_macro_step":
            D.HOST_READS["count"] / max(n["event tick"], 1),
        "aten_ops_per_event_tick": sum(per["event tick"].values()),
        "aten_ops_per_fast_tick": sum(per["fast tick"].values()),
        "loop_aten_ops_per_macro_step": sum(per["macro loop"].values()),
        "by_stage_per_event_tick": per["event tick"],
        "by_stage_per_fast_tick": per["fast tick"],
        "by_stage_per_macro_step_loop": per["macro loop"]}), flush=True)
    return 0


def rl_ops(args, count_mode, stack, counts) -> int:
    """Operations per env step of one PPO iteration, by stage."""
    import contextlib

    import torch

    from repro_torch.configs import acceptance
    from repro_torch.tools.profile_tick import rl_stages, setup_rl

    @contextlib.contextmanager
    def hook(stage):
        stack.append(stage)
        try:
            yield
        finally:
            stack.pop()

    env, policy, iteration, carry = setup_rl(args.case, args.replicas,
                                             args.device, macro=args.macro)
    stack[:] = ["rest of the rollout"]
    step0 = torch.zeros((), dtype=torch.int32, device=env.device)
    counts.clear()
    with rl_stages(env, policy, hook), count_mode():
        iteration(*carry, step0)
    steps = acceptance.RL_EPISODE_STEPS
    per_step = {k: v / steps for k, v in sorted(counts.items())}
    print(json.dumps({"case": args.case, "replicas": args.replicas,
                      "env_steps": steps, "device": str(env.device),
                      "macro": env.macro,
                      "aten_ops_per_env_step": sum(per_step.values()),
                      "by_stage": per_step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
