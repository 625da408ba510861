"""Parent against change on one card, in one run: host ms per tick in
interleaved pairs, and each side's ``profile_tick`` and ``tick_ops``.

    mkdir -p build/parent && git archive HEAD~ | tar -x -C build/parent
    PYTHONPATH=src python3 -m repro_torch.tools.compare_tick \
        --parent build/parent [--pairs 10] [--window 200] [--case ...] \
        [--replicas E]

For each case it starts one worker process per checkout. Each builds the
case and runs it to tick ``--start``; then the two take turns, ``--pairs``
times, each timing the next ``--window`` ticks on the host clock around a
synchronised loop (the order flips every pair, so drift in the host's
speed falls on both sides, and both sides time the same simulated ticks).
Then it runs ``profile_tick`` (CUDA kernels, device us per tick) and
``tick_ops`` (operations per tick by stage) on each checkout. Every tool,
the workers too, runs as this checkout's copy over the package of the
side it measures, so both sides are measured by the same code and
nothing is written into the parent's tree. Prints each tool's JSON line
with ``tree`` added, then one summary line per case: every window's ms
per tick, each side's median and interquartile range, and how many pairs
the change won. ``--replicas E`` > 1 runs every side as a fleet of E
replicas (``profile_tick.setup_case``), so both trees need
``core.fleet``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
CHANGE = HERE.parents[3]
# runs tools/<argv[2]> of this checkout (argv[1]) over the repro_torch
# package on PYTHONPATH, with the rest of argv as its arguments
_RUN_HERE = ("import runpy, sys; import repro_torch.tools as t; "
             "t.__path__[:] = [sys.argv[1]]; m = sys.argv[2]; "
             "sys.argv = [m] + sys.argv[3:]; "
             "runpy.run_module('repro_torch.tools.' + m, run_name='__main__')")
CASES = ("replay_tx_gaia_1h", "replay_tx_gaia_1h_thermal",
         "replay_tx_gaia_1h_thermal_stress")


def worker(case: str, start: int, replicas: int) -> int:
    """Run ``case`` to tick ``start``, then time the next N ticks for each
    N read from stdin, printing ms per tick, until stdin closes."""
    import torch

    from repro_torch.tools.profile_tick import setup_case

    step, state, action = setup_case(case, start, replicas=replicas)
    torch.cuda.synchronize()
    print("ready", flush=True)
    for line in sys.stdin:
        n = int(line)
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, action)
        torch.cuda.synchronize()
        print(1e3 * (time.perf_counter() - t0) / n, flush=True)
    return 0


def _env(tree: Path) -> dict:
    return dict(os.environ, PYTHONPATH=str(tree / "src"))


def _cmd(module: str, *args) -> list:
    return [sys.executable, "-c", _RUN_HERE, str(HERE.parent), module,
            *args]


def _tool(tree: Path, module: str, args) -> dict:
    out = subprocess.run(
        _cmd(module, *args), cwd=tree, env=_env(tree), check=True,
        capture_output=True, text=True, timeout=1800).stdout
    return json.loads(out.strip().splitlines()[-1])


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0], q[2]]


def compare(trees: dict, case: str, pairs: int, window: int,
            start: int, replicas: int) -> dict:
    procs = {}
    try:
        for side, tree in trees.items():
            procs[side] = subprocess.Popen(
                _cmd("compare_tick", "--worker", "--case", case, "--start",
                     str(start), "--replicas", str(replicas)),
                cwd=tree, env=_env(tree), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
        for p in procs.values():
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError("compare_tick: a worker failed to start")
        ms = {side: [] for side in trees}
        for pair in range(pairs):
            order = ("parent", "change") if pair % 2 == 0 else ("change",
                                                                "parent")
            for side in order:
                procs[side].stdin.write(f"{window}\n")
                procs[side].stdin.flush()
                ms[side].append(float(procs[side].stdout.readline()))
    finally:
        for p in procs.values():
            if p.stdin:
                p.stdin.close()
            p.wait(timeout=600)
    wins = sum(c < p for c, p in zip(ms["change"], ms["parent"]))
    return {side: {"ms_per_tick": v, "median": statistics.median(v),
                   "quartiles": _quartiles(v)} for side, v in ms.items()} | {
        "pairs": pairs, "window_ticks": window, "start_tick": start,
        "change_wins": wins}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--case", nargs="+", default=list(CASES))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--window", type=int, default=200)
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_tick: needs a CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        return worker(args.case[0], args.start, args.replicas)
    if args.parent is None:
        ap.error("--parent is required")
    trees = {"parent": args.parent.resolve(), "change": CHANGE}
    device = torch.cuda.get_device_name(0)
    for case in args.case:
        for side, tree in trees.items():
            for module in ("profile_tick", "tick_ops"):
                rec = _tool(tree, module, ["--case", case, "--replicas",
                                           str(args.replicas)])
                print(json.dumps({"tree": side, **rec}), flush=True)
        summary = compare(trees, case, args.pairs, args.window, args.start,
                          args.replicas)
        print(json.dumps({"case": case, "replicas": args.replicas,
                          "device": device,
                          "host_ms_per_tick": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
