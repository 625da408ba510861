"""Wall time of each example (``repro_torch.examples``) run once at its
JAX example's sizes, each as its own process on the card.

    PYTHONPATH=src python3 -m repro_torch.tools.time_examples \
        [--only quickstart,virtual_cloud] [--out DIR]

Prints, per example, one JSON line: the wall seconds of the process
(start-up, imports and the kernels' first load included), its exit code
and the last lines it printed; then the card's ``nvidia-smi`` name and
power limit. With ``--out``, each example's whole output goes to
``<out>/<name>.txt``. Exits non-zero if any example failed. Needs a CUDA
device: the examples run on the card and never fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

EXAMPLES = ("quickstart", "replay_supercloud", "rl_scheduler",
            "scenario_sweep", "virtual_cloud")
TAIL_LINES = 12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(EXAMPLES),
                    help="comma-separated examples to run")
    ap.add_argument("--out", default="",
                    help="directory for each example's whole output")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.only.split(",") if n.strip()]
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    failed = 0
    for name in names:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}"],
            capture_output=True, text=True, env=env)
        wall_s = time.perf_counter() - t0
        if args.out:
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{name}.txt").write_text(proc.stdout + proc.stderr)
        failed += proc.returncode != 0
        print(json.dumps({
            "example": name, "wall_s": wall_s, "rc": proc.returncode,
            "tail": (proc.stdout + proc.stderr).splitlines()[-TAIL_LINES:],
        }), flush=True)
    print(card_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
