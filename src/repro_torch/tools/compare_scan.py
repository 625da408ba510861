"""Parent against change on one card, in one run: the selective scan's
kernel times at jamba's prefill, the design trials, and each side's
hybrid prefill profile.

    mkdir -p build/parent && git archive HEAD~ | tar -x -C build/parent
    PYTHONPATH=src python3 -m repro_torch.tools.compare_scan \
        --parent build/parent [--reps 10] [--trials all] [--no-profile]

At jamba's 8-layer prefill shape (Ba 4, S 1024, di 16384, ds 16) it times
(CUDA events: the median of ``--reps`` batches of 5 back-to-back calls,
after warm-up) the signature entry ``selective_scan`` in f32 (the
parent's only entry) and the fused entry ``mamba_scan`` in bf16 and f32,
where the side has it: in four processes in the order parent, change,
change, parent, with each trial of ``--trials`` between the two changes.

A trial is a copy of one side's ``src/repro_torch`` under
``build/scan_trials/<name>`` with ``csrc/selective_scan.cu`` edited by the
text substitutions of ``TRIALS`` (each must match once), built and timed
like a side: the designs the kernel did not keep (other lane counts,
``expf`` decays, a tree for y's sum, an approximate softplus in bf16),
and the parent's kernel with its ``expf`` decays, and then its separate
multiplies and adds too, turned into what the new kernel does. Then
``profile_serve --case serve_jamba_8l`` on each side (unless
``--no-profile``). Every tool runs as this checkout's copy over the
package of the tree it measures, and inputs come from the same seeds on
every tree, so all are measured by the same code on the same data;
nothing is written into the parent's tree. Prints one JSON line per
timing and per profiled phase, with the tree and the card's
``nvidia-smi`` name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.tools.compare_tick import CHANGE, _cmd, _env

JAMBA = (4, 1024, 16384, 16)   # (Ba, S, di, ds)
DT_RANK = 512                  # jamba's x_proj: dt_rank + 2 ds columns
BATCH = 5                      # back-to-back calls per timed batch

_CHAIN = """      float y = s[0] * cv[0];
#pragma unroll
      for (int n = 1; n < N; ++n) y = __fmaf_rn(s[n], cv[n], y);
"""
_TREE = """      float p[N];
#pragma unroll
      for (int n = 0; n < N; ++n) p[n] = s[n] * cv[n];
#pragma unroll
      for (int w = 1; w < N; w <<= 1) {
#pragma unroll
        for (int n = 0; n + w < N; n += 2 * w) p[n] += p[n + w];
      }
      float y = p[0];
"""
_LANES = "constexpr int lanes_for(int ds) { return ds == 32 ? 2 : 1; }"
_SOFTPLUS = "  return v > 20.0f ? v : log1pf(expf(v));\n"
# log1p(e) as a series below e = 1/16, where 1 + e would lose e's low bits
_SOFTPLUS_APPROX = """  const float e = ex2_approx(v * kLog2e);
  float l;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.0f + e));
  const float lp =
      e < 0.0625f ? e * (1.0f - e * (0.5f - e * (0.33333334f - e * 0.25f)))
                  : l * 0.6931471805599453f;
  return v > 20.0f ? v : lp;
"""
_PARENT_EX2 = ("expf(dtt * a[n])", "__expf(dtt * a[n])")
# name: (the side it edits, [(old, new), ...] in csrc/selective_scan.cu)
TRIALS = {
    "lanes2": ("change", [(_LANES, _LANES.replace(": 1;", ": 2;"))]),
    "lanes4": ("change", [(_LANES, _LANES.replace(": 1;", ": 4;"))]),
    "expf": ("change", [("ex2_approx(dtt * A2[n])", "expf(dtt * A2[n])"),
                        ("A2[n] = av * kLog2e;", "A2[n] = av;")]),
    "tree": ("change", [(_CHAIN, _TREE)]),
    "softplus_approx": ("change", [(_SOFTPLUS, _SOFTPLUS_APPROX)]),
    "parent_ex2": ("parent", [_PARENT_EX2]),
    "parent_ex2_fma": ("parent", [
        _PARENT_EX2,
        ("decay * s[n] + dtx * bt[n]", "__fmaf_rn(decay, s[n], dtx * bt[n])"),
        ("acc = acc + s[n] * ct[n]", "acc = __fmaf_rn(s[n], ct[n], acc)")]),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median per-call ms of ``fn`` over ``reps`` batches, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    times.sort()
    return times[len(times) // 2]


def time_side(reps: int) -> list:
    """Every entry of the package on PYTHONPATH at JAMBA."""
    import numpy as np
    import torch

    from repro_torch.kernels import selective_scan as pss

    ba, s, di, ds = JAMBA
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()

    def uniform(lo, hi, *shape):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).cuda()

    A = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device="cuda").expand(di, ds).contiguous()
    x, dt = normal(ba, s, di), uniform(1e-3, 0.1, ba, s, di)
    B, C = normal(ba, s, ds), normal(ba, s, ds)
    recs = [dict(entry="selective_scan", dtype="float32", ms=time_ms(
        torch, lambda: pss.selective_scan(x, dt, A, B, C), reps))]
    del x, dt, B, C
    if hasattr(pss, "mamba_scan"):
        xz, proj = normal(ba, s, 2 * di), normal(ba, s, DT_RANK + 2 * ds)
        xb, dt_proj = normal(ba, s, di), 0.5 * normal(ba, s, di)
        dt_b, D = uniform(-6.9, -2.3, di), normal(di)
        for dtype in ("bfloat16", "float32"):
            cast = [t.to(getattr(torch, dtype))
                    for t in (xb, dt_proj, dt_b, xz, proj, D)]
            xb_, dtp_, dtb_, xz_, proj_, d_ = cast
            args = (xb_, dtp_, dtb_, A, proj_[..., DT_RANK:DT_RANK + ds],
                    proj_[..., DT_RANK + ds:], xz_[..., di:], d_)
            recs.append(dict(entry="mamba_scan", dtype=dtype, ms=time_ms(
                torch, lambda: pss.mamba_scan(*args), reps)))
            del cast, args
    return recs


def make_trial(name: str, trees: dict) -> Path:
    """The tree of trial ``name``: its side's package, the kernel edited."""
    side, edits = TRIALS[name]
    root = CHANGE / "build" / "scan_trials" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(trees[side] / "src" / "repro_torch",
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / "src" / "repro_torch" / "kernels" / "csrc" / "selective_scan.cu"
    text = cu.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"trial {name}: {old!r} occurs "
                             f"{text.count(old)} times in {side}'s kernel")
        text = text.replace(old, new)
    cu.write_text(text)
    return root


def _run(tree: Path, module: str, args) -> list:
    out = subprocess.run(
        _cmd(module, *args), cwd=tree, env=_env(tree), check=True,
        capture_output=True, text=True, timeout=1800).stdout
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trials", default="all",
                    help=f"comma-separated of {sorted(TRIALS)}, all or none")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--time", action="store_true",
                    help="time the package on PYTHONPATH (one tree)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_scan: needs a CUDA device", file=sys.stderr)
        return 1
    if args.time:
        for rec in time_side(args.reps):
            print(json.dumps(rec), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    trials = (list(TRIALS) if args.trials == "all" else [] if
              args.trials == "none" else args.trials.split(","))
    trees = {"parent": args.parent.resolve(), "change": CHANGE}
    trees.update((name, make_trial(name, trees)) for name in trials)
    card = card_line()
    order = ["parent", "change", *trials, "change", "parent"]
    for run, tree in enumerate(order):
        for rec in _run(trees[tree], "compare_scan",
                        ["--time", "--reps", str(args.reps)]):
            print(json.dumps({"tree": tree, "run": run, "card": card,
                              **rec}), flush=True)
    if not args.no_profile:
        for side in ("parent", "change"):
            for rec in _run(trees[side], "profile_serve",
                            ["--case", "serve_jamba_8l"]):
                print(json.dumps({"tree": side, "card": card, **rec}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
