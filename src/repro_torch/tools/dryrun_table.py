"""Print the dry-run's records (``launch/dryrun.py``'s JSON files) as one
markdown table: a row per (arch, shape) that traced, each cell ``single /
multi``: FLOPs and collective bytes a device (by kind), argument and temp
GiB, the trace's seconds; then the cells that were skipped or failed,
grouped by their reason.

    python -m repro_torch.tools.dryrun_table --records build/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os

KINDS = {"all-gather": "AG", "reduce-scatter": "RS", "all-reduce": "AR",
         "all-to-all": "A2A", "collective-permute": "CP"}


def load(directory: str, tag: str = "") -> dict:
    """(arch, shape, mesh) -> record, for the files of ``tag``."""
    out = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        parts = os.path.basename(path)[:-5].split("__")
        if len(parts) != 3 + bool(tag) or (tag and parts[3] != tag):
            continue
        with open(path) as f:
            out[tuple(parts[:3])] = json.load(f)
    return out


def _si(x: float) -> str:
    for unit, div in (("P", 1e15), ("T", 1e12), ("G", 1e9), ("M", 1e6),
                      ("k", 1e3)):
        if abs(x) >= div:
            return f"{x / div:.3g}{unit}"
    return f"{x:.3g}"


def _cell(rec: dict | None, what: str) -> str:
    if rec is None or rec["status"] != "OK":
        return "-"
    mem = rec["memory"]
    if what == "flops":
        return _si(rec["hlo_flops_per_dev"])
    if what == "coll":
        by = rec["collectives"]["bytes_by_kind"]
        return " ".join(f"{KINDS.get(k, k)} {_si(v)}"
                        for k, v in sorted(by.items()) if v)
    if what == "mem":
        return (f"{mem['argument_bytes'] / 2**30:.2f} + "
                f"{mem['temp_bytes'] / 2**30:.2f}")
    return f"{rec['compile_s']:.1f}"


def table(cells: dict) -> str:
    keys = sorted({(a, s) for a, s, _ in cells})
    rows = ["| arch | shape | FLOPs/dev | collective B/dev | arg + temp GiB "
            "| trace s |", "| --- | --- | --- | --- | --- | --- |"]
    other: dict = {}
    for arch, shape in keys:
        pair = [cells.get((arch, shape, m)) for m in ("single", "multi")]
        for m, r in zip(("single", "multi"), pair):
            if r is not None and r["status"] != "OK":
                why = (r.get("reason") or r.get("error", "")).split(":")[0]
                if r["status"] == "FAIL" and why.startswith(
                        "NotImplementedError"):
                    why = "refused: check_mesh_serving"
                other.setdefault((r["status"], why), []).append(
                    f"{arch} {shape} {m}")
        if any(r is not None and r["status"] == "OK" for r in pair):
            rows.append(f"| {arch} | {shape} | " + " | ".join(
                " / ".join(_cell(r, what) for r in pair)
                for what in ("flops", "coll", "mem", "trace")) + " |")
    n = {k: sum(r["status"] == k for r in cells.values())
         for k in ("OK", "SKIP", "FAIL")}
    return "\n".join(
        [f"cells: {n['OK']} OK / {n['SKIP']} SKIP / {n['FAIL']} FAIL", ""]
        + rows + [""] + [f"- {st} ({why}): {', '.join(names)}"
                         for (st, why), names in sorted(other.items())])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", default="experiments/artifacts")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(table(load(args.records, args.tag)))


if __name__ == "__main__":
    main()
