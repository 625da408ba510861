"""Structured validation for trace / signal / jobs-dict ingestion.

Real SuperCloud exports (and grid-operator CSV feeds) arrive with the
usual defects: unparseable cells, NaN/Inf columns, end-before-start
timestamps, duplicate job ids, partitions that no longer exist. This
module is the single validation pass wired into
``trace_io.load_supercloud``, ``grid_signals.load_signal_csv`` and the
jobs-dict path (``core.state.load_jobs``):

- ``strict`` mode raises a typed error (`TraceValidationError` /
  `SignalValidationError`) whose message names every failed check and
  the offending row indices, with the full machine-readable report
  attached as ``err.report``;
- ``repair`` mode quarantines bad rows (interpolates bad samples, for
  uniform-grid signals) and returns an `IngestionReport` that accounts
  for **every** dropped row: ``n_input == n_ok + n_quarantined`` always
  holds, so downstream tooling can audit exactly what was discarded;
- ``off`` skips validation (trusted in-memory synthetic data).

Checks that cannot be repaired row-wise (a signal feed with too few
samples or a non-uniform time grid) raise in both modes — there is no
sound repair, and silently resampling would fabricate data.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.utils.errors import (
    ConfigError,
    SignalValidationError,
    TraceValidationError,
)

MODES = ("strict", "repair", "off")

# columns of scheduler-log.csv that must parse as finite numbers
_SCHED_NUMERIC = (
    "job_id", "time_submit", "time_start", "time_end",
    "nodes_alloc", "cpus_req", "gpus_req", "mem_req_gb",
)


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ConfigError(
            f"validation mode must be one of {MODES}, got {mode!r}")
    return mode


@dataclasses.dataclass
class IngestionReport:
    """Machine-readable account of one validation pass.

    ``quarantined`` holds one entry per dropped/repaired row:
    ``{"row": <0-based index>, "check": <check name>, "detail": <str>}``
    (plus ``"job_id"`` where applicable). ``warnings`` are advisory —
    the row was kept (e.g. unknown partition name resolved through the
    documented type fallback). The invariant every consumer may rely on:
    ``n_input == n_ok + n_quarantined``.
    """

    source: str
    kind: str                      # "trace" | "telemetry" | "signal" | "jobs"
    mode: str
    n_input: int = 0
    n_ok: int = 0
    quarantined: List[dict] = dataclasses.field(default_factory=list)
    warnings: List[dict] = dataclasses.field(default_factory=list)
    n_skipped_unknown_id: int = 0   # telemetry rows for ids outside the log

    @property
    def n_quarantined(self) -> int:
        return len(self.quarantined)

    @property
    def clean(self) -> bool:
        return not self.quarantined

    def counts(self) -> Dict[str, int]:
        """``{check name: number of quarantined rows}``."""
        return dict(Counter(e["check"] for e in self.quarantined))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["n_quarantined"] = self.n_quarantined
        d["counts"] = self.counts()
        return d

    def describe(self, max_rows: int = 8) -> str:
        """One-line actionable summary naming checks and row indices."""
        if self.clean:
            return f"{self.source}: {self.n_ok}/{self.n_input} rows ok"
        parts = []
        by_check: Dict[str, List[int]] = {}
        for e in self.quarantined:
            by_check.setdefault(e["check"], []).append(e["row"])
        for check, idxs in by_check.items():
            shown = ", ".join(str(i) for i in idxs[:max_rows])
            more = f", +{len(idxs) - max_rows} more" if len(idxs) > max_rows \
                else ""
            parts.append(f"{check}: {len(idxs)} row(s) [{shown}{more}]")
        return (f"{self.source}: {self.n_quarantined}/{self.n_input} row(s) "
                f"failed validation — " + "; ".join(parts))

    def raise_if_dirty(self, exc_cls) -> None:
        if self.quarantined:
            raise exc_cls(self.describe(), report=self)


# ---------------------------------------------------------------- scheduler

def validate_sched_rows(
    rows: List[dict],
    cfg=None,
    *,
    mode: str = "repair",
    source: str = "scheduler-log.csv",
) -> Tuple[List[dict], IngestionReport]:
    """Validate raw ``csv.DictReader`` rows of a scheduler log.

    Checks, in order per row: required columns present and parseable,
    finite values, ``submit <= start <= end`` (monotone per-job
    timestamps), non-negative submit time, ``nodes_alloc >= 1``,
    non-negative resource requests, unique job ids (first occurrence
    wins). Unknown partition names are a *warning*, never a quarantine —
    the documented fallback (GPU jobs -> first GPU type, else first
    CPU-only type) is load-bearing for renamed-partition traces.
    """
    _check_mode(mode)
    rep = IngestionReport(source=source, kind="trace", mode=mode,
                          n_input=len(rows))
    if mode == "off":
        rep.n_ok = len(rows)
        return rows, rep

    type_names = {t.name for t in cfg.node_types} if cfg is not None else None
    kept: List[dict] = []
    seen_ids: set = set()
    prev_submit = -math.inf
    for i, r in enumerate(rows):
        vals = {}
        bad: Optional[Tuple[str, str]] = None
        for col in _SCHED_NUMERIC:
            raw = r.get(col)
            if raw is None or raw == "":
                bad = ("missing_column", f"column {col!r} absent/empty")
                break
            try:
                vals[col] = float(raw)
            except (TypeError, ValueError):
                bad = ("unparseable", f"{col}={raw!r}")
                break
        if bad is None:
            if not all(math.isfinite(vals[c]) for c in _SCHED_NUMERIC):
                cols = [c for c in _SCHED_NUMERIC
                        if not math.isfinite(vals[c])]
                bad = ("non_finite", f"NaN/Inf in {cols}")
            elif not (vals["time_submit"] <= vals["time_start"]
                      <= vals["time_end"]):
                bad = ("non_monotone_times",
                       f"submit={vals['time_submit']} start="
                       f"{vals['time_start']} end={vals['time_end']}")
            elif vals["time_submit"] < 0:
                bad = ("negative_time", f"time_submit={vals['time_submit']}")
            elif vals["nodes_alloc"] < 1:
                bad = ("bad_node_count", f"nodes_alloc={vals['nodes_alloc']}")
            elif min(vals["cpus_req"], vals["gpus_req"],
                     vals["mem_req_gb"]) < 0:
                bad = ("negative_request",
                       f"cpus={vals['cpus_req']} gpus={vals['gpus_req']} "
                       f"mem_gb={vals['mem_req_gb']}")
            elif int(vals["job_id"]) in seen_ids:
                bad = ("duplicate_job_id", f"job_id={int(vals['job_id'])} "
                       "already seen (first occurrence kept)")
        if bad is not None:
            rep.quarantined.append({
                "row": i, "job_id": r.get("job_id"),
                "check": bad[0], "detail": bad[1]})
            continue
        seen_ids.add(int(vals["job_id"]))
        if vals["time_submit"] < prev_submit and not any(
                w["check"] == "unsorted_submit" for w in rep.warnings):
            rep.warnings.append({
                "row": i, "check": "unsorted_submit",
                "detail": "submit column not globally sorted (harmless: "
                          "replay dispatches at recorded starts)"})
        prev_submit = max(prev_submit, vals["time_submit"])
        if type_names is not None:
            pname = r.get("partition", "")
            if pname not in type_names:
                rep.warnings.append({
                    "row": i, "check": "unknown_partition",
                    "detail": f"partition={pname!r} -> documented type "
                              "fallback"})
        kept.append(r)
    rep.n_ok = len(kept)
    if mode == "strict":
        rep.raise_if_dirty(TraceValidationError)
    return kept, rep


# ---------------------------------------------------------------- telemetry

def check_telemetry_row(
    row: dict,
    *,
    util_col: str,
    lo: float,
    hi: float,
    rownum: int,
    report: IngestionReport,
) -> Optional[Tuple[int, float, float]]:
    """Parse + validate one telemetry row; ``None`` means quarantined.

    Utilization must land in ``[lo, hi]`` (cpu_util in [0,1], gpu
    util_pct in [0,100]); timestamps must be finite and non-negative.
    """
    try:
        jid = int(float(row["job_id"]))
        t = float(row["timestamp"])
        u = float(row[util_col])
    except (KeyError, TypeError, ValueError) as e:
        report.quarantined.append({
            "row": rownum, "job_id": row.get("job_id"),
            "check": "unparseable", "detail": repr(e)})
        return None
    if not (math.isfinite(t) and math.isfinite(u)):
        report.quarantined.append({
            "row": rownum, "job_id": row.get("job_id"),
            "check": "non_finite",
            "detail": f"timestamp={t} {util_col}={u}"})
        return None
    if t < 0:
        report.quarantined.append({
            "row": rownum, "job_id": row.get("job_id"),
            "check": "negative_time", "detail": f"timestamp={t}"})
        return None
    if not (lo <= u <= hi):
        report.quarantined.append({
            "row": rownum, "job_id": row.get("job_id"),
            "check": "util_out_of_range",
            "detail": f"{util_col}={u} outside [{lo}, {hi}]"})
        return None
    return jid, t, u


# ---------------------------------------------------------------- jobs dict

_JOBS_REQUIRED = ("submit_t", "dur", "n_nodes", "req")


def validate_jobs(
    jobs: Dict[str, np.ndarray],
    *,
    mode: str = "strict",
    source: str = "jobs dict",
    n_types: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], IngestionReport]:
    """Validate an in-memory jobs dict (the ``load_jobs`` input shape).

    Per-job checks: finite values everywhere, ``dur > 0``,
    ``submit_t >= 0``, ``n_nodes >= 1``, ``req >= 0``, and (when present)
    ``part`` in ``[-1, n_types)``. Structural defects — missing keys or
    mismatched column lengths — raise in every mode: a column-length
    mismatch cannot be repaired row-wise because row identity is
    ambiguous. Repair mode drops bad jobs from every column coherently.
    """
    _check_mode(mode)
    rep = IngestionReport(source=source, kind="jobs", mode=mode)
    if mode == "off":
        rep.n_input = rep.n_ok = len(np.atleast_1d(jobs["submit_t"]))
        return jobs, rep

    missing = [k for k in _JOBS_REQUIRED if k not in jobs]
    if missing:
        raise TraceValidationError(
            f"{source}: missing required key(s) {missing}", report=rep)
    arrs = {k: np.asarray(v) for k, v in jobs.items()}
    J = arrs["submit_t"].shape[0]
    rep.n_input = J
    for k, v in arrs.items():
        n = v.shape[-1] if k == "req" else v.shape[0]
        if n != J:
            raise TraceValidationError(
                f"{source}: column {k!r} has {n} jobs, expected {J} "
                "(mismatched column lengths are not row-repairable)",
                report=rep)
    if arrs["req"].ndim != 2 or arrs["req"].shape[0] != 3:
        raise TraceValidationError(
            f"{source}: req must have shape (3, J), got "
            f"{arrs['req'].shape}", report=rep)

    checks = [
        ("non_finite", ~np.all(
            [np.isfinite(np.asarray(v, np.float64)).reshape(-1, J).all(0)
             for v in arrs.values()], axis=0)),
        ("non_positive_duration", np.asarray(arrs["dur"]) <= 0),
        ("negative_time", np.asarray(arrs["submit_t"]) < 0),
        ("bad_node_count", np.asarray(arrs["n_nodes"]) < 1),
        ("negative_request", (np.asarray(arrs["req"]) < 0).any(axis=0)),
    ]
    if "part" in arrs:
        part = np.asarray(arrs["part"])
        bad_part = part < -1
        if n_types is not None:
            bad_part |= part >= n_types
        checks.append(("bad_partition", bad_part))

    bad = np.zeros(J, bool)
    for check, mask in checks:
        mask = np.asarray(mask, bool) & ~bad   # first failing check wins
        for j in np.nonzero(mask)[0]:
            rep.quarantined.append({
                "row": int(j), "check": check,
                "detail": f"job index {int(j)}"})
        bad |= mask
    rep.n_ok = int(J - bad.sum())
    if mode == "strict":
        rep.raise_if_dirty(TraceValidationError)
    if bad.any():
        keep = ~bad
        jobs = {k: (v[:, keep] if k == "req" else v[keep])
                for k, v in arrs.items()}
    return jobs, rep


# ------------------------------------------------------------------ signals

def validate_signal_samples(
    t: np.ndarray,
    v: np.ndarray,
    *,
    mode: str = "strict",
    source: str = "signal",
    min_len: int = 2,
) -> Tuple[np.ndarray, np.ndarray, IngestionReport]:
    """Validate a ``(timestamps, values)`` signal feed.

    Structural checks (raise `SignalValidationError` in every mode — no
    sound row-wise repair exists): at least ``min_len`` samples, finite
    strictly-increasing timestamps, uniform spacing (tolerance 1e-3 of
    the median step). Value checks: finite everywhere; ``repair`` mode
    linearly interpolates non-finite samples over the uniform grid
    (keeping feed length — dropping rows would break uniformity) and
    records each repaired index in the report.
    """
    _check_mode(mode)
    t = np.asarray(t, np.float64).reshape(-1)
    v = np.asarray(v, np.float64).reshape(-1)
    rep = IngestionReport(source=source, kind="signal", mode=mode,
                          n_input=len(t))
    if mode == "off":
        rep.n_ok = len(t)
        return t, v.astype(np.float32), rep

    if len(t) != len(v):
        raise SignalValidationError(
            f"{source}: {len(t)} timestamps vs {len(v)} values", report=rep)
    if len(t) < min_len:
        raise SignalValidationError(
            f"{source}: need >= {min_len} samples, got {len(t)}", report=rep)
    if not np.isfinite(t).all():
        idx = np.nonzero(~np.isfinite(t))[0]
        raise SignalValidationError(
            f"{source}: non-finite timestamp(s) at row(s) "
            f"{idx[:8].tolist()}", report=rep)
    dts = np.diff(t)
    if (dts <= 0).any():
        idx = int(np.nonzero(dts <= 0)[0][0])
        raise SignalValidationError(
            f"{source}: timestamps not strictly increasing at row "
            f"{idx + 1} (t[{idx}]={t[idx]} -> t[{idx + 1}]={t[idx + 1]})",
            report=rep)
    dt = float(np.median(dts))
    off_grid = np.abs(dts - dt) > 1e-3 * max(dt, 1.0)
    if off_grid.any():
        idx = int(np.nonzero(off_grid)[0][0])
        raise SignalValidationError(
            f"{source}: timestamps not uniformly spaced (median step "
            f"{dt:.6g}, step {idx}->{idx + 1} is {dts[idx]:.6g}); "
            "resample upstream", report=rep)

    bad = ~np.isfinite(v)
    for i in np.nonzero(bad)[0]:
        rep.quarantined.append({
            "row": int(i), "check": "non_finite_value",
            "detail": f"value[{int(i)}]={v[int(i)]!r}"})
    rep.n_ok = int(len(v) - bad.sum())
    if mode == "strict":
        rep.raise_if_dirty(SignalValidationError)
    if bad.any():
        if bad.all():
            raise SignalValidationError(
                f"{source}: every value is non-finite; nothing to "
                "interpolate from", report=rep)
        good = np.nonzero(~bad)[0]
        v = v.copy()
        v[bad] = np.interp(np.nonzero(bad)[0], good, v[good])
    return t, v.astype(np.float32), rep


__all__ = [
    "MODES",
    "IngestionReport",
    "validate_sched_rows",
    "check_telemetry_row",
    "validate_jobs",
    "validate_signal_samples",
]
