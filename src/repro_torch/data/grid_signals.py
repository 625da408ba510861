"""Grid-signal trace IO + synthesis for the scenario engine (a copy of the
JAX package's numpy-only module, pointed at the port's validator and
``Signal``).

Trace CSVs follow the common grid-operator export shape (e.g. electricityMap
/ WattTime / ISO day-ahead feeds, simplified to a uniform grid):

    timestamp_s,value
    0.0,412.5
    300.0,408.1
    ...

``load_signal_csv`` parses one into a ``scenarios.Signal`` (trace family,
linear interpolation at ``state.t``); ``write_signal_csv`` emits the same
schema so synthetic feeds round-trip through the parser. ``synth_grid_trace``
generates offline stand-ins for real feeds: carbon [gCO2/kWh] with a solar
trough + ramps, price [$/kWh] duck curve with evening spikes, wetbulb [degC]
diurnal weather with a mid-horizon heat event.
"""

from __future__ import annotations

import csv
import os
from typing import Tuple

import numpy as np

from repro_torch.data.validate import validate_signal_samples
from repro_torch.scenarios.signals import from_trace

SIGNAL_COLS = ["timestamp_s", "value"]


def _parses(x) -> bool:
    try:
        float(x)
        return True
    except (TypeError, ValueError):
        return False


def write_signal_csv(path: str, values: np.ndarray, dt: float,
                     t0: float = 0.0) -> str:
    """Write a uniform-grid signal trace CSV. Returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(values, np.float32).reshape(-1)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(SIGNAL_COLS)
        for i, x in enumerate(v):
            w.writerow([f"{t0 + i * dt:.3f}", f"{x:.6g}"])
    return path


def load_signal_csv(path: str, *, validate: str = "strict",
                    return_report: bool = False):
    """Parse a ``timestamp_s,value`` CSV into a trace Signal.

    Timestamps must be uniformly spaced (tolerance 1e-3 of the step);
    resample upstream if your feed is irregular. Validation is LOUD by
    default: non-finite values, non-monotone or non-uniform timestamps,
    and too-short feeds raise a typed
    :class:`~repro_torch.utils.errors.SignalValidationError` naming the
    offending rows — a NaN in a carbon/price feed would otherwise
    propagate silently through the interpolation into every accumulator.
    ``validate="repair"`` interpolates non-finite values over the uniform
    grid instead; ``return_report=True`` appends the
    :class:`~repro_torch.data.validate.IngestionReport`.
    """
    ts, vs = [], []
    with open(path) as f:
        for i, row in enumerate(csv.DictReader(f)):
            try:
                ts.append(float(row["timestamp_s"]))
                vs.append(float(row["value"]))
            except (KeyError, TypeError, ValueError):
                # unparseable cells become NaN so the validator's repair
                # path (interpolate) / strict path (raise with row index)
                # both see them; a bad timestamp is structural -> raise
                if _parses(row.get("timestamp_s")):
                    ts.append(float(row["timestamp_s"]))
                    vs.append(float("nan"))
                else:
                    from repro_torch.utils.errors import SignalValidationError
                    raise SignalValidationError(
                        f"{path}: unparseable timestamp_s="
                        f"{row.get('timestamp_s')!r} at row {i}") from None
    t, v, rep = validate_signal_samples(
        ts, vs, mode=validate, source=path)
    dt = float(np.median(np.diff(t))) if len(t) >= 2 else 1.0
    sig = from_trace(v, dt, t0=float(t[0]))
    return (sig, rep) if return_report else sig


def synth_grid_trace(
    kind: str,
    horizon_s: float,
    dt: float = 300.0,
    seed: int = 0,
) -> Tuple[np.ndarray, float]:
    """Synthesize a grid feed: kind in {'carbon','price','wetbulb'}.

    Returns (values, dt) ready for ``write_signal_csv`` / ``from_trace``.
    """
    rng = np.random.default_rng(seed)
    n = max(int(np.ceil(horizon_s / dt)) + 1, 2)
    t = np.arange(n) * dt
    day = 2 * np.pi * t / 86_400.0
    # smooth AR(1) weather/grid-mix wander shared by all kinds
    wander = np.zeros(n)
    for i in range(1, n):
        wander[i] = 0.97 * wander[i - 1] + rng.normal(0, 0.25)

    if kind == "carbon":
        # night-heavy baseline, midday solar trough, morning/evening ramps
        v = 420.0 + 130.0 * np.cos(day) - 90.0 * np.exp(
            -0.5 * ((t % 86_400.0 - 43_200.0) / 7_200.0) ** 2
        ) + 18.0 * wander
        v = np.clip(v, 40.0, 900.0)
    elif kind == "price":
        # duck curve + sparse evening spike events (scarcity pricing)
        v = 0.10 + 0.05 * np.sin(day - np.pi) + 0.004 * wander
        hour = (t % 86_400.0) / 3600.0
        evening = (hour > 17.0) & (hour < 21.0)
        spikes = evening & (rng.random(n) < 0.02)
        v = np.where(spikes, v * rng.uniform(3.0, 8.0, n), v)
        v = np.clip(v, 0.005, 2.0)
    elif kind == "wetbulb":
        # diurnal weather + a 6h heat event centered mid-horizon
        v = 16.0 - 6.0 * np.cos(day) + 1.2 * wander
        v += 7.0 * np.exp(-0.5 * ((t - horizon_s / 2) / (3 * 3600.0)) ** 2)
    else:
        raise KeyError(f"unknown grid signal kind {kind!r}")
    return v.astype(np.float32), dt
