"""Scheduled demand-response events: time-windowed facility power caps.

A ``CapSchedule`` holds up to n events, each ``[start_t, end_t)`` with a
facility-power cap in watts, plus a standing base cap. ``power_cap_at``
returns the effective cap at time t (the tightest of base + active events),
with 0.0 meaning "uncapped" — the ``cfg.power_cap_w`` convention consumed
by the DVFS throttle in ``core/sim.py``.

Fixed shape (n is padded, inactive slots have cap 0); a batched schedule
carries a leading replica axis on every leaf. The outage and
traffic-burst schedules arrive with the faults and serving slices.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

_INF = float("inf")


class CapSchedule(NamedTuple):
    start_t: torch.Tensor     # (n,) event window start [s]
    end_t: torch.Tensor       # (n,) event window end [s] (exclusive)
    cap_w: torch.Tensor       # (n,) facility cap during event [W]; 0 = padding
    base_cap_w: torch.Tensor  # 0-d standing cap [W]; 0 = uncapped


def no_cap(base_cap_w: float = 0.0, n_events: int = 1) -> CapSchedule:
    """Schedule with no events (only the standing base cap, if any)."""
    n = max(n_events, 1)
    z = torch.zeros((n,), dtype=torch.float32)
    return CapSchedule(start_t=z, end_t=z.clone(), cap_w=z.clone(),
                       base_cap_w=torch.tensor(base_cap_w,
                                               dtype=torch.float32))


def cap_events(
    starts: Sequence[float],
    ends: Sequence[float],
    caps_w: Sequence[float],
    base_cap_w: float = 0.0,
    *,
    n_events: int | None = None,
) -> CapSchedule:
    """Build a schedule from parallel event lists, padded to ``n_events``."""
    s = np.asarray(starts, np.float32).reshape(-1)
    e = np.asarray(ends, np.float32).reshape(-1)
    c = np.asarray(caps_w, np.float32).reshape(-1)
    if not (s.shape == e.shape == c.shape):
        raise ValueError("starts/ends/caps_w must have equal lengths")
    if np.any(e < s):
        raise ValueError("event end_t before start_t")
    n = max(n_events or s.size, s.size, 1)
    pad = n - s.size
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.float32)])
        e = np.concatenate([e, np.zeros(pad, np.float32)])
        c = np.concatenate([c, np.zeros(pad, np.float32)])
    return CapSchedule(start_t=torch.from_numpy(s), end_t=torch.from_numpy(e),
                       cap_w=torch.from_numpy(c),
                       base_cap_w=torch.tensor(base_cap_w,
                                               dtype=torch.float32))


def next_cap_event(sched: CapSchedule, t: torch.Tensor) -> torch.Tensor:
    """Earliest cap-schedule breakpoint strictly after ``t`` (``inf`` when
    none): an event window opening or closing. The standing base cap has
    no breakpoints and padding slots (``cap_w == 0``) never produce one.
    A batched schedule ((E, n) events) takes ``t`` (E,) and gives (E,)."""
    edges = torch.cat([sched.start_t, sched.end_t], -1)
    live = torch.cat([sched.cap_w > 0.0, sched.cap_w > 0.0], -1)
    edges = torch.where(live & (edges > t[..., None]), edges, _INF)
    return torch.amin(edges, -1)


def power_cap_at(sched: CapSchedule, t: torch.Tensor) -> torch.Tensor:
    """Effective facility cap [W] at time t; 0.0 when uncapped. A batched
    schedule ((E, n) events, (E,) base caps) takes ``t`` (E,) and gives
    (E,)."""
    tt = t[..., None]
    active = (tt >= sched.start_t) & (tt < sched.end_t) & (sched.cap_w > 0.0)
    event_cap = torch.amin(torch.where(active, sched.cap_w, _INF), -1)
    base = torch.where(sched.base_cap_w > 0.0, sched.base_cap_w, _INF)
    cap = torch.minimum(event_cap, base)
    return torch.where(torch.isfinite(cap), cap, 0.0)
