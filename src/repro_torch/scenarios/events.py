"""Scheduled grid events: demand-response power caps and outage windows.

A ``CapSchedule`` holds up to n events, each ``[start_t, end_t)`` with a
facility-power cap in watts, plus a standing base cap. ``power_cap_at``
returns the effective cap at time t (the tightest of base + active events),
with 0.0 meaning "uncapped" — the ``cfg.power_cap_w`` convention consumed
by the DVFS throttle in ``core/sim.py``.

An ``OutageSchedule`` holds up to n grid brownout / maintenance windows
for the fault engine (``core.faults``): each forces a degradation-ladder
level and/or takes one rack down while it is active.

Fixed shape (n is padded, inactive slots have cap 0, or level 0 and rack
-1); a batched schedule carries a leading replica axis on every leaf and
takes ``t`` with the same leading axis.

A ``BurstSchedule`` holds up to n flash-crowd windows for the serving
twin (``core.serving``): each multiplies the scenario's request-rate
signal while it is active.
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


class OutageSchedule(NamedTuple):
    """Grid brownout / outage and maintenance windows ``[start_t, end_t)``.

    Each carries a forced degradation-ladder level (``core.faults``: 0
    none, 1 throttle, 2 dispatch-gate, 3 drain, 4 checkpoint-evict) and
    optionally a rack to take down outright (-1 = no rack). A slot with
    ``force_level == 0`` and ``down_rack == -1`` is padding. Window edges
    are exact macro breakpoints (``next_outage_event``)."""

    start_t: torch.Tensor      # (n,) window start [s]
    end_t: torch.Tensor        # (n,) window end [s] (exclusive)
    force_level: torch.Tensor  # (n,) int32 forced ladder level; 0 = none
    down_rack: torch.Tensor    # (n,) int32 rack taken down; -1 = none


def no_outages(n_events: int = 1) -> OutageSchedule:
    """Schedule with no outage or maintenance windows (all padding)."""
    n = max(n_events, 1)
    z = torch.zeros((n,), dtype=torch.float32)
    return OutageSchedule(start_t=z, end_t=z.clone(),
                          force_level=torch.zeros((n,), dtype=torch.int32),
                          down_rack=torch.full((n,), -1, dtype=torch.int32))


def outage_events(
    starts: Sequence[float],
    ends: Sequence[float],
    *,
    levels: Sequence[int] | None = None,
    down_racks: Sequence[int] | None = None,
    n_events: int | None = None,
) -> OutageSchedule:
    """Build an outage schedule from parallel window lists, padded to
    ``n_events``. ``levels`` defaults to 0 (no forced ladder level) and
    ``down_racks`` to -1 (no rack outage): a window with neither is
    padding."""
    s = np.asarray(starts, np.float32).reshape(-1)
    e = np.asarray(ends, np.float32).reshape(-1)
    lv = (np.zeros_like(s, np.int32) if levels is None
          else np.asarray(levels, np.int32).reshape(-1))
    dr = (np.full_like(lv, -1) if down_racks is None
          else np.asarray(down_racks, np.int32).reshape(-1))
    if not (s.shape == e.shape == lv.shape == dr.shape):
        raise ValueError("starts/ends/levels/down_racks lengths differ")
    if np.any(e < s):
        raise ValueError("outage end_t before start_t")
    if np.any((lv < 0) | (lv > 4)):
        raise ValueError("force_level must be in [0, 4]")
    n = max(n_events or s.size, s.size, 1)
    pad = n - s.size
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.float32)])
        e = np.concatenate([e, np.zeros(pad, np.float32)])
        lv = np.concatenate([lv, np.zeros(pad, np.int32)])
        dr = np.concatenate([dr, np.full(pad, -1, np.int32)])
    return OutageSchedule(start_t=torch.from_numpy(s),
                          end_t=torch.from_numpy(e),
                          force_level=torch.from_numpy(lv),
                          down_rack=torch.from_numpy(dr))


def _outage_live(sched: OutageSchedule) -> torch.Tensor:
    return (sched.force_level > 0) | (sched.down_rack >= 0)


def next_outage_event(sched: OutageSchedule, t: torch.Tensor) -> torch.Tensor:
    """Earliest outage-window edge strictly after ``t`` (``inf`` when
    none): the same breakpoint contract as ``next_cap_event``."""
    live = _outage_live(sched)
    edges = torch.cat([sched.start_t, sched.end_t], -1)
    live2 = torch.cat([live, live], -1)
    edges = torch.where(live2 & (edges > t[..., None]), edges, _INF)
    return torch.amin(edges, -1)


def _outage_active(sched: OutageSchedule, t: torch.Tensor) -> torch.Tensor:
    tt = t[..., None]
    return (tt >= sched.start_t) & (tt < sched.end_t)


def outage_level_at(sched: OutageSchedule, t: torch.Tensor) -> torch.Tensor:
    """Highest forced degradation-ladder level among the windows active
    at ``t`` (int32, one per replica; 0 when none)."""
    active = _outage_active(sched, t) & _outage_live(sched)
    return torch.amax(torch.where(active, sched.force_level, 0),
                      -1).to(torch.int32)


def outage_down(sched: OutageSchedule, t: torch.Tensor,
                node_rack: torch.Tensor):
    """Per-node maintenance outage at ``t``: ``(forced, until)``, (..., N)
    each: the nodes whose rack an active window takes down, and the latest
    ``end_t`` among the windows downing each node (0 where not forced),
    the deterministic repair time of maintenance faults."""
    active = _outage_active(sched, t) & (sched.down_rack >= 0)   # (..., n)
    # (..., N, n): window e downs node i
    hit = active[..., None, :] & (node_rack[:, None].to(sched.down_rack.dtype)
                                  == sched.down_rack[..., None, :])
    forced = torch.any(hit, -1)
    until = torch.amax(torch.where(hit, sched.end_t[..., None, :], 0.0), -1)
    return forced, until


class BurstSchedule(NamedTuple):
    """Traffic-burst (flash-crowd) windows ``[start_t, end_t)`` of the
    serving twin: each scales the ``Scenario.traffic`` request rate by
    ``mult`` while active (the largest multiplier wins where windows
    overlap; 1.0 outside every window). A slot with ``mult <= 0`` is
    padding. Window edges are exact macro breakpoints
    (``next_burst_event``)."""

    start_t: torch.Tensor  # (n,) window start [s]
    end_t: torch.Tensor    # (n,) window end [s] (exclusive)
    mult: torch.Tensor     # (n,) traffic multiplier; <= 0 = padding


def no_bursts(n_events: int = 1) -> BurstSchedule:
    """Schedule with no burst windows (all padding)."""
    n = max(n_events, 1)
    z = torch.zeros((n,), dtype=torch.float32)
    return BurstSchedule(start_t=z, end_t=z.clone(), mult=z.clone())


def burst_events(
    starts: Sequence[float],
    ends: Sequence[float],
    mults: Sequence[float],
    *,
    n_events: int | None = None,
) -> BurstSchedule:
    """Build a burst schedule from parallel window lists, padded to
    ``n_events``. Multipliers must be positive (below 1 for planned
    traffic dips, above 1 for flash crowds)."""
    s = np.asarray(starts, np.float32).reshape(-1)
    e = np.asarray(ends, np.float32).reshape(-1)
    m = np.asarray(mults, np.float32).reshape(-1)
    if not (s.shape == e.shape == m.shape):
        raise ValueError("starts/ends/mults must have equal lengths")
    if np.any(e < s):
        raise ValueError("burst end_t before start_t")
    if np.any(m <= 0.0):
        raise ValueError("burst mult must be positive")
    n = max(n_events or s.size, s.size, 1)
    pad = n - s.size
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.float32)])
        e = np.concatenate([e, np.zeros(pad, np.float32)])
        m = np.concatenate([m, np.zeros(pad, np.float32)])
    return BurstSchedule(start_t=torch.from_numpy(s),
                         end_t=torch.from_numpy(e), mult=torch.from_numpy(m))


def next_burst_event(sched: BurstSchedule, t: torch.Tensor) -> torch.Tensor:
    """Earliest burst-window edge strictly after ``t`` (``inf`` when
    none), one per replica: the same breakpoint contract as
    ``next_cap_event``."""
    live = sched.mult > 0.0
    edges = torch.cat([sched.start_t, sched.end_t], -1)
    live2 = torch.cat([live, live], -1)
    edges = torch.where(live2 & (edges > t[..., None]), edges, _INF)
    return torch.amin(edges, -1)


def burst_mult_at(sched: BurstSchedule, t: torch.Tensor) -> torch.Tensor:
    """Traffic multiplier at ``t``, one per replica: the largest among the
    active windows, 1.0 when none is active."""
    tt = t[..., None]
    active = (tt >= sched.start_t) & (tt < sched.end_t) & (sched.mult > 0.0)
    peak = torch.amax(torch.where(active, sched.mult, 0.0), -1)
    return torch.where(torch.any(active, -1), peak, 1.0)
