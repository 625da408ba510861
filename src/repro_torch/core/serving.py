"""The serving twin: a fluid request-mass model of online inference.

A pool of ``cfg.serving_nodes`` inference nodes, disjoint from the batch
fleet, serves requests as continuous MASS (a deterministic fluid
approximation of an M/G/c queue) driven by ``Scenario.traffic`` (a
request rate [req/s]) times the flash-crowd windows of
``Scenario.bursts``. Its power joins the plant chain before the DVFS cap.

Two code paths, split as the fault engine's are:

- the continuous flow (``serving_flow``: arrivals, completions at the
  throttled service rate, admission into freed concurrency, the fluid
  latency estimate and the SLO ledger) and the pool's power
  (``serving_power``) run in the step's accounting tail every tick, so
  macro fast ticks reproduce them;
- the discrete overload ladder (``apply_serving``: autoscale wake and
  sleep, retry re-injection, then hard shedding and the
  admission/timeout bounce into capped exponential-backoff retries, with
  terminal drops past the retry budget) runs on full ticks only, and is
  a bitwise fixpoint on a tick where nothing is due.

For macro-stepping, the wake clock, the retry clocks and the burst
edges are exact time breakpoints (``next_serving_event``); a queue
crossing an overload threshold is caught on each committed fast tick
(``serving_trigger``), and ``serving_crossing_horizon`` bounds a
segment by the worst-case arrival rate. Nothing here draws from the
PRNG.

Every function takes one state or a fleet's: the per-replica scalars are
(E,) and ``srv_queue``, ``srv_retry_q`` and ``srv_retry_t`` are (E, B+1),
with every sum over the last axis. Nothing reads a tensor on the host.

Rounding follows XLA's CPU code for the JAX package, so that the floors
and comparisons below (the latency bucket, the SLO test, the clocks)
fall on the same side: a division by a config constant is a product
with the constant's f32 reciprocal and a product of two config constants
is folded into one f32 constant, as XLA's compiler rewrites them; a
division by a tensor is a true division, its divisor a tensor on the
state's device (on the card PyTorch divides by a Python scalar through
its reciprocal). The latency bucket, ``floor(log2(ratio)) + 4`` in the
JAX package, is read off seven f32 thresholds (``BUCKET_EDGES``) instead
of a ``log2``, so it equals XLA's CPU bucket on every f32 input on any
device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.sim import SimConfig
from repro_torch.core.state import SimState, Statics
from repro_torch.scenarios.events import burst_mult_at, next_burst_event
from repro_torch.scenarios.signals import eval_signal, signal_bounds
from repro_torch.utils.device import to_device

_INF = float("inf")
_F32 = np.float32

# The f32 bit patterns of the smallest ratios XLA's CPU
# ``clip(floor(log2(max(ratio, 1e-9))) + 4, 0, 7)`` puts in buckets 1..7:
# 2**-3 .. 2**3 as its ``log2`` places them (two ulps under 0.125, one
# under 0.25 and 8.0). Found exhaustively over [2**-4, 2**4]
# (``tests/test_torch_serving.py`` checks every f32 there); the bucket is
# monotone, 0 below the first edge and 7 from the last. Off the f32 range
# XLA's int cast of the floor puts +inf in bucket 0 and NaN in bucket 4,
# and so does ``latency_bucket``.
BUCKET_EDGE_BITS = (1040187390, 1048575999, 1056964608, 1065353216,
                    1073741824, 1082130432, 1090519039)
BUCKET_EDGES = np.array(BUCKET_EDGE_BITS, np.int32).view(np.float32)
N_BUCKETS = len(BUCKET_EDGES) + 1


def _recip(x: float) -> float:
    """The f32 reciprocal of the f32 value of ``x``, as XLA folds a
    division by a constant."""
    return float(_F32(1.0) / _F32(x))


def _prod(*xs: float) -> float:
    """The f32 product of the f32 values of ``xs``, left to right, as
    XLA folds a chain of constant factors."""
    out = _F32(xs[0])
    for x in xs[1:]:
        out = _F32(out * _F32(x))
    return float(out)


def retry_backoff(cfg: SimConfig, attempt) -> torch.Tensor:
    """Backoff [s] before a request's ``attempt``-th try (attempt >= 1):
    ``base * mult**(attempt-1)``, capped at ``serving_backoff_cap_s``;
    f32 on the CPU (an int, a sequence or a tensor of attempts)."""
    a = torch.clamp(torch.as_tensor(attempt, dtype=torch.float32) - 1.0,
                    min=0.0)
    b = float(_F32(cfg.serving_backoff_s)) * torch.pow(
        torch.tensor(float(_F32(cfg.serving_backoff_mult))), a)
    return torch.clamp(b, max=float(_F32(cfg.serving_backoff_cap_s)))


class ServingConsts(NamedTuple):
    """A config's device constants, made once per (config, device) by
    asynchronous copies (no sync inside a tick)."""

    backoff: torch.Tensor   # (B+1,) each retry tier's backoff [s]
    svc: torch.Tensor       # 0-d service time [s], a tensor dividend


@functools.lru_cache(maxsize=64)
def serving_consts(cfg: SimConfig, device: torch.device) -> ServingConsts:
    B1 = cfg.serving_max_retries + 1
    return ServingConsts(
        backoff=to_device(retry_backoff(cfg, torch.arange(B1)), device),
        svc=torch.full((), max(cfg.serving_service_s, 1e-9),
                       dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=8)
def _bucket_consts(device: torch.device):
    """(edges (7,) f32, bucket ids (8,)) on ``device``."""
    return (to_device(torch.from_numpy(BUCKET_EDGES.copy()), device),
            torch.arange(N_BUCKETS, device=device))


def _allowed_queue(cfg: SimConfig, active: torch.Tensor,
                   admit_thresh: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """(allowed, q_cap): the admission-control bound (the schedulable
    threshold, tightened by the queue mass the pool can start within
    ``serving_timeout_s`` at full clock) and the hard-shed bound.
    ``serving_trigger`` reads the same expressions."""
    q_cap = float(_F32(cfg.serving_queue_cap))
    allowed = admit_thresh * q_cap
    if cfg.serving_timeout_s > 0:
        svc = max(cfg.serving_service_s, 1e-9)
        # active * (conc / svc) * (timeout - svc), the two constants
        # folded into one
        reach = active * _prod(cfg.serving_concurrency / svc,
                               max(cfg.serving_timeout_s - svc, 0.0))
        allowed = torch.minimum(allowed, reach)
    return allowed, q_cap


def apply_serving(cfg: SimConfig, state: SimState, statics: Statics
                  ) -> Tuple[SimState, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One discrete serving sweep (full ticks only): autoscale wake
    completion and target reconciliation, retry re-injection, then the
    shed / timeout / admission cascade. Returns ``(state, shed_now,
    dropped_now, retried_now)`` in request mass, one each per replica.

    On a tick where no wake or retry clock is due and the queue is under
    every threshold the update is a bitwise fixpoint (adds of 0.0,
    products with 1.0, untaken wheres), and every clock it leaves is
    strictly future or +inf."""
    k = serving_consts(cfg, state.t.device)
    t = state.t

    # --- autoscale: wake completion, then the target. Scale-down is
    # instant (drain) and cancels a wake in flight; a new wake batch
    # starts only when none is in flight
    woke = t >= state.srv_wake_t
    active = torch.where(woke, state.srv_active + state.srv_wake_n,
                         state.srv_active)
    wake_n = torch.where(woke, 0.0, state.srv_wake_n)
    wake_t = torch.where(woke, _INF, state.srv_wake_t)
    target = torch.clamp(state.srv_target, 0.0, float(cfg.serving_nodes))
    down = target < active
    wake_n = torch.where(down, 0.0, wake_n)
    wake_t = torch.where(down, _INF, wake_t)
    active = torch.where(down, target, active)
    deficit = torch.clamp(target - active - wake_n, min=0.0)
    start = (deficit > 0.0) & (wake_n <= 0.0)
    wake_n = torch.where(start, deficit, wake_n)
    wake_t = torch.where(start, t + float(_F32(cfg.serving_wake_s)), wake_t)

    # --- retry re-injection: due buckets pour back into their tier
    tt = t[..., None]
    due = tt >= state.srv_retry_t
    queue = state.srv_queue + torch.where(due, state.srv_retry_q, 0.0)
    retry_q = torch.where(due, 0.0, state.srv_retry_q)
    retry_t = torch.where(due, _INF, state.srv_retry_t)

    # --- hard shed first (the queue bound is absolute), then the
    # admission/timeout bounce. Mass leaves every tier in proportion;
    # tier r bounces into retry bucket r+1 and the top tier drops
    q_tot = torch.sum(queue, -1)
    allowed, q_cap = _allowed_queue(cfg, active, state.srv_admit_thresh)
    shed_now = torch.clamp(q_tot - q_cap, min=0.0)
    queue = queue * (1.0 - shed_now / torch.clamp(q_tot, min=1e-9))[..., None]
    q_kept = q_tot - shed_now
    bounce = torch.clamp(q_kept - allowed, min=0.0)
    bfrac = (bounce / torch.clamp(q_kept, min=1e-9))[..., None]
    moved = queue * bfrac
    queue = queue * (1.0 - bfrac)
    inc = F.pad(moved[..., :-1], (1, 0))
    dropped_now = moved[..., -1]
    retried_now = torch.sum(moved[..., :-1], -1)
    got = inc > 0.0
    retry_t = torch.where(got, torch.minimum(retry_t, tt + k.backoff),
                          retry_t)
    retry_q = retry_q + inc

    state = state._replace(
        srv_queue=queue, srv_retry_q=retry_q, srv_retry_t=retry_t,
        srv_active=active, srv_wake_n=wake_n, srv_wake_t=wake_t,
        srv_target=target,
        srv_shed=state.srv_shed + shed_now,
        srv_dropped=state.srv_dropped + dropped_now,
        srv_retried=state.srv_retried + retried_now,
    )
    return state, shed_now, dropped_now, retried_now


def serving_power(cfg: SimConfig, state: SimState, cop: torch.Tensor):
    """(it_w, input_w, cooling_w, idle_w) of the pool this tick, one each
    per replica: awake and waking nodes burn idle power at any clock (it
    joins the DVFS cap's unthrottleable floor), asleep ones the sleep
    wattage, and dynamic power blends the prefill/decode utilisation and
    scales with the in-flight occupancy."""
    conc = float(_F32(cfg.serving_concurrency))
    cap_conc = state.srv_active * conc
    occ = torch.clamp(state.srv_inflight / torch.clamp(cap_conc, min=1e-9),
                      0.0, 1.0)
    phase_util = (cfg.serving_prefill_frac * cfg.serving_prefill_util
                  + (1.0 - cfg.serving_prefill_frac)
                  * cfg.serving_decode_util)
    asleep = torch.clamp(
        float(cfg.serving_nodes) - state.srv_active - state.srv_wake_n,
        min=0.0)
    idle_w = ((state.srv_active + state.srv_wake_n)
              * float(_F32(cfg.serving_node_idle_w))
              + asleep * float(_F32(cfg.serving_sleep_w)))
    dyn_w = (state.srv_active * _prod(cfg.serving_node_dyn_w, phase_util)
             * occ)
    it_w = idle_w + dyn_w
    input_w = it_w * _recip(cfg.rect_eff_peak * cfg.conv_eff)
    cooling_w = input_w / cop
    return it_w, input_w, cooling_w, idle_w


def latency_bucket(ratio: torch.Tensor) -> torch.Tensor:
    """The log-2 latency bucket of ``ratio`` (latency over the SLO), int64
    in [0, 8): bucket i spans [2**(i-4), 2**(i-3)) with the ends open, at
    XLA's CPU edges (``BUCKET_EDGES``)."""
    edges, _ = _bucket_consts(ratio.device)
    r = ratio[..., None]
    idx = torch.sum((r >= edges) & (r != _INF), -1)
    return torch.where(torch.isnan(ratio), 4, idx)


def serving_flow(cfg: SimConfig, state: SimState, statics: Statics,
                 throttle: torch.Tensor):
    """One tick of the continuous request-mass flow (every tick, in the
    accounting tail): arrivals from the traffic signal times the burst
    multiplier into attempt tier 0, completions out of the in-flight mass
    at the ``throttle``-scaled service rate, admission of queued mass
    into freed concurrency, and the fluid latency estimate feeding the
    SLO ledger. Returns ``(state, arrive, comp, viol, w_est, q_after,
    hist_step)``, each per replica (``hist_step`` (..., 8))."""
    k = serving_consts(cfg, state.t.device)
    scn = statics.scenario
    lam = (torch.clamp(eval_signal(scn.traffic, state.t), min=0.0)
           * burst_mult_at(scn.bursts, state.t))
    arrive = lam * float(_F32(cfg.dt))
    svc = max(cfg.serving_service_s, 1e-9)
    cap_conc = state.srv_active * float(_F32(cfg.serving_concurrency))
    # throttle * dt / svc, the constants folded into one factor
    comp = state.srv_inflight * torch.clamp(
        throttle * _prod(cfg.dt, _recip(svc)), 0.0, 1.0)
    inflight = state.srv_inflight - comp
    queue = state.srv_queue + F.pad(arrive[..., None],
                                    (0, state.srv_queue.shape[-1] - 1))
    q_tot = torch.sum(queue, -1)
    room = torch.clamp(cap_conc - inflight, min=0.0)
    admit = torch.minimum(q_tot, room)
    queue = queue * (1.0 - admit / torch.clamp(q_tot, min=1e-9))[..., None]
    inflight = inflight + admit
    q_after = q_tot - admit
    # fluid sojourn estimate of the mass completing this tick: the
    # residual queue wait at the throttled full-pool service rate plus
    # the (clock-stretched) service time itself
    serve_rate = cap_conc * throttle * _recip(svc)
    w_est = (q_after / torch.clamp(serve_rate, min=1e-9)
             + k.svc / torch.clamp(throttle, min=1e-9))
    viol = comp * (w_est > float(_F32(cfg.serving_slo_s))).to(torch.float32)
    # log-2 latency histogram around the SLO (``summary_columns`` reads
    # its quantiles at the bucket edges in SLO units); the one-hot
    # product is exact: comp * 1 + 0
    ratio = w_est * _recip(max(cfg.serving_slo_s, 1e-9))
    _, ids = _bucket_consts(ratio.device)
    hist_step = torch.where(latency_bucket(ratio)[..., None] == ids,
                            comp[..., None], 0.0)
    state = state._replace(
        srv_queue=queue,
        srv_inflight=inflight,
        srv_arrived=state.srv_arrived + arrive,
        srv_completed=state.srv_completed + comp,
        srv_slo_viol=state.srv_slo_viol + viol,
        srv_lat_sum=state.srv_lat_sum + comp * w_est,
        srv_lat_hist=state.srv_lat_hist + hist_step,
    )
    return state, arrive, comp, viol, w_est, q_after, hist_step


def serving_trigger(cfg: SimConfig, state: SimState) -> torch.Tensor:
    """Would the next full tick's ``apply_serving`` cascade move mass?
    (one bool per replica): queue mass strictly above the admission,
    timeout or shed bound. Read on committed state after each macro fast
    tick; it mirrors ``_allowed_queue``, so it misses no crossing (a
    false positive only ends a segment early)."""
    allowed, q_cap = _allowed_queue(cfg, state.srv_active,
                                    state.srv_admit_thresh)
    return torch.sum(state.srv_queue, -1) > torch.clamp(allowed, max=q_cap)


def next_serving_event(cfg: SimConfig, state: SimState, statics: Statics,
                       t: torch.Tensor) -> torch.Tensor:
    """Earliest serving time breakpoint strictly after ``t`` (``inf`` when
    none), one per replica: the wake completion, a pending retry
    re-injection or a burst-window edge."""
    nxt = torch.where(state.srv_wake_t > t, state.srv_wake_t, _INF)
    nxt = torch.minimum(nxt, torch.amin(torch.where(
        state.srv_retry_t > t[..., None], state.srv_retry_t, _INF), -1))
    return torch.minimum(nxt, next_burst_event(statics.scenario.bursts, t))


def serving_crossing_horizon(cfg: SimConfig, state: SimState,
                             statics: Statics, max_ticks: int
                             ) -> torch.Tensor:
    """Ticks (int32, one per replica) within which arrivals cannot push
    the queue across the nearest overload threshold: the headroom over
    the worst-case arrivals of a tick (the traffic signal's envelope
    times the burst multiplier in force; burst edges are breakpoints),
    less one tick of float margin."""
    scn = statics.scenario
    _, hi = signal_bounds(scn.traffic)
    lam_hi = torch.clamp(hi, min=0.0) * burst_mult_at(scn.bursts, state.t)
    allowed, q_cap = _allowed_queue(cfg, state.srv_active,
                                    state.srv_admit_thresh)
    headroom = torch.clamp(torch.clamp(allowed, max=q_cap)
                           - torch.sum(state.srv_queue, -1), min=0.0)
    per_tick = lam_hi * float(_F32(cfg.dt))
    kf = float(max_ticks)
    ticks = torch.where(
        per_tick > 0.0,
        torch.floor(headroom / torch.clamp(per_tick, min=1e-9)) - 1.0, kf)
    return torch.clamp(ticks, 0.0, kf).to(torch.int32)
