"""The machine-invariant harness: the JAX package's checkify suite
(``repro/utils/invariants.py``) as explicit torch checks.

``check_state(cfg, statics, state)`` tests the conservation laws and
sanity bounds every subsystem of the twin keeps — resource conservation,
placement/jstate consistency, the jstate range, boolean ``node_up``,
finite accumulators and ``work_left``, bounded rack temperatures,
non-negative resilience accounting and, with the serving twin on, the
serving ledger's conservation and retry budget — each with the JAX
package's message. Every check broadcasts over a leading replica axis, so
one suite audits an episode's state and a fleet's. Two modes, as with
checkify:

- **eager**: ``check_state`` reads the results to the host (one counted
  read, ``utils.device.drain``) and raises ``InvariantError`` naming the
  first broken check (``core.fleet.run_fleet`` audits its final states
  so);
- **inside an episode**: ``EpisodeMonitor`` runs the checks after every
  committed tick (a macro step's, under the macro engine) and ORs each
  into a device-side record of the first tick it failed, with no sync;
  ``throw()`` reads the record once at the end of the episode or segment
  and raises naming the check and that tick — ``checkify.checkify(go)``
  followed by ``err.throw()``.

The harness is gated by ``REPRO_CHECKIFY``, read when ``enabled()`` is
called: unset or ``0``, the episode runs no check, no launch and no read.
"""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

import torch

from repro_torch.core.state import FAILED, RUNNING
from repro_torch.utils.device import drain
from repro_torch.utils.errors import InvariantError

# float slop for resource conservation: free pools are add/subtract
# chains of f32 req vectors, so allow a few ulps of drift per resource
_EPS = 1e-3
_NEVER = 2 ** 62


def enabled() -> bool:
    """Whether the harness is on (``REPRO_CHECKIFY``); read at call time."""
    return os.environ.get("REPRO_CHECKIFY", "0") not in ("", "0")


def _holds(x: torch.Tensor, lead: int) -> torch.Tensor:
    """``x`` reduced with ``all`` over every axis after the ``lead``
    replica axes: one bool per replica."""
    return x.reshape(tuple(x.shape[:lead]) + (-1,)).all(-1)


def _checks(cfg) -> List[Tuple[str, Callable]]:
    """(message, holds(statics, state, lead)) of every check, in the JAX
    package's order."""
    checks = [
        ("resource conservation violated: free pool exceeds capacity "
         "(double release)",
         lambda g, s, k: _holds(s.free <= g.capacity + _EPS, k)),
        ("resource conservation violated: negative free pool "
         "(oversubscription)",
         lambda g, s, k: _holds(s.free >= -_EPS, k)),
        ("placement/jstate inconsistency: a non-RUNNING job holds nodes "
         "or a RUNNING job holds none",
         lambda g, s, k: _holds(torch.any(s.placement >= 0, -1)
                                == (s.jstate == RUNNING), k)),
        ("jstate outside the EMPTY..FAILED lifecycle",
         lambda g, s, k: _holds((s.jstate >= 0) & (s.jstate <= FAILED), k)),
        ("node_up not boolean-valued (0.0 or 1.0)",
         lambda g, s, k: _holds((s.node_up == 0.0) | (s.node_up == 1.0), k)),
        ("NaN/Inf in power/energy/lost-work accumulators",
         lambda g, s, k: _holds(torch.stack([torch.isfinite(a) for a in (
             s.energy_kwh, s.it_energy_kwh, s.cool_energy_kwh, s.carbon_kg,
             s.elec_cost_usd, s.sum_power_w, s.lost_node_s)], -1), k)),
        ("NaN/Inf in per-job work_left",
         lambda g, s, k: _holds(torch.isfinite(s.work_left), k)),
        ("rack outlet temperature NaN/Inf or outside (-60, 250) degC",
         lambda g, s, k: _holds(torch.isfinite(s.rack_outlet_c)
                                & (s.rack_outlet_c < 250.0)
                                & (s.rack_outlet_c > -60.0), k)),
        ("negative resilience accounting (lost_node_s/n_failed/n_killed)",
         lambda g, s, k: _holds(torch.stack([
             s.lost_node_s >= 0.0, s.n_failed >= 0.0, s.n_killed >= 0.0],
             -1), k)),
        ("negative per-job failure count",
         lambda g, s, k: _holds(s.n_failures >= 0, k)),
    ]
    if not cfg.serving_on:
        return checks

    def ledger(s):
        return (s.srv_arrived, s.srv_completed, s.srv_shed, s.srv_dropped,
                s.srv_retried, s.srv_slo_viol, s.srv_lat_sum)

    def tol(s):
        return 1e-3 * s.srv_arrived + 1e-2

    def held(s):
        return (torch.sum(s.srv_queue, -1) + torch.sum(s.srv_retry_q, -1)
                + s.srv_inflight)

    return checks + [
        ("negative serving queue depth (srv_queue/srv_retry_q/"
         "srv_inflight)",
         lambda g, s, k: _holds(s.srv_queue >= -_EPS, k)
         & _holds(s.srv_retry_q >= -_EPS, k)
         & _holds(s.srv_inflight >= -_EPS, k)),
        ("NaN/Inf in serving SLO accumulators",
         lambda g, s, k: _holds(torch.stack(
             [torch.isfinite(a) for a in ledger(s)], -1), k)),
        ("negative serving SLO accumulator",
         lambda g, s, k: _holds(torch.stack(
             [a >= 0.0 for a in ledger(s)], -1), k)),
        ("serving in-flight + completed exceeds arrivals (admission leak)",
         lambda g, s, k: _holds(s.srv_inflight + s.srv_completed
                                <= s.srv_arrived + tol(s), k)),
        ("serving request conservation violated: arrived != held + "
         "completed + shed + dropped",
         lambda g, s, k: _holds(torch.abs(
             s.srv_arrived - (held(s) + s.srv_completed + s.srv_shed
                              + s.srv_dropped)) <= tol(s), k)),
        ("serving retries exceed the per-request retry budget",
         lambda g, s, k: _holds(
             s.srv_retried <= cfg.serving_max_retries * s.srv_arrived
             + tol(s), k)),
    ]


def _table(cfg, statics, state) -> Tuple[List[str], torch.Tensor]:
    """(messages, (n checks, *replica axes) bool: where each holds)."""
    lead = state.t.dim()
    checks = _checks(cfg)
    return ([m for m, _ in checks],
            torch.stack([fn(statics, state, lead) for _, fn in checks]))


def check_state(cfg, statics, state) -> None:
    """Check one (possibly replica-batched) ``SimState`` now: one counted
    read, and ``InvariantError`` naming the first broken check (and, for
    a batch, the replicas that break it)."""
    messages, ok = _table(cfg, statics, state)
    ok = drain(ok)
    for i, msg in enumerate(messages):
        if not bool(ok[i].all()):
            where = ""
            if ok.dim() > 1:
                bad = torch.nonzero(~ok[i]).flatten().tolist()
                where = f" (replicas {bad})"
            raise InvariantError(msg + where, check=msg)


class EpisodeMonitor:
    """The checks of every committed tick of one episode or segment,
    recorded on the device: call it with each committed state, then
    ``throw()`` once at the end (one counted read)."""

    def __init__(self, cfg, statics, state):
        self.cfg, self.statics = cfg, statics
        self.messages = [m for m, _ in _checks(cfg)]
        self.t0 = state.t.clone()
        self.first = torch.full((len(self.messages),), _NEVER,
                                dtype=torch.int64, device=state.t.device)

    def __call__(self, state) -> None:
        _, ok = _table(self.cfg, self.statics, state)
        # the tick just committed, counted from 0 at the run's start
        tick = torch.round((state.t - self.t0) / self.cfg.dt).to(
            torch.int64) - 1
        at = torch.where(ok, _NEVER, tick)
        self.first = torch.minimum(
            self.first, at.reshape(len(self.messages), -1).amin(-1))

    def throw(self) -> None:
        first = drain(self.first)
        tick = int(first.min())
        if tick >= _NEVER:
            return
        i = int(torch.nonzero(first == tick)[0, 0])
        msg = self.messages[i]
        raise InvariantError(
            f"{msg} — first broken after tick {tick} of the run",
            check=msg, tick=tick)


__all__ = ["enabled", "check_state", "EpisodeMonitor"]
