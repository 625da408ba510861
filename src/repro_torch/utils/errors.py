"""Typed error taxonomy for the simulator's operational layer.

Every loud failure in the ingestion / checkpoint / entry-point surface
raises one of these instead of a bare ``ValueError``/``KeyError``, so
callers (chaos harness, launch scripts, CI gates) can discriminate
*what* went wrong without string-matching messages:

    ReproError                      root of the taxonomy
    ├── ConfigError                 bad arguments to sim/fleet/env/rl
    │                               entry points (user-facing API misuse)
    ├── TraceValidationError        corrupt SuperCloud trace / jobs dict
    ├── SignalValidationError       corrupt grid-signal CSV feed
    ├── CheckpointError             missing/corrupt/mismatched checkpoint
    └── InvariantError              a machine invariant broken in a state
                                    (``utils.invariants``, REPRO_CHECKIFY)

Each concrete class ALSO inherits ``ValueError`` so the long tail of
existing ``pytest.raises(ValueError)`` pins and user ``except
ValueError`` handlers keep working — the taxonomy is additive, never a
behavioural break.

Validation errors carry the machine-readable report that produced them
(``err.report``, an ``IngestionReport`` from :mod:`repro_torch.data.validate`)
so strict-mode failures are as inspectable as repair-mode returns.
"""

from __future__ import annotations


class ReproError(Exception):
    """Root of the repro error taxonomy."""


class ConfigError(ReproError, ValueError):
    """Invalid arguments to a sim/fleet/env/rl entry point."""


class _ValidationError(ReproError, ValueError):
    """Shared base for ingestion errors; carries the offending report."""

    def __init__(self, message: str, *, report=None):
        super().__init__(message)
        self.report = report


class TraceValidationError(_ValidationError):
    """A SuperCloud trace CSV or jobs dict failed structural validation."""


class SignalValidationError(_ValidationError):
    """A grid-signal CSV feed failed structural validation."""


class CheckpointError(ReproError, ValueError):
    """A checkpoint is missing, corrupt, or belongs to a different run.

    ``field`` names the manifest entry (or filesystem artifact) that
    failed, so resume tooling can report *which* part of the fingerprint
    diverged rather than a generic "checkpoint bad".
    """

    def __init__(self, message: str, *, field: str | None = None):
        super().__init__(message)
        self.field = field


class InvariantError(ReproError, RuntimeError):
    """A state breaks a machine invariant (``utils.invariants``).

    ``check`` is the broken check's message; ``tick`` the first tick of
    the episode or segment after which it failed (0 is the first tick
    run), or ``None`` for a state checked on its own.
    """

    def __init__(self, message: str, *, check: str, tick: int | None = None):
        super().__init__(message)
        self.check = check
        self.tick = tick


__all__ = [
    "ReproError",
    "ConfigError",
    "TraceValidationError",
    "SignalValidationError",
    "CheckpointError",
    "InvariantError",
]
