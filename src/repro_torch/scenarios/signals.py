"""Time-series grid signals on tensors.

A ``Signal`` is a fixed-shape NamedTuple of tensors that evaluates to a
0-d f32 tensor at any sim time ``t``; a batched one (a leading replica
axis E on every leaf, ``values`` (E, T)) evaluates to (E,) at ``t`` (E,). Two families share one
representation: parametric (sinusoid plus a deterministic multi-harmonic
"weather noise" term) and trace (samples linearly interpolated at ``t``,
edge-held outside the sampled range). ``use_trace`` selects the family;
``eval_signal`` computes both and picks one with ``torch.where``, so it
never reads a tensor on the host.

The builders make CPU tensors; ``core.state.build_statics`` moves the
scenario to the simulation's device. ``integrate_signal`` and
``signal_bounds`` arrive with the macro-stepping slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.device import take


class Signal(NamedTuple):
    """Scalar time series; evaluate with ``eval_signal(sig, t)``."""

    mean: torch.Tensor        # parametric: offset
    amp: torch.Tensor         # parametric: sinusoid amplitude
    period_s: torch.Tensor    # parametric: sinusoid period [s]
    phase: torch.Tensor       # parametric: phase [rad]
    noise_amp: torch.Tensor   # parametric: amplitude of harmonic noise
    noise_seed: torch.Tensor  # parametric: phase-offset seed for the noise
    values: torch.Tensor      # trace: (T,) samples, T >= 2
    t0: torch.Tensor          # trace: time of values[0] [s]
    dt: torch.Tensor          # trace: sample spacing [s]
    use_trace: torch.Tensor   # {0., 1.}: trace vs parametric family


def _f(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def sinusoid(
    mean: float,
    amp: float = 0.0,
    period_s: float = 86_400.0,
    phase: float = 0.0,
    *,
    noise_amp: float = 0.0,
    noise_seed: float = 0.0,
) -> Signal:
    """``mean + amp * sin(2*pi*t/period + phase) [+ noise]``."""
    return Signal(
        mean=_f(mean), amp=_f(amp), period_s=_f(period_s), phase=_f(phase),
        noise_amp=_f(noise_amp), noise_seed=_f(noise_seed),
        values=torch.zeros((2,), dtype=torch.float32), t0=_f(0.0),
        dt=_f(1.0), use_trace=_f(0.0),
    )


def constant(value: float) -> Signal:
    return sinusoid(value, 0.0)


def from_trace(values, dt: float, t0: float = 0.0) -> Signal:
    """Sampled trace, linearly interpolated; edge-hold outside [t0, t_end]."""
    v = np.asarray(values, np.float32).reshape(-1)
    if v.size == 0:
        raise ValueError("trace signal needs at least one sample")
    if v.size == 1:
        v = np.repeat(v, 2)
    return Signal(
        mean=_f(float(v.mean())), amp=_f(0.0), period_s=_f(86_400.0),
        phase=_f(0.0), noise_amp=_f(0.0), noise_seed=_f(0.0),
        values=torch.from_numpy(v.copy()), t0=_f(t0), dt=_f(dt),
        use_trace=_f(1.0),
    )


# incommensurate harmonic multipliers: noise never repeats within a period
_NOISE_HARMONICS = (2.718, 5.196, 9.424, 17.03)
# 2*pi*h rounded to f32 exactly as the f32 product (f32(2*pi) * f32(h)),
# so each angular rate below is one f32 division, as in the reference
_TWO_PI_H = tuple(
    float(np.float32(2.0 * math.pi) * np.float32(h)) for h in _NOISE_HARMONICS)


def _harmonic_noise(sig: Signal, t: torch.Tensor) -> torch.Tensor:
    """Deterministic O(1)-amplitude wander, a cheap stand-in for weather /
    grid-mix stochasticity that keeps eval a pure function of t. The four
    harmonics are summed in order, one 0-d op at a time: no constant
    vector has to be copied to the device."""
    period = torch.clamp(sig.period_s, min=1e-6)
    total = None
    for i, two_pi_h in enumerate(_TWO_PI_H):
        # golden-angle phase spread; seed shifts all phases together
        ph = sig.noise_seed * (1.0 + i) * 2.39996
        s = torch.sin((two_pi_h / period) * t + ph)
        total = s if total is None else total + s
    return total / 2.0   # sqrt(len(_NOISE_HARMONICS))


def eval_signal(sig: Signal, t: torch.Tensor) -> torch.Tensor:
    """Evaluate ``sig`` at time ``t`` (0-d f32, or (E,) for a batched
    signal or replica clocks). Both families are computed and one is
    picked on the device; the trace samples are gathered row by row."""
    x = 2.0 * math.pi * t / torch.clamp(sig.period_s, min=1e-6) + sig.phase
    para = (sig.mean + sig.amp * torch.sin(x)
            + sig.noise_amp * _harmonic_noise(sig, t))

    T = sig.values.shape[-1]
    u = (t - sig.t0) / torch.clamp(sig.dt, min=1e-6)
    # clamping before the floor gives clip(floor(u), 0, T-2) for every
    # finite u and keeps the int cast in range
    i0 = torch.floor(torch.clamp(u, 0.0, float(T - 2))).to(torch.int32)
    frac = torch.clamp(u - i0.to(torch.float32), 0.0, 1.0)
    values = sig.values
    if values.dim() != i0.dim() + 1:     # one trace for every replica
        values = values.expand(i0.shape + (T,))
    trace = (take(values, i0) * (1.0 - frac)
             + take(values, i0 + 1) * frac)

    return torch.where(sig.use_trace > 0.5, trace, para)
