"""The thermal DVFS throttle of the replay tick, defined once: the clock
fraction of a rack at its outlet temperature. ``core.thermal.rack_throttle``
and the plain versions of the tick kernels call ``throttle_curve``; the
kernels call its twin in ``csrc/throttle.cuh``, which takes ``Throttle``
as the C struct ``CThrottle`` mirrors."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.utils.device import full


class Throttle(NamedTuple):
    """The ramp, as Python floats (``core.thermal.throttle_params`` makes
    it from a ``SimConfig``)."""

    start_c: float
    span: float      # max(throttle_full_c - throttle_start_c, 1e-6)
    drop: float      # 1 - thermal_throttle_floor
    floor: float


class CThrottle(ctypes.Structure):
    """``Throttle`` of csrc/throttle.cuh, field for field."""

    _fields_ = [(f, ctypes.c_float) for f in ("start", "span", "drop",
                                               "floor")]


def throttle_curve(temp: torch.Tensor, p: Throttle) -> torch.Tensor:
    """DVFS clock fraction of a rack at outlet temperature ``temp``: 1
    below ``p.start_c``, a linear ramp down by ``p.drop`` over ``p.span``,
    clamped to [``p.floor``, 1]."""
    # divide by a device tensor: on CUDA a division by a Python scalar is
    # a multiply by its reciprocal, and the throttle scales job progress
    ramp = (temp - p.start_c) / full(p.span, torch.float32, temp.device)
    return torch.clamp(1.0 - p.drop * ramp, p.floor, 1.0)
