"""Gradient compression, as the JAX package's ``optim/compress.py``.

``quantize_dequantize``: per-tensor symmetric int8 quantization with
deterministic rounding (half to even, as ``jnp.round``).

``compressed_psum(grads, mesh, error)``: the int8 all-reduce of
distributed PPO (``rl.distributed``) on a fleet mesh's ranks: quantize
each rank's gradients (plus its carried error) to int8 with a scale
shared by all ranks (the max of their scales: one scalar all-reduce per
tensor), sum the int8 payload as int32 over the ranks, dequantize and
average, and carry each rank's quantization error into its next step
(error feedback, Seide et al. 2014) so the bias does not accumulate.

Rounding follows what XLA's CPU compiler makes of the JAX code, so the
results are the JAX package's bit for bit: ``x / 127.0`` and the mean's
``/ n`` (n the world size, a constant at trace time) become products with
their f32 reciprocals; ``g / scale`` stays a true division; and the new
error ``gf - q * scale`` is one fused multiply-add (``prng.fma_f32``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.prng import fma_f32
from repro_torch.utils.tree import tree_map

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _scale(gf: torch.Tensor) -> torch.Tensor:
    return torch.clamp(gf.abs().max(), min=1e-12) * _INV_127


def _quantize(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def quantize_dequantize(grads: Any) -> Any:
    """Every leaf through int8 and back at its own scale, in its dtype."""
    def one(g):
        gf = g.to(torch.float32)
        scale = _scale(gf)
        return (_quantize(gf, scale).to(torch.float32) * scale).to(g.dtype)

    return tree_map(one, grads)


def compressed_psum(grads: Any, mesh, error: Optional[Any] = None
                    ) -> Tuple[Any, Any]:
    """int8 all-reduce with error feedback over ``mesh``'s ranks (call it
    on every rank). ``grads`` and ``error``: dicts of tensors (the port's
    parameter trees); returns (mean_grads, new_error) alike. The int8
    values are summed as int32, as the JAX package's ``psum`` sums them:
    exact in any order of the ranks, but as many bytes on the wire as an
    f32 all-reduce, plus one scalar a tensor."""
    inv_n = float(np.float32(1.0) / np.float32(mesh.world))

    def one(g, e):
        gf = g.to(torch.float32) + (e if e is not None else 0.0)
        # a shared scale is required for the int8 sum to be exact: the
        # max of the ranks' scales
        scale = mesh.all_reduce(_scale(gf).reshape(1), "max")[0]
        q = _quantize(gf, scale)
        summed = mesh.all_reduce(q.to(torch.int32), "sum")
        out = (summed.to(torch.float32) * scale) * inv_n
        new_e = fma_f32(-q.to(torch.float32), scale.expand_as(gf), gf)
        return out.to(g.dtype), new_e

    pairs = {k: one(g, None if error is None else error[k])
             for k, g in grads.items()}
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


__all__ = ["quantize_dequantize", "compressed_psum"]
