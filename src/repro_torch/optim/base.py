"""Gradient clipping by the global norm, as the JAX package's
``optim.base.clip_by_global_norm`` and ``utils.tree.global_norm``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (f32)."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm
