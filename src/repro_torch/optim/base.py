"""The optimizers' shared pieces, as the JAX package's ``optim/base.py``
and ``utils/tree.py``: a ``Schedule``, the global norm and clipping by
it, and the finiteness test of the train step's guard.

A tree is a dict (nested dicts and lists, as an LM's parameter tree in the
JAX package's layout, or flat, as the actor-critic's) of tensors. Its
leaves are taken in the JAX package's flatten order
(``utils.tree.tree_leaves_with_names``: dict keys sorted, lists in order),
so a reduction over leaves adds them in the JAX package's order.

On a mesh the leaves are DTensors: each leaf's reduction is made whole
(``plain``: summed over its shards, on every rank) before the leaves'
reductions are combined, so the norm and the guard are the whole tree's,
the same on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.utils.tree import tree_leaves_with_names, tree_map

# step (0-d int32 tensor) -> learning rate (0-d f32 tensor)
Schedule = Callable[[torch.Tensor], torch.Tensor]


def leaves(tree: Any) -> list:
    return [x for _, x in tree_leaves_with_names(tree)]


def by_name(tree: Any) -> Dict[str, torch.Tensor]:
    return dict(tree_leaves_with_names(tree))


def plain(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as the whole tensor on every rank; a tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (f32)."""
    sums = [plain(torch.sum(torch.square(x.to(torch.float32))))
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / norm): what clipping by the global norm scales
    every gradient by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every value of every leaf finite."""
    return torch.stack([plain(torch.isfinite(x).all())
                        for x in leaves(tree)]).all()
