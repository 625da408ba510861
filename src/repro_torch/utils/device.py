"""Device choice and host-sync-free indexing helpers shared by the port.

The entry points run on the card unless the caller names another device;
with no device given and no CUDA, they raise instead of quietly running
on the CPU. Inside the per-tick step nothing may read a tensor on the
host: ``take``/``put`` index with a one-element index tensor because
``t[j]`` with a 0-d tensor calls ``__index__`` and synchronises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def take(t: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``t`` at the 0-d integer index ``idx`` along ``dim``, with no sync."""
    return t.index_select(dim, idx.reshape(1).long()).squeeze(dim)


def put(t: torch.Tensor, idx: torch.Tensor, value: torch.Tensor,
        dim: int = 0) -> torch.Tensor:
    """Copy of ``t`` with the slice at the 0-d index ``idx`` along ``dim``
    replaced by ``value`` (the slice's shape), with no sync."""
    return t.index_copy(dim, idx.reshape(1).long(),
                        value.to(t.dtype).unsqueeze(dim))


def full(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """0-d constant made on ``device`` by a fill, not a host copy."""
    return torch.full((), value, dtype=dtype, device=device)


def tree_to(x, device: torch.device):
    """Move every tensor of a (nested) NamedTuple to ``device``; ``None``
    leaves stay ``None``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if x is None:
        return None
    return type(x)(*(tree_to(v, device) for v in x))
