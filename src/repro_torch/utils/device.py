"""Device choice and host-sync-free indexing helpers shared by the port.

The entry points run on the card unless the caller names another device;
with no device given and no CUDA, they raise instead of quietly running
on the CPU. Inside the per-tick step nothing may read a tensor on the
host: ``take``/``put`` gather and scatter with an index tensor because
``t[j]`` with a 0-d tensor calls ``__index__`` and synchronises. They are
row-wise: the index holds one entry per replica (0-d for one replica,
(E,) for E), and each replica reads or writes its own entry. Copies from
the host to the card (``to_device``) are asynchronous, so they are no
sync either.

A loop whose trip count depends on the data (the macro-stepping
engine's fast-forward) must read how far to go: it reads through
``host_read``, the port's one counted read. On the card it lifts
sync-debug "error" for its own copy only, so any other sync still
raises; ``HOST_READS`` counts the reads.
"""

from __future__ import annotations

import numpy as np
import torch

HOST_READS: dict[str, int] = {"count": 0}


def reset_host_reads() -> None:
    HOST_READS["count"] = 0


def host_read(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host: one counted read (a sync on the
    card), allowed under sync-debug "error" for this copy alone."""
    HOST_READS["count"] += 1
    if x.device.type != "cuda":
        return x.detach().numpy()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return x.detach().cpu().numpy()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def exact_matmul() -> None:
    """Matrix products accumulate in full f32, as XLA's do: no TF32 for
    f32 products or convolutions, no reduced-precision reductions inside
    bf16 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _row_index(t: torch.Tensor, idx: torch.Tensor, dim: int | None):
    """(dim, gather index): ``idx``'s shape is ``t``'s leading dims, and
    the index has ``t``'s shape with 1 at ``dim`` (default: the first dim
    after the leading ones)."""
    lead = idx.dim()
    d = lead if dim is None else dim % t.dim()
    shape = list(t.shape)
    shape[d] = 1
    index = idx.long().reshape(tuple(idx.shape) + (1,) * (t.dim() - lead))
    return d, index.expand(shape)


def take(t: torch.Tensor, idx: torch.Tensor,
         dim: int | None = None) -> torch.Tensor:
    """Row-wise ``t[..., idx, ...]``: each replica's entry at its own index
    ``idx`` (shaped like ``t``'s leading replica dims: 0-d for one) along
    ``dim``, with no sync. One replica takes a one-element
    ``index_select``, whose host cost is a third of the gather's set-up."""
    if idx.dim() == 0:
        d = 0 if dim is None else dim
        return t.index_select(d, idx.reshape(1).long()).squeeze(d)
    d, index = _row_index(t, idx, dim)
    return torch.gather(t, d, index).squeeze(d)


def put(t: torch.Tensor, idx: torch.Tensor, value: torch.Tensor,
        dim: int | None = None) -> torch.Tensor:
    """Copy of ``t`` with each replica's slice at its index ``idx`` along
    ``dim`` replaced by ``value`` (``take``'s shape), with no sync; one
    replica by a one-element ``index_copy``, as ``take``."""
    if idx.dim() == 0:
        d = 0 if dim is None else dim
        return t.index_copy(d, idx.reshape(1).long(),
                            value.to(t.dtype).unsqueeze(d))
    d, index = _row_index(t, idx, dim)
    return t.scatter(d, index, value.to(t.dtype).unsqueeze(d))


def full(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """0-d constant made on ``device`` by a fill, not a host copy."""
    return torch.full((), value, dtype=dtype, device=device)


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; a copy from the host to the card is queued on
    the current stream (the host keeps no reference it must hold)."""
    return x.to(device, non_blocking=x.device.type == "cpu")


def tree_to(x, device: torch.device):
    """Move every tensor of a (nested) NamedTuple to ``device`` (from the
    host asynchronously, as ``to_device``); ``None`` leaves stay ``None``."""
    if isinstance(x, torch.Tensor):
        return to_device(x, device)
    if x is None:
        return None
    return type(x)(*(tree_to(v, device) for v in x))
