"""The fleet half of the JAX package's ``sharding/specs.py`` on
``torch.distributed``.

A replica-batched tree (a batched ``SimState``, ``Scenario`` or
``Policy``, fleet telemetry, a batched ``EnvState``) carries R replicas on
the leading axis of every leaf. On a fleet mesh of W ranks
(``launch.mesh.FleetMesh``) rank r owns the contiguous block of replicas
``[r * R / W, (r + 1) * R / W)``: the JAX package's ``P(axis)`` puts
replica i on device i // (R / W) the same way. ``fleet_block`` takes a
rank's block; ``gather_fleet`` all-gathers the blocks back into the whole
batch on every rank, a pure copy, so it is bitwise. Statics are never
split: every rank holds them whole, as the JAX package replicates them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_names, tree_map

FLEET_AXIS = "replica"   # the fleet mesh's axis name (launch.mesh)


def _replicas(tree: Any) -> int:
    """R, the leading axis every leaf of ``tree`` shares."""
    sizes = {int(np.shape(x)[0]) for _, x in tree_leaves_with_names(tree)
             if isinstance(x, (torch.Tensor, np.ndarray)) and np.ndim(x)}
    if len(sizes) != 1:
        raise ValueError(f"a fleet tree needs one leading replica axis on "
                         f"every leaf; got sizes {sorted(sizes)}")
    return sizes.pop()


def fleet_block(tree: Any, mesh) -> Any:
    """This rank's block of every leaf of a replica-batched ``tree``
    (tensors and numpy arrays; ``None`` subtrees stay ``None``): views, no
    copy. ``core.fleet.shard_fleet`` is this function."""
    n = _replicas(tree)
    if n % mesh.world:
        raise ValueError(f"{n} replicas do not divide across "
                         f"{mesh.world} ranks")
    b = n // mesh.world
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return tree_map(lambda x: x[sl] if isinstance(
        x, (torch.Tensor, np.ndarray)) else x, tree)


def gather_fleet(tree: Any, mesh) -> Any:
    """Every rank's block of ``tree`` concatenated along the replica axis,
    on every rank (``FleetMesh.all_gather``, leaf by leaf): the whole
    batch, bit for bit, each leaf where it was. gloo moves host memory,
    so there the leaves on the card come off it together in one counted
    read (``utils.device.drain``), are gathered on the host and go back,
    and numpy leaves (an ``EnvState``'s host step counters) are gathered
    on the host; under nccl every leaf is gathered on the rank's device,
    a numpy leaf then read back through ``utils.device.host_read`` (one
    counted read)."""
    from repro_torch.utils.device import drain, host_read, to_device

    if mesh.backend == "gloo" and any(
            isinstance(x, torch.Tensor) and x.is_cuda
            for _, x in tree_leaves_with_names(tree)):
        return tree_map(lambda x: to_device(x, mesh.device)
                        if isinstance(x, torch.Tensor) else x,
                        gather_fleet(drain(tree), mesh))

    def one(x):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if mesh.backend == "gloo":
                return mesh.all_gather(t).numpy()
            return host_read(mesh.all_gather(to_device(t, mesh.device)))
        if isinstance(x, torch.Tensor):
            return mesh.all_gather(x)
        return x

    return tree_map(one, tree)


__all__ = ["FLEET_AXIS", "fleet_block", "gather_fleet"]
