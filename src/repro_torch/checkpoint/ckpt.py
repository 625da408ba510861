"""Crash-atomic checkpoints of the port's trees, in the JAX package's
format (``repro/checkpoint/ckpt.py``), so either package reads what the
other writes.

- A checkpoint is a directory ``step_<N:010d>/`` holding one ``.npy`` per
  leaf (the leaf's ``utils.tree`` name, ``/`` written ``__``) and
  ``manifest.json`` (``step``, ``leaves`` with each leaf's shape and
  dtype, ``extra``). numpy files, never pickles: the format is the data.
- bfloat16 has no numpy dtype: its payload is stored as ``uint16`` under
  the dtype name ``bfloat16``.
- A write goes to ``step_<N>.tmp`` and is renamed into place, so a crash
  mid-write never leaves a partial checkpoint visible; ``latest_step``
  sweeps the stale ``.tmp`` directories such a crash leaves. Older
  checkpoints beyond ``keep`` are deleted. ``REPRO_CHAOS_SLOW_SAVE=<s>``
  sleeps that long before the rename, so the chaos harness
  (``utils.chaos``) can land kills mid-write.
- The tree is read off the card through ``utils.device.drain``: one
  counted host read a checkpoint. ``AsyncCheckpointer`` drains on the
  caller's thread and writes on a background thread.
- ``restore(directory, step, like)`` rebuilds ``like``'s structure: a
  leaf comes back as a tensor on the ``like`` leaf's device, or as a numpy
  array where the ``like`` leaf is one (as the JAX package's ``restore``
  returns host arrays; ``interop.state_from_numpy`` carries such a tree
  across). The port's PRNG key is (2,) int64 words and is stored as it
  is; a JAX key's uint32 words restore into it losslessly.

Missing or corrupt manifests, missing leaf files, and shape or dtype
mismatches raise ``CheckpointError`` naming the artifact.

On an LM mesh (DTensor leaves, ``sharding.specs``) ``save`` and
``AsyncCheckpointer.save`` gather each leaf whole (every rank takes part),
rank 0 reads it off the card and writes the JAX package's format, so the
checkpoint is the single-process one; ``restore(..., shardings=)`` reads
each leaf whole on every rank and keeps the rank's shard of it, placed by
that tree of ``sharding.specs.NamedSharding`` (any mesh's: elastic
restore), bit for bit.

On a fleet mesh (``launch.mesh.FleetMesh``) ``save_sharded`` is a
gather-to-host save, as the JAX package's is: the ranks all-gather their
blocks of a replica-batched tree (``sharding.specs.gather_fleet``), rank
0 writes the whole tree and the others wait at a barrier, so the
checkpoint is the single-process one and any world size reads it. Under
gloo each rank drains its block and the blocks are gathered on the host;
under nccl they are gathered on the card and rank 0 drains the whole:
one counted read a snapshot on each rank that drains. ``restore_sharded``
reads it on the host and gives each rank its block.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.device import drain, to_device
from repro_torch.utils.errors import CheckpointError
from repro_torch.utils.tree import (
    tree_leaves_with_names,
    tree_map_with_path_names,
)

MANIFEST = "manifest.json"
BF16 = "bfloat16"


def _file(name: str) -> str:
    return name.replace("/", "__") or "leaf"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _to_numpy(x) -> tuple:
    """(array to store, dtype name) of one host leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), BF16
        arr = x.numpy()
    else:
        arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == BF16:  # ml_dtypes' bf16
        return arr.view(np.uint16), arr.dtype.name
    return arr, str(arr.dtype)


def _write(directory: str, step: int, host, extra_meta, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": int(step), "leaves": {}, "extra": extra_meta or {}}
    for name, leaf in tree_leaves_with_names(host):
        arr, dtype_name = _to_numpy(leaf)
        fname = _file(name)
        np.save(os.path.join(tmp, fname + ".npy"), arr)
        meta["leaves"][fname] = {"shape": list(arr.shape),
                                 "dtype": dtype_name}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(meta, f)
    # chaos hook: widen the pre-rename window so the crash harness can
    # land kills mid-write and show the rename never exposes a torn one
    slow = os.environ.get("REPRO_CHAOS_SLOW_SAVE")
    if slow:
        time.sleep(float(slow))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _gathered(tree: Any):
    """(the host tree to write, or None on a rank that does not write): a
    tree with DTensor leaves is gathered leaf by leaf on every rank and
    drained on rank 0; any other tree drained as it is."""
    if not any(_is_dtensor(x) for _, x in tree_leaves_with_names(tree)):
        return drain(tree)
    import torch.distributed as dist

    writer = dist.get_rank() == 0

    def one(x):
        if not _is_dtensor(x):
            return x if writer else None
        full = x.full_tensor()
        return drain(full) if writer else None

    host = tree_map_with_path_names(lambda _, x: one(x), tree)
    return host if writer else None


def save(directory: str, step: int, tree: Any, *,
         extra_meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Write ``tree`` as checkpoint ``step`` of ``directory``, atomically;
    keep the newest ``keep`` checkpoints. Returns the checkpoint's path.
    A tree of DTensors: call it on every rank (rank 0 writes, the others
    wait for it)."""
    host = _gathered(tree)
    path = _step_dir(directory, step)
    if host is not None:
        path = _write(directory, step, host, extra_meta, keep)
    _mesh_barrier(tree)
    return path


def _mesh_barrier(tree: Any) -> None:
    """Every rank waits here when ``tree`` holds DTensors."""
    if any(_is_dtensor(x) for _, x in tree_leaves_with_names(tree)):
        import torch.distributed as dist

        dist.barrier()


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """Newest complete checkpoint step in ``directory`` (None if none).

    Also sweeps stale ``step_<N>.tmp`` directories left by a crash
    mid-write: the rename never happened, so they are incomplete and
    deleting them is safe. Do not scan a directory a live
    ``AsyncCheckpointer`` of another process writes into."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
        elif d.startswith("step_") and \
                os.path.exists(os.path.join(directory, d, MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def read_meta(directory: str, step: int) -> Dict[str, Any]:
    """A checkpoint's manifest; ``CheckpointError`` if missing or corrupt."""
    path = os.path.join(_step_dir(directory, step), MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"no checkpoint manifest at {path} — directory missing or "
            "write never completed", field="manifest.json") from None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"corrupt checkpoint manifest {path}: {e}",
            field="manifest.json") from None


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        # torch has no general unsigned ints: widen losslessly
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr)


def restore(directory: str, step: int, like: Any, *,
            shardings: Any = None, mmap: bool = False) -> Any:
    """Checkpoint ``step`` of ``directory`` in the structure of ``like``
    (see the module docstring for where each leaf lands). ``shardings``: a
    tree of ``sharding.specs.NamedSharding`` matching ``like``; each leaf
    then comes back a DTensor so placed (on ``like``'s leaf's device, or
    the mesh's for a ``meta`` one), read on the host and cut to this
    rank's shard one leaf at a time. ``mmap``: numpy leaves come back as
    read-only maps of their files, read as they are touched (several
    processes reading one checkpoint share the pages)."""
    path = _step_dir(directory, step)
    meta = read_meta(directory, step)
    placed = dict(tree_leaves_with_names(shardings)) if shardings else {}

    def load(name, leaf):
        fname = _file(name)
        try:
            arr = np.load(os.path.join(path, fname + ".npy"),
                          mmap_mode="r" if mmap else None)
        except FileNotFoundError:
            raise CheckpointError(
                f"checkpoint {path} is missing leaf file {fname}.npy "
                "(manifest/leaf mismatch)", field=fname) from None
        except ValueError as e:
            raise CheckpointError(
                f"checkpoint leaf {path}/{fname}.npy is corrupt: {e}",
                field=fname) from None
        dtype_name = meta["leaves"].get(fname, {}).get("dtype",
                                                       str(arr.dtype))
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise CheckpointError(
                f"checkpoint leaf {name} shape {tuple(arr.shape)} != "
                f"expected {expect}", field=fname)
        if not isinstance(leaf, torch.Tensor):
            if dtype_name != str(arr.dtype) and dtype_name != BF16:
                arr = arr.view(np.dtype(dtype_name))
            return arr
        out = _as_tensor(arr, dtype_name)
        if out.dtype != leaf.dtype:
            lossless = (not out.dtype.is_floating_point
                        and not leaf.dtype.is_floating_point
                        and out.dtype != torch.bool
                        and torch.promote_types(out.dtype, leaf.dtype)
                        == leaf.dtype)
            if not lossless:
                raise CheckpointError(
                    f"checkpoint leaf {name} dtype {dtype_name} != "
                    f"expected {leaf.dtype}", field=fname)
            out = out.to(leaf.dtype)
        if name in placed:
            return _placed(out, placed[name])
        return to_device(out, leaf.device)

    return tree_map_with_path_names(load, like)


def _placed(full: torch.Tensor, sharding):
    """``full`` (on the host) as a DTensor on ``sharding``'s mesh and
    placements, this rank keeping its shard, cut on the host: no rank's
    data moves."""
    from repro_torch.sharding.specs import distribute_leaf

    return distribute_leaf(full, sharding.spec, sharding.mesh)


def save_sharded(directory: str, step: int, tree: Any, mesh, *,
                 extra_meta: Optional[Dict[str, Any]] = None,
                 keep: int = 3, whole=None) -> str:
    """Write this rank's block ``tree`` of a replica-batched tree, with
    every other rank's, as one checkpoint of the whole tree (see the
    module docstring); call it on every rank. ``whole``: leaves already
    whole on every rank (a dict merged into the gathered one). Returns
    the checkpoint's path on every rank."""
    from repro_torch.sharding.specs import gather_fleet

    host = None
    if mesh.backend == "gloo":
        # gloo gathers host memory: each rank's block off the card first
        host = drain({"block": tree, "whole": whole or {}})
        host["block"] = gather_fleet(host["block"], mesh)
    else:
        full = gather_fleet(tree, mesh)     # on the card, no wait
        if mesh.rank == 0:
            host = drain({"block": full, "whole": whole or {}})
    path = _step_dir(directory, step)
    if mesh.rank == 0:
        full = host["block"]
        if host["whole"]:
            full = {**full, **host["whole"]}
        path = _write(directory, step, full, extra_meta, keep)
    mesh.barrier()
    return path


def restore_sharded(directory: str, step: int, like: Any, mesh) -> Any:
    """Checkpoint ``step`` of ``directory`` as this rank's block: ``like``
    is the WHOLE tree's template (every leaf with the leading replica axis
    of all ranks), read on the host and cut to this rank's block
    (``sharding.specs.fleet_block``)."""
    from repro_torch.sharding.specs import fleet_block

    return fleet_block(restore(directory, step, like), mesh)


class AsyncCheckpointer:
    """Checkpoint writer on a background thread: ``save`` drains the tree
    on the caller's thread (one counted read), then writes meanwhile;
    ``wait`` joins the write before the next ``save``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: Any, *,
             extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """A tree of DTensors: call it on every rank; rank 0 gathers and
        writes, the others return once the gathers are done."""
        self.wait()
        host = _gathered(tree)
        if host is None:
            return

        def work():
            self.last_path = _write(self.directory, step, host, extra_meta,
                                    self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
