"""The JAX package's ``sharding/specs.py`` on ``torch.distributed``: the
fleet half (``fleet_block``, ``gather_fleet``) and the LM half (the specs
of parameters, batches, caches and the train state, and their DTensor
placements).

Fleet half. A replica-batched tree (a batched ``SimState``, ``Scenario`` or
``Policy``, fleet telemetry, a batched ``EnvState``) carries R replicas on
the leading axis of every leaf. On a fleet mesh of W ranks
(``launch.mesh.FleetMesh``) rank r owns the contiguous block of replicas
``[r * R / W, (r + 1) * R / W)``: the JAX package's ``P(axis)`` puts
replica i on device i // (R / W) the same way. ``fleet_block`` takes a
rank's block; ``gather_fleet`` all-gathers the blocks back into the whole
batch on every rank, a pure copy, so it is bitwise. Statics are never
split: every rank holds them whole, as the JAX package replicates them.

LM half. A spec is a tuple with one entry per tensor dim: a mesh axis
name, None, or a tuple of names (``sharding.ctx``); a spec tree mirrors
its tensor tree with a spec at each leaf (tuples are leaves here, dicts
and lists nodes: ``spec_leaves``, ``spec_map``). The rules are the JAX
package's, rule for rule: Megatron-style TP over ``model`` and
ZeRO-3 / FSDP over the data axes,

  emb (V, D)            -> (tp, fsdp)     vocab-parallel embedding
  head (D, V)           -> (fsdp, tp)
  wq/wk/wv (D, H*hd)    -> (fsdp, tp)     column-parallel
  wo (H*hd, D)          -> (tp, fsdp)     row-parallel
  wi/wg (D, F)          -> (fsdp, tp);  wo2 (F, D) -> (tp, fsdp)
  router (D, E)         -> (fsdp, None)
  experts (E, D, F)     -> (tp, fsdp, None) when E % |tp| == 0 (EP),
                           else (None, fsdp, tp)
  mamba in_proj         -> (fsdp, tp);  out_proj -> (tp, fsdp)
  scalars/norms/biases  -> replicated
  stacked layers' leading axis (superblock repeats) -> None prepended

and a sharding that does not divide its dim over the mesh is dropped.
``placements(spec, mesh)`` gives a spec's DTensor placements on a
``DeviceMesh``, ``distribute`` a tree's DTensors by a spec tree.
``mesh`` may be a ``DeviceMesh`` or a dict of axis sizes (axis name ->
size), so the specs need no world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec as S
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.utils.tree import (
    tree_leaves_with_names,
    tree_map,
    tree_map_with_path_names,
)

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


# ---------------------------------------------------------------- LM half
def spec_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, tuple]]:
    """``(name, spec)`` of every spec in a spec tree, in the JAX
    package's flatten order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in spec_leaves(tree[k], f"{prefix}/{k}" if prefix
                                     else str(k))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in spec_leaves(v, f"{prefix}/{i}" if prefix
                                     else str(i))]
    return [(prefix, tree)]


def spec_map(fn: Callable[[str, tuple], Any], tree: Any,
             prefix: str = "") -> Any:
    """A spec tree rebuilt with each spec replaced by ``fn(name, spec)``."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_map(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a dict of sizes."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements, one a mesh dim, of ``spec`` on ``mesh``:
    ``Shard(d)`` on each mesh axis that splits tensor dim d, else
    ``Replicate()``. A dim split over several axes (``("pod", "data")``)
    is split major axis first, which DTensor does in mesh order: the
    axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_sizes(mesh))
    out = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(order)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {order[i]} "
                                 "splits two dims")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the JAX package's ``NamedSharding``):
    where one leaf is placed (``checkpoint.restore(shardings=)``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_shardings(specs: Any, mesh) -> Any:
    """A spec tree as a tree of ``NamedSharding`` on ``mesh``."""
    return spec_map(lambda _, spec: NamedSharding(mesh, spec), specs)


def distribute_leaf(x: torch.Tensor, spec: tuple, mesh):
    """The whole tensor ``x`` (on any device: the CPU, or the mesh's) as a
    DTensor on ``mesh`` laid out by ``spec``. This rank cuts its own
    shard where x lies and copies only the shard to the mesh's device,
    into storage of its own: x is never whole on the card unless it was
    there already, and its memory is freed with it. A contiguous leaf
    this rank holds whole, on the mesh's device already, is kept as it
    is (a view that is not contiguous is copied: DTensor's views of it
    would fail). A split
    that does not divide its dim takes DTensor's own uneven sharding."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    pl = placements(spec, mesh)
    if any(isinstance(p, Shard) and x.shape[p.dim] % mesh.size(i)
           for i, p in enumerate(pl)):
        return distribute_tensor(x.to(mesh.device_type), mesh, pl,
                                 src_data_rank=None)
    local, coord = x, mesh.get_coordinate()
    for i, p in enumerate(pl):         # mesh axes in order, as DTensor
        if isinstance(p, Shard) and mesh.size(i) > 1:
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    if (local is not x or x.device.type != mesh.device_type
            or not x.is_contiguous()):
        local = local.to(mesh.device_type, copy=True).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape,
                              stride=torch.empty(x.shape,
                                                 device="meta").stride())


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` by the spec tree
    ``specs`` (same structure). Every rank passes the whole tensor and
    keeps its own shard of it (``distribute_leaf``): no rank's data
    moves."""
    by = dict(spec_leaves(specs))
    return tree_map_with_path_names(
        lambda n, x: distribute_leaf(x, by[n], mesh), tree)


def _expert_rule(cfg: ModelConfig, name: str, tp_size: int) -> tuple:
    ep = (cfg.moe.n_experts % max(tp_size, 1) == 0
          and cfg.moe.n_experts >= tp_size)
    if name in ("e_wg", "e_wi"):
        return ("tp", "fsdp", None) if ep else (None, "fsdp", "tp")
    if name == "e_wo":
        return ("tp", None, "fsdp") if ep else (None, "tp", "fsdp")
    raise KeyError(name)


# param base-name -> logical axes per dim, for unstacked shapes
_COL = ("fsdp", "tp")   # (in, out-sharded)
_ROW = ("tp", "fsdp")   # (in-sharded, out)
_RULES: Dict[str, tuple] = {
    "emb": ("tp", "fsdp"),
    "head": _COL,
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "xq": _COL, "xk": _COL, "xv": _COL, "xo": _ROW,
    "wi": _COL, "wg": _COL, "wo2": _ROW,
    "router": ("fsdp", None),
    "in_proj": _COL,
    "out_proj": _ROW,
    "x_proj": ("tp", None),
    "dt_w": (None, "tp"),
    "A_log": ("tp", None),
    "conv_w": (None, "tp"),
    "up": _COL,
    "down": _ROW,
    "w": ("fsdp", None),
    "r": (None, None, None),
}
# per-di vectors live on the tp axis
_TP_VECTORS = {"conv_b", "dt_b", "D_skip", "ln_inner_mamba"}


def _stacked(name: str) -> bool:
    return (name.startswith(("body/", "xattn_body/")) or "/layers/" in name
            or name.startswith("encoder/layers"))


def param_pspecs(cfg: ModelConfig, ctx: ShardCtx, mesh=None) -> Any:
    """The spec tree of ``models.spec.model_param_specs(cfg)``. Without a
    mesh nothing is dropped and ``tp_size`` is taken as 16."""
    sizes = mesh_sizes(mesh) if mesh is not None else None
    tp_size = sizes["model"] if sizes and "model" in sizes else 16

    def logical_for(name: str, shape) -> tuple:
        base = name.rsplit("/", 1)[-1]
        if base in ("e_wg", "e_wi", "e_wo"):
            return _expert_rule(cfg, base, tp_size)
        if base in _TP_VECTORS and len(shape) == 1:
            return ("tp",)
        rule = _RULES.get(base)
        if rule is None or len(rule) != len(shape):
            return tuple(None for _ in shape)
        return rule

    def one(name: str, shape) -> tuple:
        stacked = _stacked(name)
        core = tuple(shape[1:]) if stacked else tuple(shape)
        logical = logical_for(name, core)
        if not ctx.fsdp:
            logical = tuple(None if a == "fsdp" else a for a in logical)
        if not ctx.expert_parallel and \
                name.rsplit("/", 1)[-1].startswith("e_w"):
            logical = tuple(None if a == "tp" and i == 0 else a
                            for i, a in enumerate(logical))
        axes = [ctx.axis(a) for a in logical]
        # drop shardings that do not divide (no padded params)
        if sizes is not None:
            for i, (dim, ax) in enumerate(zip(core, axes)):
                if ax is None:
                    continue
                n = int(np.prod([sizes[a] for a in _names(ax)]))
                if dim % n != 0:
                    axes[i] = None
        return tuple(([None] if stacked else []) + axes)

    return spec_map(one, S.model_param_specs(cfg))


def batch_pspec(ctx: ShardCtx) -> tuple:
    return (ctx.axis("dp"),)


def batch_pspecs(cfg: ModelConfig, shape, ctx: ShardCtx) -> dict:
    """The specs of a batch of ``shape`` (a ``configs.ShapeConfig``):
    train and prefill (with the VLM's and whisper's memories), or decode
    (one token, the cache, its length)."""
    dp = ctx.axis("dp")
    if shape.mode in ("train", "prefill"):
        out = {"tokens": (dp, None)}
        if shape.mode == "train":
            out["labels"] = (dp, None)
        if cfg.n_vision_tokens:
            out["vision"] = (dp, None, None)
        if cfg.enc_dec:
            out["audio"] = (dp, None, None)
        return out
    small_batch = ctx.decode_kv_shard == "seq2d"
    return {"tokens": (None if small_batch else dp, None),
            "cache": cache_pspecs(cfg, ctx), "cache_len": ()}


def cache_pspecs(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """The spec tree of ``models.model.cache_specs`` (the decode caches
    in the JAX package's stacked layout)."""
    from repro_torch.models.model import cache_specs

    template = cache_specs(cfg, 8, 64)   # structure only
    kv = ctx.kv_cache_pspec()
    dp = None if ctx.decode_kv_shard == "seq2d" else ctx.axis("dp")
    tp = ctx.tp if ctx.enabled else None

    def one(name, t):
        base = name.rsplit("/", 1)[-1]
        stacked = name.startswith("body/")
        nd = t.dim() - (1 if stacked else 0)
        if base in ("k", "v"):
            spec = list(kv) + [None] * (4 - len(kv))
        elif base in ("xk", "xv"):
            spec = [dp, None, None, None]
        elif base == "conv":
            spec = [dp, None, tp]
        elif base == "ssm":
            spec = [dp, tp, None]
        else:   # C, n, m, c, h: small per-batch states
            spec = [dp] + [None] * (nd - 1)
        spec = spec[:nd] + [None] * (nd - len(spec))
        return tuple(([None] if stacked else []) + spec)

    return tree_map_with_path_names(one, template)


def layer_cache_pspecs(cfg: ModelConfig, ctx: ShardCtx) -> List[dict]:
    """``cache_pspecs`` for the port's cache, a list with one entry per
    layer (``models.model.Cache``): layer ``r * period + p`` takes
    ``body[p]``'s specs without the leading repeat axis, layer ``R *
    period + j`` ``tail[j]``'s."""
    period, R, _ = S.layout(cfg)
    tree = cache_pspecs(cfg, ctx)
    return [{k: v[1:] for k, v in tree["body"][i % period].items()}
            if i < R * period else dict(tree["tail"][i - R * period])
            for i in range(cfg.n_layers)]


def train_state_pspecs(cfg: ModelConfig, ctx: ShardCtx, optimizer,
                       mesh=None) -> dict:
    """The spec tree of a train state (``train.state``)."""
    p_specs = param_pspecs(cfg, ctx, mesh)
    return {"params": p_specs,
            "opt": optimizer.state_pspecs(S.model_param_specs(cfg), p_specs),
            "step": ()}


__all__ = ["FLEET_AXIS", "fleet_block", "gather_fleet", "spec_leaves",
           "spec_map", "mesh_sizes", "placements", "NamedSharding",
           "named_shardings", "distribute", "distribute_leaf",
           "param_pspecs", "batch_pspec", "batch_pspecs", "cache_pspecs",
           "layer_cache_pspecs",
           "train_state_pspecs"]
