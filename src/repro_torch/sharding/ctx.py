"""The logical-axis sharding context of the LM code (the JAX package's
``sharding/ctx.py``) on ``torch.distributed.tensor``.

The model code names the axes of an activation by *logical* axes
(``"dp"``, ``"tp"``, ``"sp"``, ``"fsdp"``, None); the context maps them
onto the mesh's axes and ``constrain`` redistributes a DTensor to them,
where the JAX package emits ``with_sharding_constraint``. On a plain
tensor, or with ``enabled=False`` (one card, the CPU tests), it does
nothing, so the same model code serves both worlds.

Mapping onto the mesh (``launch.mesh``):

  dp   -> ("pod", "data")   batch
  tp   -> "model"           heads / d_ff / vocab
  sp   -> "model"           the residual stream's sequence (seq_parallel)
  fsdp -> ("pod", "data")   parameter and optimizer-state sharding

A spec is a tuple with one entry per tensor dim: a mesh axis name, None,
or a tuple of names (the dim split over several axes, the first major).
``sharding.specs.placements`` turns one into DTensor placements.

Fields read here: the mesh fields above, ``decode_kv_shard`` (the decode
cache's spec), ``tp_size`` / ``dp_size`` (divisibility without a mesh),
``cast_params_bf16`` (``train.train_step``: a bfloat16 model's f32 masters
cast on their shards, before any gather, so the gathers move bf16),
``remat`` (what the training forward recomputes in the backward pass,
``torch.utils.checkpoint``, non-reentrant: ``"block"`` each superblock of
the body and each encoder layer, ``"layer"`` each body layer on its own,
so only one layer's gathered weights live at a time, ``"none"``
nothing; the tail is never recomputed, as in the JAX package) and
``logit_chunk`` (the LM loss's sequence chunk, each chunk's logits
recomputed in the backward pass). The JAX package's XLA knobs have no
reader here and are left out: ``attention_impl``, ``block_q`` and
``block_k`` (the kernel tiles itself), ``force_unroll`` and
``scan_unroll`` (the port's layers are a Python loop, not a scan).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

REMATS = ("none", "block", "layer")
KV_SHARDS = ("seq", "seq2d", "head", "none")


@dataclass(frozen=True)
class ShardCtx:
    enabled: bool = False
    dp: Tuple[str, ...] = ("data",)
    tp: Optional[str] = "model"
    seq_parallel: bool = True        # the residual stream's S over tp
    fsdp: bool = True                # params over the dp axes
    expert_parallel: bool = True     # MoE experts over tp when divisible
    decode_kv_shard: str = "seq"     # 'seq' | 'seq2d' | 'head' | 'none'
    tp_size: int = 16                # |model| (divisibility checks)
    dp_size: int = 1                 # |data (x pod)|
    cast_params_bf16: bool = True    # cast on the shard, then gather
    logit_chunk: int = 1024
    remat: str = "block"             # 'none' | 'block' | 'layer'

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")
        if self.decode_kv_shard not in KV_SHARDS:
            raise ValueError(f"decode_kv_shard must be one of {KV_SHARDS}, "
                             f"got {self.decode_kv_shard!r}")

    def axis(self, logical: Optional[str]):
        """The mesh axis (a name, a tuple of names, or None) of a logical
        axis."""
        if logical is None:
            return None
        if logical in ("dp", "fsdp"):
            if not self.dp:
                return None
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if logical == "sp":
            return self.tp if self.seq_parallel else None
        if logical == "tp":
            return self.tp
        raise ValueError(f"unknown logical axis {logical}")

    def pspec(self, *logical) -> tuple:
        return tuple(self.axis(a) for a in logical)

    def constrain(self, x, *logical):
        """``x`` redistributed to the spec of ``logical`` (one logical axis
        a dim) on its own mesh; ``x`` itself when the context is off or
        ``x`` is a plain tensor."""
        return self.constrain_raw(x, self.pspec(*logical))

    def constrain_raw(self, x, spec: tuple):
        if not self.enabled:
            return x
        from torch.distributed.tensor import DTensor

        from repro_torch.sharding.specs import placements

        if not isinstance(x, DTensor):
            return x
        want = placements(spec, x.device_mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    def kv_cache_pspec(self) -> tuple:
        """The spec of a (B, S, Kv, hd) decode KV cache."""
        if not self.enabled or self.decode_kv_shard == "none":
            return ()
        if self.decode_kv_shard == "seq":
            return (self.axis("dp"), self.tp, None, None)
        if self.decode_kv_shard == "seq2d":
            # batch too small to shard: the sequence over every axis
            return (None, tuple(self.dp) + (self.tp,), None, None)
        return (self.axis("dp"), None, self.tp, None)      # "head"

    def with_(self, **kw) -> "ShardCtx":
        return replace(self, **kw)

    def heads_axis(self, n_heads: int):
        """``tp`` if ``n_heads`` divides over it, else None (replicate)."""
        return self.tp if (self.tp and n_heads % max(self.tp_size, 1) == 0) \
            else None


UNSHARDED = ShardCtx(enabled=False)


def make_ctx(multi_pod: bool, **kw) -> ShardCtx:
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardCtx(enabled=True, dp=dp, tp="model", **kw)
