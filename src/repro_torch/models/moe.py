"""Top-k Mixture-of-Experts FFN with grouped scatter dispatch (the JAX
package's ``models/moe.py``).

Tokens are reshaped into G groups along the batch (``n_groups``: the
context's data-parallel degree halved until it divides the batch, as the
JAX package's ``_n_groups``; 1 unsharded); routing ranks and the capacity
are computed within each group. Each (token, k) slot goes to its expert's
buffer at its rank among that expert's slots of the group, token-major
with k inner; slots at rank >= C are dropped (the later tokens of a group
drop first) and add nothing.

Casts follow the JAX package: the router product, the softmax, the gates
and the load-balancing loss in f32 from the f32 router master; the
dispatch buffer, the SwiGLU experts and the combine in the compute dtype.
Nothing reads the device: the capacity C is a host int taken from shapes,
dropped slots scatter a zero to their expert's row 0 (as the JAX
package's ``.at[...].add``), and the combine gathers from the same rows.

On a mesh (DTensors, an enabled ``ShardCtx``) each rank dispatches and
combines its own groups (the batch's rows on its dp axes; G must split
over them) on local tensors, with the router gathered whole: the
dispatch buffer (G, E, C, D) is whole over ``model``, as the JAX package
keeps it. The experts' layout on ``model`` (``sharding.specs``'s expert
rule) picks the collective:
- experts split (expert parallelism, E % |model| == 0): each rank runs
  its E / |model| experts on its slice of the buffer, and the output
  buffer is gathered over ``model``;
- d_ff split: each rank runs every expert on its d_ff columns, and the
  down product's partial sums are reduced over ``model``;
- experts whole: every rank runs them all.
The load-balancing loss's means run over every group of every rank. The
collectives are DTensor redistributions, so autograd carries each
gradient back as its collective's transpose.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import local_view, normed, rms_norm
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx

# the profiler range around the experts' products (``tools/profile_serve``
# reads their device time from it)
EXPERTS_RANGE = "moe::experts"


class Routing(NamedTuple):
    """One MoE call's routing, per group g and token t of the group."""
    probs: torch.Tensor        # (G, Tg, E) f32 router softmax
    expert_idx: torch.Tensor   # (G, Tg, K) int64, by falling prob
    gates: torch.Tensor        # (G, Tg, K) f32, renormalised over K
    rank: torch.Tensor         # (G, Tg * K) int64 rank within the expert
    keep: torch.Tensor         # (G, Tg * K) bool: rank < capacity
    capacity: int              # C, slots per expert and group
    aux: torch.Tensor          # () f32 Switch load-balancing loss


_RECORDED: Optional[List[Routing]] = None


@contextlib.contextmanager
def record_routing():
    """Collect the ``Routing`` of every ``moe_apply`` call made inside the
    block, in call order (layer by layer), as tensors on the compute device:
    nothing is read until the caller reads them."""
    global _RECORDED
    outer, _RECORDED = _RECORDED, []
    try:
        yield _RECORDED
    finally:
        _RECORDED = outer


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(capacity_factor: float, tokens_per_group: int, top_k: int,
             n_experts: int) -> int:
    """Slots per expert and group: the JAX package's expression, in Python
    floats in its order."""
    return round_up(
        int(capacity_factor * tokens_per_group * top_k / n_experts) or 1, 8)


def n_groups(ctx: ShardCtx, rows: int) -> int:
    """G: the data-parallel degree halved until it divides the batch's
    ``rows`` (the JAX package's ``_n_groups``)."""
    g = max(ctx.dp_size, 1)
    while g > 1 and rows % g:
        g //= 2
    return max(g, 1)


def top_k_desc(probs: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values in descending order, equal
    values by ascending index (the first k of a stable descending sort, on
    every device; ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _local_mean(t: torch.Tensor) -> torch.Tensor:
    return t.mean(dim=(0, 1))


def route(router: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
          capacity_factor: float, mean=_local_mean) -> Routing:
    """Routing of the normed tokens ``h`` (G, Tg, D) by the f32 router
    master (D, E). ``mean`` takes the load-balancing loss's means of a
    (G, Tg, E) tensor over its groups and tokens (over every rank's
    groups on a mesh)."""
    G, Tg, _ = h.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    logits = h.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                   # (G, Tg, E)
    gate_vals, expert_idx = top_k_desc(probs, K)            # (G, Tg, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    experts = torch.arange(E, device=h.device)
    # load-balance aux loss (Switch): E * sum_e(mean prob_e * mean count_e)
    pe = mean(probs)
    fe = mean((expert_idx[..., None] == experts).float().sum(dim=2))
    aux = E * torch.sum(pe * fe)

    # rank of each (token, k) slot within its expert, local to the group:
    # the exclusive cumsum of the one-hot over the token-major slots, laid
    # out (G, E, TgK) so that the scan runs along the innermost axis
    flat_e = expert_idx.reshape(G, Tg * K)
    onehot = (flat_e[:, None, :] == experts[:, None]).to(torch.int32)
    ranks_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    rank = torch.gather(ranks_all, 1, flat_e[:, None, :])[:, 0].long()
    C = capacity(capacity_factor, Tg, K, E)
    return Routing(probs, expert_idx, gate_vals, rank, rank < C, C, aux)


def _dispatch(hf: torch.Tensor, r: Routing, n_experts: int, dt
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the (G, E, C, D) buffer in ``dt``, each slot's row of it (G,
    TgK)): kept slots each to a row of their own, dropped slots a zero
    onto their expert's row 0."""
    G, Tg, D = hf.shape
    K, C = r.expert_idx.shape[-1], r.capacity
    flat_e = r.expert_idx.reshape(G, Tg * K)
    safe_rank = torch.where(r.keep, r.rank, 0)
    hk = hf.repeat_interleave(K, dim=1)                     # (G, TgK, D)
    contrib = torch.where(r.keep[..., None], hk, 0).to(dt)
    gidx = torch.arange(G, device=hf.device)[:, None]
    row = (gidx * n_experts + flat_e) * C + safe_rank       # (G, TgK)
    buf = torch.zeros(G * n_experts * C, D, dtype=dt,
                      device=hf.device).index_add(
        0, row.reshape(-1), contrib.reshape(-1, D))
    return buf.view(G, n_experts, C, D), row


def _experts(buf: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts of ``wg``, ``wi`` (E', D, F), ``wo`` (E', F, D)
    on ``buf`` (G, E', C, D), every group's C rows of an expert as one
    batch: (G, E', C, D)."""
    G, E, C, D = buf.shape
    with record_function(EXPERTS_RANGE):
        xe = buf.transpose(0, 1).reshape(E, G * C, D)
        act = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
        out = torch.bmm(act, wo)                            # (E', G*C, D)
    return out.view(E, G, C, D).transpose(0, 1)


def _combine(out_buf: torch.Tensor, row: torch.Tensor, r: Routing, dt
             ) -> torch.Tensor:
    """Each slot's row of ``out_buf`` (G, E, C, D) weighted by the gate of
    the kept slots, summed over the K slots of a token: (G, Tg, D)."""
    G, _, _, D = out_buf.shape
    Tg, K = r.expert_idx.shape[1:]
    y = out_buf.reshape(-1, D).index_select(0, row.reshape(-1)).view(
        G, Tg * K, D)
    gates = (r.gates.reshape(G, Tg * K) * r.keep).to(dt)
    y = y * gates[..., None]
    return torch.sum(y.view(G, Tg, K, D), dim=2)


def moe_apply(w: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, *, capacity_factor: Optional[float] = None,
              groups: Optional[int] = None, ctx: ShardCtx = UNSHARDED
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (the FFN's output (B, S, D) in x's dtype, the f32
    aux loss). ``w``: the layer's weights, the experts in x's dtype and
    ``ln2`` and ``router`` the f32 masters. ``groups`` (G, which must
    divide B) defaults to ``n_groups(ctx, B)``. DTensors on a mesh: see
    the module's docstring."""
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    B, Sq, D = x.shape
    G = n_groups(ctx, B) if groups is None else groups
    if isinstance(x, DTensor):
        return _moe_mesh(w, x, cfg, capacity_factor, G, ctx)
    dt = x.dtype
    Tg = B * Sq // G
    hf = rms_norm(x, w["ln2"], cfg.norm_eps).reshape(G, Tg, D)
    r = route(w["router"], hf, cfg, capacity_factor)
    if _RECORDED is not None:
        _RECORDED.append(r)
    buf, row = _dispatch(hf, r, cfg.moe.n_experts, dt)
    out_buf = _experts(buf, w["e_wg"], w["e_wi"], w["e_wo"])
    y = _combine(out_buf, row, r, dt)
    return y.reshape(B, Sq, D), r.aux.float()


def _moe_mesh(w, x, cfg: ModelConfig, capacity_factor: float, G: int,
              ctx: ShardCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on DTensors: each rank's groups on local tensors,
    the collectives as DTensor redistributions (the module's
    docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    B, Sq, D = x.shape
    dt = x.dtype
    h = normed(x, w["ln2"], cfg.norm_eps, ctx)              # (dp, None, None)
    mesh, hp = h.device_mesh, tuple(h.placements)
    split = math.prod(mesh.size(i) for i, p in enumerate(hp)
                      if p == Shard(0))
    if G % split or any(p not in (Replicate(), Shard(0)) for p in hp):
        raise ValueError(f"moe_apply: {G} groups of a batch laid out "
                         f"{hp} over a mesh of {tuple(mesh.shape)}: each "
                         "rank needs whole groups")
    whole = (Replicate(),) * mesh.ndim

    def over_ranks(t, placements):
        return DTensor.from_local(t, mesh, placements, run_check=False)

    n_tokens = B * Sq

    def mean(t):
        # the sum over this rank's groups and tokens, summed over the
        # batch's axes, over every token
        part = tuple(Partial() if p == Shard(0) else Replicate() for p in hp)
        return over_ranks(t.sum(dim=(0, 1)), part).redistribute(
            mesh, whole) / n_tokens

    hl = h.to_local()
    Gl, Tg = G // split, n_tokens // G
    hf = hl.reshape(Gl, Tg, D)
    r = route(local_view(w["router"], whole, hp), hf, cfg, capacity_factor,
              mean)
    if _RECORDED is not None:
        _RECORDED.append(r)
    buf, row = _dispatch(hf, r, cfg.moe.n_experts, dt)

    # the experts' layout on the model axis: each weight's dp axes gathered
    # (its gradient a partial sum over them)
    model = mesh.mesh_dim_names.index(ctx.tp)
    on_model = (w["e_wg"].placements[model] if mesh.size(model) > 1
                else Replicate())
    wg, wi, wo = (local_view(w[k], tuple(
        p if i == model else Replicate()
        for i, p in enumerate(w[k].placements)), hp)
        for k in ("e_wg", "e_wi", "e_wo"))
    buf = over_ranks(buf, hp)
    if on_model == Shard(0):        # expert parallel: this rank's experts
        mine = tuple(Shard(1) if i == model else p for i, p in enumerate(hp))
        out = over_ranks(_experts(buf.redistribute(mesh, mine).to_local(),
                                  wg, wi, wo), mine)
    elif on_model == Shard(2):      # d_ff split: partial sums over model
        part = tuple(Partial() if i == model else p for i, p in enumerate(hp))
        out = over_ranks(_experts(buf.to_local(grad_placements=part),
                                  wg, wi, wo), part)
    else:                           # every expert whole on every rank
        out = over_ranks(_experts(buf.to_local(), wg, wi, wo), hp)
    y = _combine(out.redistribute(mesh, hp).to_local(), row, r, dt)
    return (DTensor.from_local(y.reshape(hl.shape), mesh, hp,
                               run_check=False, shape=h.shape,
                               stride=h.stride()),
            r.aux.float())
