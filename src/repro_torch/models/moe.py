"""Top-k Mixture-of-Experts FFN with grouped scatter dispatch (the JAX
package's ``models/moe.py``, without its sharding context).

Tokens are reshaped into G groups (``groups``; the JAX package takes G =
its data-parallel degree, 1 unsharded); routing ranks and the capacity are
computed within each group. Each (token, k) slot goes to its expert's
buffer at its rank among that expert's slots of the group, token-major
with k inner; slots at rank >= C are dropped (the later tokens of a group
drop first) and add nothing.

Casts follow the JAX package: the router product, the softmax, the gates
and the load-balancing loss in f32 from the f32 router master; the
dispatch buffer, the SwiGLU experts and the combine in the compute dtype.
Nothing reads the device: the capacity C is a host int taken from shapes,
dropped slots scatter a zero to their expert's row 0 (as the JAX
package's ``.at[...].add``), and the combine gathers from the same rows.
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm

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


def top_k_desc(probs: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values in descending order, equal
    values by ascending index (the first k of a stable descending sort, on
    every device; ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
          capacity_factor: float) -> Routing:
    """Routing of the normed tokens ``h`` (G, Tg, D) by the f32 router
    master (D, E)."""
    G, Tg, _ = h.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    logits = h.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                   # (G, Tg, E)
    gate_vals, expert_idx = top_k_desc(probs, K)            # (G, Tg, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    experts = torch.arange(E, device=h.device)
    # load-balance aux loss (Switch): E * sum_e(mean prob_e * mean count_e)
    pe = probs.mean(dim=(0, 1))
    fe = (expert_idx[..., None] == experts).float().sum(dim=2).mean(
        dim=(0, 1))
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


def moe_apply(w: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, *, capacity_factor: Optional[float] = None,
              groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (the FFN's output (B, S, D) in x's dtype, the f32
    aux loss). ``w``: the layer's weights, the experts in x's dtype and
    ``ln2`` and ``router`` the f32 masters. ``groups`` must divide B * S."""
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    B, Sq, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dt = x.dtype
    G = groups
    Tg = B * Sq // G
    hf = rms_norm(x, w["ln2"], cfg.norm_eps).reshape(G, Tg, D)
    r = route(w["router"], hf, cfg, capacity_factor)
    if _RECORDED is not None:
        _RECORDED.append(r)
    C = r.capacity
    flat_e = r.expert_idx.reshape(G, Tg * K)
    safe_rank = torch.where(r.keep, r.rank, 0)

    # scatter into the grouped (G, E, C, D) buffer: kept slots each to a
    # row of their own, dropped slots a zero onto their expert's row 0
    hk = hf.repeat_interleave(K, dim=1)                     # (G, TgK, D)
    contrib = torch.where(r.keep[..., None], hk, 0).to(dt)
    gidx = torch.arange(G, device=x.device)[:, None]
    row = (gidx * E + flat_e) * C + safe_rank               # (G, TgK)
    buf = torch.zeros(G * E * C, D, dtype=dt, device=x.device).index_add(
        0, row.reshape(-1), contrib.reshape(-1, D))

    # expert FFN (SwiGLU), every group's C rows of an expert as one batch
    with record_function(EXPERTS_RANGE):
        xe = buf.view(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
        act = F.silu(torch.bmm(xe, w["e_wg"])) * torch.bmm(xe, w["e_wi"])
        out_buf = torch.bmm(act, w["e_wo"])                 # (E, G*C, D)
    out_buf = out_buf.view(E, G, C, D).transpose(0, 1).reshape(-1, D)

    # gather back and weight by the gates of the kept slots
    y = out_buf.index_select(0, row.reshape(-1)).view(G, Tg * K, D)
    gates = (r.gates.reshape(G, Tg * K) * r.keep).to(dt)
    y = y * gates[..., None]
    y = torch.sum(y.view(G, Tg, K, D), dim=2)
    return y.reshape(B, Sq, D), r.aux.float()
