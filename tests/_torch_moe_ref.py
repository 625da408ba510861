"""The JAX package's MoE routing, for the port's MoE tests.

``repro.models.moe.moe_apply`` returns only its output and aux loss. These
helpers recompute its routing from its own functions, line by line as it
computes it (rms_norm, the f32 router product, softmax, ``lax.top_k``,
the exclusive cumsum of the one-hot, ``round_up``), so that the tests can
hold the port's chosen experts and dropped slots to the JAX package's
exactly.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

import repro.models.blocks as jax_blocks
from repro.models import moe as jax_moe
from repro.models.layers import rms_norm as jax_rms_norm


def jax_routing(params, x, cfg, capacity_factor=None, groups: int = 1):
    """(expert of each (token, k) slot (G, Tg, K), kept slots (G, Tg * K),
    capacity C) of the JAX package's ``moe_apply(params, x, cfg, ctx)``
    with ``ctx``'s G = ``groups``; traceable."""
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    h = jax_rms_norm(jnp.asarray(x), jnp.asarray(params["ln2"]),
                     cfg.norm_eps)
    B, S, D = h.shape
    Tg = B * S // groups
    hf = h.reshape(groups, Tg, D)
    probs = jax.nn.softmax(hf.astype(jnp.float32)
                           @ jnp.asarray(params["router"]).astype(
                               jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    flat_e = idx.reshape(groups, Tg * K)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=1) - onehot
    rank = jnp.take_along_axis(ranks, flat_e[..., None], axis=2)[..., 0]
    C = jax_moe.round_up(int(capacity_factor * Tg * K / E) or 1, 8)
    return idx, rank < C, C


@contextlib.contextmanager
def jax_dropped_slots():
    """Inside the block, every ``moe_apply`` call of the JAX package's
    blocks (prefill and decode, jitted or not) also reports the slots it
    dropped: the yielded list receives one int per call, in call order
    (call ``jax.effects_barrier()`` before reading it)."""
    real = jax_blocks.moe_apply
    counts: list = []

    def spy(params, x, cfg, ctx, *, capacity_factor=None):
        out = real(params, x, cfg, ctx, capacity_factor=capacity_factor)
        _, keep, _ = jax_routing(params, x, cfg, capacity_factor,
                                 jax_moe._n_groups(ctx, x.shape[0]))
        jax.debug.callback(lambda n: counts.append(int(np.asarray(n))),
                           jnp.sum(~keep), ordered=True)
        return out

    jax_blocks.moe_apply = spy
    try:
        yield counts
    finally:
        jax_blocks.moe_apply = real
