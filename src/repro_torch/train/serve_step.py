"""Serving steps (the JAX package's ``train/serve_step.py``): prefill the
prompt into a cache, then decode one token per step, greedy by default.

``generate`` runs the decode steps as a Python loop: ``cache_len`` is a
Python int and the tokens stay on the device, so the loop never reads the
device (it runs under ``torch.cuda.set_sync_debug_mode("error")``).

With an enabled ``ctx`` (``sharding.ctx``) every step runs on a mesh: the
model's weights DTensors laid out by ``param_pspecs``, the prompt and the
fed tokens DTensors laid out by ``batch_pspecs`` (the dense family;
``models.model.check_mesh_serving``).
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional

import torch

from repro_torch.models.model import DecoderLM, decode_step, prefill
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) f32 logits -> (B, 1) int32 tokens: argmax (the first of equal
    maxima, as ``jnp.argmax``) or, with ``temperature > 0`` and a
    generator, a draw from softmax(logits / temperature). DTensor logits
    are made whole over the vocabulary first (split as the batch)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(logits, DTensor):
        logits = logits.redistribute(logits.device_mesh, tuple(
            Replicate() if p == Shard(1) else p for p in logits.placements))
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32)[:, None]


def make_prefill_step(model: DecoderLM, ctx: ShardCtx = UNSHARDED, *,
                      cache_seq_len: Optional[int] = None) -> Callable:
    """``step(tokens, extras=None) -> (logits (B, V) f32, cache)``: the
    prompt's prefill into a cache of ``cache_seq_len`` tokens (the
    prompt's length by default)."""
    def prefill_step(tokens, extras=None):
        return prefill(model, tokens, cache_seq_len=cache_seq_len,
                       extras=extras, ctx=ctx)

    return prefill_step


def make_decode_step(model: DecoderLM, ctx: ShardCtx = UNSHARDED, *,
                     temperature: float = 0.0) -> Callable:
    """``step(cache, tokens, cache_len, generator=None) -> (next tokens
    (B, 1) int32, logits (B, V) f32, cache)``."""
    def step(cache, tokens, cache_len: int, generator=None):
        logits, cache = decode_step(model, cache, tokens, cache_len, ctx)
        return _sample(logits, temperature, generator), logits, cache

    return step


def generate(model: DecoderLM, prompt: torch.Tensor, n_tokens: int, *,
             cache_seq_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             events: Optional[List] = None,
             extras: Optional[Mapping[str, torch.Tensor]] = None,
             ctx: ShardCtx = UNSHARDED) -> torch.Tensor:
    """Prefill ``prompt`` (B, S), then ``n_tokens - 1`` decode steps.
    Returns the (B, n_tokens) int32 tokens on the prompt's device; the
    first is the prefill's argmax, as in the JAX package. ``extras`` holds
    the memory a VLM or an encoder-decoder attends to (``"vision"`` or
    ``"audio"``, as in the JAX package's ``generate``), read at prefill.

    ``temperature > 0`` with a ``torch.Generator`` samples the decode steps
    with ``torch.multinomial``; its draws are not comparable with the JAX
    package's ``jax.random.categorical``, only greedy decoding is held to
    it. ``events``, if given, receives three CUDA events recorded at the
    start, after the prefill and at the end (timing without a sync).
    On a mesh (``ctx``) the prompt is a DTensor, each sampled token is
    laid out as the decode steps' tokens (``batch_pspecs``) and the
    result is whole on every rank.
    """
    B, S = prompt.shape
    cache_seq_len = cache_seq_len or (S + n_tokens)
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    logits, cache = make_prefill_step(model, ctx, cache_seq_len=cache_seq_len)(
        prompt, extras)
    tok = _fed(_sample(logits, 0.0, None), ctx)
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    step = make_decode_step(model, ctx, temperature=temperature)
    out = [tok]
    for i in range(n_tokens - 1):
        tok, _, cache = step(cache, tok, S + i, generator)
        tok = _fed(tok, ctx)
        out.append(tok)
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    if ctx.enabled:
        out = [t.full_tensor() for t in out]
    return torch.cat(out, dim=1)


def _fed(tok, ctx: ShardCtx):
    """A sampled token (B, 1) laid out as a decode step reads its tokens
    (``batch_pspecs``: over dp, or whole under ``"seq2d"``)."""
    if not ctx.enabled:
        return tok
    return ctx.constrain_raw(tok, (None if ctx.decode_kv_shard == "seq2d"
                                   else ctx.axis("dp"), None))
