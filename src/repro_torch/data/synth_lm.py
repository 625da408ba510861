"""The deterministic, host-shardable synthetic LM corpus (the JAX
package's ``data/synth_lm.py``), token for token.

Tokens are drawn from a Zipfian distribution (``jax.random.categorical``
over ``_zipf_logits``) with the counter-based PRNG keyed on (seed, step,
host), so a restart resumes exactly at any step on any host layout with
no state beyond the step number. The draw is ``utils.prng``'s threefry,
bit for bit the JAX package's: the Gumbel noise of element (row, token)
of the (local * (S + 1), vocab) draw comes from counter ``row * vocab +
token``, so the rows are drawn a block at a time (``BLOCK_VALUES`` values
a block) and equal the whole draw: at gemma3-1b's vocabulary a batch of
2 x 1025 rows is 537M values, ~4 GB for each of the draw's int64
temporaries if made at once.

A model with a memory gets its extras (``vision``, ``audio``) as ``0.02 *
normal`` from ``fold_in(key, hash(name) % 2**31)``, as the JAX package
draws them. ``hash`` of a ``str`` is salted per Python process (unless
``PYTHONHASHSEED`` is set), so the extras agree with the JAX package's
only within one process, and differ between two runs.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

BLOCK_VALUES = 1 << 24     # Gumbel values drawn at once


def _zipf_logits(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks**alpha
    return np.log(p / p.sum()).astype(np.float32)


def _categorical_rows(key, logits: torch.Tensor, rows: int) -> torch.Tensor:
    """int64 (rows,) ``jax.random.categorical(key, logits, shape=(rows,))``
    for one key's words and (V,) logits: the first argmax of Gumbel noise
    plus the logits, as many rows at a time as fit in BLOCK_VALUES."""
    vocab = logits.shape[-1]
    words = torch.as_tensor(np.asarray(key), dtype=torch.int64,
                            device=logits.device)
    block = max(1, BLOCK_VALUES // vocab)
    out = []
    for r0 in range(0, rows, block):
        n = min(block, rows - r0)
        noise = prng.gumbel(words, (n, vocab), offset=r0 * vocab)
        out.append(torch.argmax(noise + logits, -1))
    return torch.cat(out)


def lm_batch_at(step: int, *, vocab: int, batch: int, seq_len: int,
                seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                extras: Optional[Dict[str, tuple]] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """The (deterministic) global batch slice owned by ``host_id`` at
    ``step``: ``tokens`` and ``labels`` (batch / n_hosts, seq_len) int32,
    labels the tokens shifted by one, and each of ``extras`` (name ->
    shape after the batch axis) f32; drawn on ``device`` (the card by
    default)."""
    if batch % n_hosts:
        raise ValueError(f"batch {batch} does not split over {n_hosts} "
                         "hosts")
    dev = resolve_device(device)
    local = batch // n_hosts
    key = prng.fold_in(prng.fold_in(prng.key_words(seed), step), host_id)
    logits = torch.from_numpy(_zipf_logits(vocab)).to(dev)
    toks = _categorical_rows(key, logits, local * (seq_len + 1)).reshape(
        local, seq_len + 1)
    out = {"tokens": toks[:, :-1].to(torch.int32),
           "labels": toks[:, 1:].to(torch.int32)}
    for name, shape in (extras or {}).items():
        ek = torch.as_tensor(prng.fold_in(key, hash(name) % (2**31)),
                             device=dev)
        out[name] = 0.02 * prng.normal(ek, (local,) + tuple(shape))
    return out


def lm_batches(start_step: int = 0, **kw) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield lm_batch_at(step, **kw)
        step += 1
