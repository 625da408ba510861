"""JAX's threefry2x32 PRNG key derivation: ``split`` and ``fold_in``.

The port stores a PRNG key as JAX's two raw uint32 words (held in int64,
``core.state.key_words``). ``split`` and ``fold_in`` give the words that
``jax.random.key_data(jax.random.split(key, n))`` and
``jax.random.key_data(jax.random.fold_in(key, data))`` give for the same
key, with JAX's default (partitionable) threefry. Both take numpy integer
arrays or int64 torch tensors and return the same kind on the same device
(the arithmetic is ``+``, ``^``, ``<<``, ``>>`` and ``&`` on 64-bit
integers, kept to 32 bits), so a fleet derives its replicas' keys on the
card without reading a tensor on the host.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k1, k2), all uint32 values in 64-bit integers."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _as_words(key):
    """(key words as int64, stack) for numpy arrays or torch tensors."""
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64), torch.stack
    return np.asarray(key).astype(np.int64), np.stack


def split(key, n: int):
    """(n, 2) words of ``jax.random.split(key, n)`` for one key's (2,)
    words."""
    words, stack = _as_words(key)
    if isinstance(words, torch.Tensor):
        lo = torch.arange(n, dtype=torch.int64, device=words.device)
    else:
        lo = np.arange(n, dtype=np.int64)
    y0, y1 = threefry2x32(words[..., 0:1], words[..., 1:2], lo * 0, lo)
    return stack([y0, y1], -1)


def fold_in(key, data: int):
    """Words of ``jax.random.fold_in(key, data)`` for (..., 2) key words
    (each key on its own), ``data`` a uint32."""
    words, stack = _as_words(key)
    y0, y1 = threefry2x32(words[..., 0], words[..., 1], words[..., 0] * 0,
                          words[..., 0] * 0 + (int(data) & _MASK))
    return stack([y0, y1], -1)
