"""JAX's threefry2x32 PRNG: key derivation and the samplers, on key words.

The port stores a PRNG key as JAX's two raw uint32 words (held in int64,
``key_words``). ``split`` and ``fold_in`` give the words that
``jax.random.key_data(jax.random.split(key, n))`` and
``jax.random.key_data(jax.random.fold_in(key, data))`` give for the same
key, with JAX's default (partitionable) threefry. Both take numpy integer
arrays or int64 torch tensors and return the same kind on the same device
(the arithmetic is ``+``, ``^``, ``<<``, ``>>`` and ``&`` on 64-bit
integers, kept to 32 bits), so a fleet derives its replicas' keys on the
card without reading a tensor on the host.

The samplers copy ``jax._src.random``'s transforms over the same bits:
``random_bits`` (partitionable threefry of the flat element index: the
two output words xored), ``uniform`` (the top 23 bits as a mantissa in
[1, 2), minus 1, scaled), ``randint`` (two bit draws from a split key,
combined modulo the span), ``gumbel`` (mode "low"), ``categorical`` (the
first argmax of gumbel noise plus the logits), ``permutation`` (rounds
of a stable sort by fresh bits) and ``normal`` (``sqrt(2) erfinv(u)``
with XLA's f32 ``erfinv`` polynomial). Each takes int64 torch key words
of shape (..., 2): a leading batch of keys draws ``shape`` once per key,
as ``vmap`` over the keys would. They run on the key's device with no
host sync; one call is one threefry pass, ~170 elementwise operations of
64-bit integer arithmetic.
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


def key_words(seed: int) -> np.ndarray:
    """The two raw words of ``jax.random.key(seed)`` with 64-bit mode off
    (the JAX package's default): the seed modulo 2**32 in the low word."""
    return np.array([0, int(seed) & _MASK], np.int64)


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


# ---------------------------------------------------------------- samplers
_F32_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)
_SQRT2 = float(np.float32(np.sqrt(2)))
# XLA's f32 erfinv (Giles' approximation): the polynomial in w for w < 5,
# then in sqrt(w) - 3 above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _key_tensor(key) -> torch.Tensor:
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64)
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _f32(x: float) -> float:
    return float(np.float32(x))


def random_bits(key, shape=()) -> torch.Tensor:
    """uint32 bits (in int64) of ``jax.random.bits(key, shape)``: shape
    ``key.shape[:-1] + shape``, one draw of ``shape`` per key."""
    words = _key_tensor(key)
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    counts = torch.arange(n, dtype=torch.int64,
                          device=words.device).reshape(shape)
    lead = words.shape[:-1]
    k1 = words[..., 0].reshape(lead + (1,) * len(shape))
    k2 = words[..., 1].reshape(lead + (1,) * len(shape))
    y0, y1 = threefry2x32(k1, k2, counts * 0, counts)
    return y0 ^ y1


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from uint32 bits: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1."""
    mant = (bits >> 9) | _F32_ONE_BITS
    return mant.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform(key, shape, minval=, maxval=)``. XLA fuses
    the scale and shift into one fused multiply-add; the product of two
    f32 values is exact in f64, so the f64 multiply-add rounds once, as
    the fused one does."""
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    unit = _unit(random_bits(key, shape)).to(torch.float64)
    return torch.clamp((unit * span + lo).to(torch.float32), min=lo)


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint(key, shape, minval, maxval)``: two draws
    from ``split(key)``, combined modulo the span (biased as JAX's is)."""
    words = _key_tensor(key)
    pair = split(words, 2)
    hi = random_bits(pair[..., 0, :], shape)
    lo = random_bits(pair[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(torch.int32)


def gumbel(key, shape=()) -> torch.Tensor:
    """f32 ``jax.random.gumbel(key, shape)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """int64 ``jax.random.categorical(key, logits)`` over the last axis:
    the first argmax of gumbel noise plus the logits. Keys with a leading
    batch (B, 2) draw one row of noise per key for logits (B, ..., A)."""
    words = _key_tensor(key).to(logits.device)
    noise = gumbel(words, tuple(logits.shape[words.dim() - 1:]))
    return torch.argmax(noise + logits, -1)


def permutation(key, n: int) -> torch.Tensor:
    """int64 ``jax.random.permutation(key, n)`` for one key's (2,) words:
    ``ceil(3 log n / log(2**32 - 1))`` rounds, each a stable sort of the
    values by fresh uint32 bits from a split key."""
    words = _key_tensor(key)
    x = torch.arange(n, dtype=torch.int64, device=words.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    for _ in range(rounds):
        pair = split(words, 2)
        words = pair[0]
        order = torch.sort(random_bits(pair[1], (n,)), stable=True).indices
        x = x.index_select(0, order)
    return x


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: Giles' polynomial, +-inf at +-1."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, _f32(a), _f32(b))
        p = c if p is None else c + p * w
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(key, shape=()) -> torch.Tensor:
    """f32 ``jax.random.normal(key, shape)``: ``sqrt(2) erfinv(u)``, u
    uniform in (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * erfinv(uniform(key, shape, lo, 1.0))
