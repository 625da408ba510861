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
of a stable sort by fresh bits), ``normal`` (``sqrt(2) erfinv(u)``
with XLA's f32 ``erfinv`` polynomial) and ``exponential``
(``-log1p(-u)`` with XLA's CPU ``log1p``, ``log1p_f32``, bit for bit).
Each takes int64 torch key words
of shape (..., 2): a leading batch of keys draws ``shape`` once per key,
as ``vmap`` over the keys would. They run on the key's device with no
host sync; one call is one threefry pass, ~170 elementwise operations of
64-bit integer arithmetic.
"""

from __future__ import annotations

import struct

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


def random_bits(key, shape=(), offset: int = 0) -> torch.Tensor:
    """uint32 bits (in int64) of ``jax.random.bits(key, shape)``: shape
    ``key.shape[:-1] + shape``, one draw of ``shape`` per key. With
    ``offset``, the bits of the elements ``offset, offset + 1, ...`` (flat,
    row-major) of a larger draw from the same key: a draw taken a block of
    rows at a time equals the whole one. Flat indices stay below 2**32
    (the counter's high word is 0)."""
    words = _key_tensor(key)
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    if offset + n > 2**32:
        raise ValueError(f"random_bits: elements up to {offset + n} need "
                         "the counter's high word")
    counts = torch.arange(offset, offset + n, dtype=torch.int64,
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
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """f32 ``jax.random.uniform(key, shape, minval=, maxval=)``. XLA fuses
    the scale and shift into one fused multiply-add; the product of two
    f32 values is exact in f64, so the f64 multiply-add rounds once, as
    the fused one does. ``offset`` as in ``random_bits``."""
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    unit = _unit(random_bits(key, shape, offset)).to(torch.float64)
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


def gumbel(key, shape=(), offset: int = 0) -> torch.Tensor:
    """f32 ``jax.random.gumbel(key, shape)`` (mode "low"); ``offset`` as
    in ``random_bits``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, offset)))


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


# XLA's CPU f32 log1p (jax 0.9.0, x86-64): the Cephes rational form below
# |x| < sqrt(2) - 1, else Eigen's logf of 1 + x, with the compiled code's
# fused multiply-adds. Constants are the f32 values of the compiled code,
# given as the bits of the doubles that hold them.
def _c(hexbits: str) -> float:
    return struct.unpack(">d", bytes.fromhex(hexbits))[0]


_LOG_SQRTHF = _c("3FE6A09E60000000")
_LOG_P = tuple(_c(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_Q1, _LOG_Q2 = _c("BF2BD01060000000"), _c("3FE6300000000000")
_LOG1P_SMALL = _c("3FDA8279A0000000")
_LOG1P_DEN = tuple(_c(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_LOG1P_NUM = tuple(_c(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000"))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` as a fused multiply-add: the product of two f32
    values is exact in f64, the sum is rounded in f64 and then to f32.
    ``a`` may already be f64; ``b`` and ``c`` are f64/f32 tensors or
    Python floats holding f32 values. (Rounding twice can differ from a
    true fused multiply-add on an f32 midpoint; ``log1p_f32`` is proven
    against XLA on every input ``exponential`` can give it.)"""
    a = a if a.dtype == torch.float64 else a.double()
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a * b + c).float()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add gives it
    (XLA's CPU code fuses a product into the sum that reads it), from
    IEEE operations in f64: the product is exact, the sum's rounding error
    is recovered exactly (TwoSum), and where the f64 sum is an f32 tie
    that error decides the side. For results in the f32 normal range."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    wrong = tie & ((r.double() - s) * err < 0.0)
    return torch.where(wrong, torch.nextafter(
        r, torch.where(err > 0.0, float("inf"), float("-inf"))), r)


def _logf(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log (Eigen's ``plog``): the exponent split off, the
    mantissa reduced to [sqrt(1/2), sqrt(2)), a degree-9 polynomial."""
    bits = torch.clamp(y, min=_TINY).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    x = (m + -1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = x * x
    x3 = (x2 * x).double()
    x64 = x.double()
    p = _LOG_P
    ya = _fma(x64, _fma(x64, p[0], p[1]), p[2])
    yb = _fma(x64, _fma(x64, p[3], p[4]), p[5])
    yc = _fma(x64, _fma(x64, p[6], p[7]), p[8])
    ya = _fma(x3, _fma(x3, ya, yb), yc)
    ya = _fma(x3, ya, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, _fma(x2, -0.5, x64) + ya)
    r = torch.where(y > 0.0, r, float("nan"))
    r = torch.where(y == 0.0, float("-inf"), r)
    return torch.where(y == float("inf"), y, r)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log1p`` with the bits of XLA's CPU ``log1p`` (jax 0.9.0):
    the same operations in the same order, each fused multiply-add
    rounded once (``_fma``). Unlike ``torch.log1p`` it gives the same bits
    on the CPU and the card."""
    x64 = x.double()
    den = torch.ones_like(x)
    for c in _LOG1P_DEN:
        den = _fma(x64, den, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(x64, num, c)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x2 * x) * (num / den))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small,
                       _logf(x + 1.0))


def exponential(key, shape=()) -> torch.Tensor:
    """f32 ``jax.random.exponential(key, shape)``: ``-log1p(-u)``, u
    uniform in [0, 1), bit for bit (u takes the 2**23 values k * 2**-23,
    each of which ``log1p_f32`` is proven on)."""
    return -log1p_f32(-uniform(key, shape))
