"""The port's samplers on threefry key words (``utils/prng.py``) against
``jax.random``, for 20 keys and several shapes.

Bits, ``randint``, ``permutation`` and ``categorical`` must match
exactly; ``uniform`` within 1 ulp (it matches bit for bit here: XLA
fuses its scale and shift into one multiply-add, and the port rounds
that once as well). Two samplers pass through transcendental functions
whose last bits differ between XLA's CPU code and PyTorch's:

- ``gumbel`` is ``-log(-log(u))``: each ``log`` is within 1 ulp of
  XLA's, and the outer one maps those to an absolute error; it is held
  within 1 ulp of ``max(|g|, 1)`` (near ``g = 0`` an ulp of ``g`` itself
  is meaningless).
- ``normal`` is ``sqrt(2) erfinv(u)`` with XLA's f32 ``erfinv``
  polynomial copied; ``log1p`` in it differs by up to 2 ulps, which
  moves ``erfinv`` by at most 2 ulps and the normal by at most 3 over
  100,000 draws (``torch.special.erfinv`` would be 58 ulps away). It is
  held within ``NORMAL_ULPS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.utils import prng

SEEDS = range(20)
SHAPES = [(), (5,), (3, 7), (64,)]
NORMAL_ULPS = 4


def _key(seed):
    return jax.random.key(seed), torch.from_numpy(prng.key_words(seed))


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_key_words_are_jax_key_data():
    for seed in list(SEEDS) + [2**32 + 5, 123456789]:
        np.testing.assert_array_equal(
            prng.key_words(seed),
            np.asarray(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_exactly(shape):
    for seed in SEEDS:
        kj, kt = _key(seed)
        want = np.asarray(jax.random.bits(kj, shape)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits(kt, shape).numpy(),
                                      want)


@pytest.mark.parametrize("lo,hi", [(0, 4), (-3, 1000), (0, 1), (5, 5)])
def test_randint_matches_exactly(lo, hi):
    for seed in SEEDS:
        kj, kt = _key(seed)
        for shape in SHAPES:
            want = np.asarray(jax.random.randint(kj, shape, lo, hi))
            got = prng.randint(kt, shape, lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_batched_keys_draw_as_vmap():
    """(E, 2) key words draw one ``shape`` per key, as ``vmap``."""
    kj = jax.random.split(jax.random.key(3), 6)
    kt = torch.from_numpy(np.asarray(jax.random.key_data(kj)).astype(
        np.int64))
    np.testing.assert_array_equal(
        prng.randint(kt, (), 0, 4).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(kj)))
    np.testing.assert_array_equal(
        prng.random_bits(kt, (3,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (3,)))(kj)
                   ).astype(np.int64))
    np.testing.assert_array_equal(
        prng.split(kt, 3).numpy(),
        np.asarray(jax.random.key_data(
            jax.vmap(lambda k: jax.random.split(k, 3))(kj))))


@pytest.mark.parametrize("n", [1, 7, 256, 3000])
def test_permutation_matches_exactly(n):
    for seed in SEEDS:
        kj, kt = _key(seed)
        want = np.asarray(jax.random.permutation(kj, n))
        np.testing.assert_array_equal(prng.permutation(kt, n).numpy(), want)


@pytest.mark.parametrize("n_actions", [2, 9, 33])
def test_categorical_samples_equal(n_actions):
    rng = np.random.default_rng(n_actions)
    for seed in SEEDS:
        kj, kt = _key(seed)
        logits = rng.normal(size=(6, n_actions)).astype(np.float32)
        # one key per row, as the rollout draws
        keys = jax.random.split(kj, 6)
        want = jax.vmap(lambda lg, k: jax.random.categorical(k, lg))(
            jnp.asarray(logits), keys)
        got = prng.categorical(prng.split(kt, 6), torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # one key for the whole batch
        np.testing.assert_array_equal(
            prng.categorical(kt, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(kj, jnp.asarray(logits))))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 7.0),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_within_one_ulp(lo, hi):
    for seed in SEEDS:
        kj, kt = _key(seed)
        for shape in SHAPES:
            got = prng.uniform(kt, shape, lo, hi)
            assert got.dtype == torch.float32
            want = jax.random.uniform(kj, shape, minval=lo, maxval=hi)
            assert _ulps(got.numpy(), want).max(initial=0) <= 1


def test_gumbel_within_one_ulp_of_max_abs_one():
    for seed in SEEDS:
        kj, kt = _key(seed)
        for shape in SHAPES + [(4096,)]:
            got = prng.gumbel(kt, shape).numpy()
            want = np.asarray(jax.random.gumbel(kj, shape))
            scale = np.spacing(np.maximum(np.abs(want), 1.0)
                               .astype(np.float32))
            assert np.all(np.abs(got - want) <= scale)


def test_normal_within_the_stated_erfinv_distance():
    for seed in SEEDS:
        kj, kt = _key(seed)
        for shape in SHAPES + [(4096,)]:
            got = prng.normal(kt, shape)
            assert got.dtype == torch.float32
            want = jax.random.normal(kj, shape)
            assert _ulps(got.numpy(), want).max(initial=0) <= NORMAL_ULPS
    # the polynomial itself, on the normal's own uniform draws
    u = jax.random.uniform(jax.random.key(3), (100_000,),
                           minval=np.nextafter(np.float32(-1), np.float32(0)),
                           maxval=1.0)
    got = prng.erfinv(torch.from_numpy(np.array(u))).numpy()
    assert _ulps(got, jax.scipy.special.erfinv(u)).max() <= 2
    assert np.isinf(prng.erfinv(torch.tensor([1.0, -1.0])).numpy()).all()
