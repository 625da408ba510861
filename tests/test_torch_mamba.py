"""The port's Mamba mixer against the JAX package's, on the CPU, at the
reduced jamba's widths in f32 (d_model 64, d_inner 128, d_state 8, d_conv
4, dt_rank 4, chunk 16): the parallel path with its cache state
(``mamba_apply(return_state=True)``), the decode step, and the causal conv.
The JAX side's scan runs both ways, ``impl="xla"`` (the jnp oracle) and
``impl="pallas"`` (the Pallas kernel in interpret mode); the port's runs
the kernel's plain version, as it does on the CPU.

Tolerance: ``atol = rtol = 1e-5`` (outputs of order 1). The scans sum in
different orders (the port step by step, the oracle in chunks); the
largest difference seen here is below 1e-6 in the outputs and states.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import mamba as jax_mamba
from repro.sharding.ctx import ShardCtx

from repro_torch import kernels
from repro_torch.configs import MoEConfig, get_arch, reduced
from repro_torch.models import mamba, seeded_numpy_params

JAMBA = "jamba-1.5-large-398b"
CTX = ShardCtx(enabled=False)
TOL = 1e-5
B = 2


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, JAX layer params, port layer weights) of
    the reduced jamba's first layer (a Mamba mixer), without experts."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(JAMBA)),
                               moe=JaxMoEConfig())
    tcfg = dataclasses.replace(reduced(get_arch(JAMBA)), moe=MoEConfig())
    layer = {k: v[0] for k, v in seeded_numpy_params(tcfg, 5)["body"][0]
             .items()}
    assert "A_log" in layer
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in layer.items()},
            {k: torch.tensor(v) for k, v in layer.items()})


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=msg)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [1, 2, 16, 40])
def test_mamba_apply_and_state_match(setup, impl, s):
    """Output and cache state over S = 1 (shorter than the conv's history),
    2, one whole chunk and 2.5 chunks."""
    jcfg, tcfg, jp, tw = setup
    x = _x(tcfg, s, seed=s)
    want, want_state = jax_mamba.mamba_apply(jp, jnp.asarray(x), jcfg, CTX,
                                             impl=impl, return_state=True)
    kernels.reset_launches()
    got, state = mamba.mamba_apply(tw, torch.tensor(x), tcfg,
                                   return_state=True)
    assert kernels.LAUNCHES["selective_scan"] == 0      # the CPU path
    _close(got.numpy(), want, "out")
    assert sorted(state) == sorted(want_state) == ["conv", "ssm"]
    spec = mamba.mamba_cache_spec(tcfg, B)
    for name, t in state.items():
        assert (tuple(t.shape), t.dtype) == spec[name]
    _close(state["ssm"].numpy(), want_state["ssm"], "ssm")
    dc1 = tcfg.ssm.d_conv - 1
    conv = np.asarray(want_state["conv"])      # the JAX package keeps only
    _close(state["conv"][:, dc1 - conv.shape[1]:].numpy(), conv, "conv")
    assert not state["conv"][:, :dc1 - conv.shape[1]].any()  # S < dc - 1


def test_mamba_decode_matches(setup):
    jcfg, tcfg, jp, tw = setup
    s = 40
    x = _x(tcfg, s + 1, seed=9)
    _, jstate = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, :s]), jcfg, CTX,
                                      return_state=True)
    want, want_cache = jax_mamba.mamba_decode(jp, jnp.asarray(x[:, s:]),
                                              jstate, jcfg, CTX)
    _, cache = mamba.mamba_apply(tw, torch.tensor(x[:, :s]), tcfg,
                                 return_state=True)
    ssm = cache["ssm"]
    got, same = mamba.mamba_decode(tw, torch.tensor(x[:, s:]), cache, tcfg)
    assert same is cache and cache["ssm"] is ssm         # updated in place
    assert got.shape == (B, 1, tcfg.d_model)
    _close(got.numpy(), want, "decode out")
    for name in ("conv", "ssm"):
        _close(cache[name].numpy(), want_cache[name], name)


def test_decode_continues_the_parallel_path(setup):
    """The port's own invariant: the state of S tokens plus one decode
    step gives the last output and state of S + 1 tokens."""
    _, tcfg, _, tw = setup
    x = torch.tensor(_x(tcfg, 41, seed=4))
    want, want_state = mamba.mamba_apply(tw, x, tcfg, return_state=True)
    _, cache = mamba.mamba_apply(tw, x[:, :40], tcfg, return_state=True)
    got, cache = mamba.mamba_decode(tw, x[:, 40:], cache, tcfg)
    torch.testing.assert_close(got[:, 0], want[:, -1], rtol=TOL, atol=TOL)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(cache[name], want_state[name], rtol=TOL,
                                   atol=TOL)


def test_mamba_decode_matches_in_bf16(setup):
    """The decode step in bf16, cast where the JAX package casts (weights
    in bf16 but ``ln1`` and ``A_log``, the scan and the cache in f32):
    within bf16's 2e-2 of the JAX package's (3.9e-3 seen on outputs up to
    0.69, 3.0e-3 on the ssm state, the conv state equal)."""
    jcfg, tcfg, jp, tw = setup
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    s = 40
    x = _x(tcfg, s + 1, seed=6)
    _, jstate = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, :s], jnp.bfloat16),
                                      jcfg, CTX, return_state=True)
    want, want_cache = jax_mamba.mamba_decode(
        jp, jnp.asarray(x[:, s:], jnp.bfloat16), jstate, jcfg, CTX)
    w = {k: (v if k in ("ln1", "A_log") else v.to(torch.bfloat16))
         for k, v in tw.items()}
    cache = {k: torch.tensor(np.asarray(v)) for k, v in jstate.items()}
    got, cache = mamba.mamba_decode(
        w, torch.tensor(x[:, s:]).to(torch.bfloat16), cache, tcfg)
    assert got.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in cache.values())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_cache[name]), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("with_init", [False, True])
def test_causal_conv_matches(with_init):
    rng = np.random.default_rng(int(with_init))
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    w = rng.normal(size=(4, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    init = rng.normal(size=(2, 3, 32)).astype(np.float32) if with_init \
        else None
    want = jax_mamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if init is None else jnp.asarray(init))
    got = mamba._causal_conv(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b),
                             None if init is None else torch.tensor(init))
    # the same taps in the same order: equal bits
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
