"""The port's xLSTM cells and xlstm-125m against the JAX package's, on the
CPU, at reduced widths (``reduced()``: d_model 64, 4 heads, the mLSTM's
chunk 16, the M M M S pattern).

The cells take the same numpy inputs and the JAX package's
``init_params`` weights of one layer: ``mlstm_apply`` over prompts that
one chunk holds, that chunks divide and that leave a ragged last chunk
(the padded steps), with its final state; ``mlstm_decode`` and
``slstm_decode`` over several steps from those states; ``slstm_apply``
with its state. Then the whole reduced arch: prefill logits and every
cache leaf (``C``, ``n``, ``m``, ``conv`` and ``c``, ``n``, ``h``, ``m``),
decode steps, greedy generation, and prefill -> decode against the
longer prefill; the bf16 cells' casts against the JAX package's, ulp
by ulp; and the bf16 gate ``chip_smoke.py`` holds the full arch to
catches a zeroed state. Floats agree to ``rtol=1e-5`` (``atol=1e-5``
for values near zero), tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import xlstm as jx
from repro.models.model import decode_step as jax_decode_step
from repro.sharding.ctx import ShardCtx
from repro.train.serve_step import generate as jax_generate

from repro_torch import kernels
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import DecoderLM, init_params
from repro_torch.models import xlstm as tx
from repro_torch.models.model import (
    F32_LEAVES,
    decode_step,
    init_cache,
    prefill,
)
from repro_torch.train.serve_step import generate

ARCH = "xlstm-125m"
CTX = ShardCtx(enabled=False)
RTOL, ATOL = 1e-5, 1e-5
B = 2


@pytest.fixture(scope="module")
def arch():
    """(JAX config, port config, JAX params, port model)."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    tcfg = reduced(get_arch(ARCH))
    params = jax_init_params(jcfg, jax.random.key(0))
    model = lm_params_from_numpy(jax.device_get(params), tcfg, "cpu")
    return jcfg, tcfg, params, model


def _layer(params, p):
    """Layer ``p`` of the first superblock: JAX arrays and the port's
    weights (matrices in f32, as a f32 model holds them)."""
    jp = {k: v[0] for k, v in params["body"][p].items()}
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _x(cfg, s, seed=3):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [7, 16, 48, 41])
def test_mlstm_apply_matches(arch, s):
    """One chunk shorter than the chunk, one whole chunk, three chunks and
    a ragged last chunk (41 = 2 x 16 + 9): outputs and final states."""
    jcfg, tcfg, params, _ = arch
    jp, tp = _layer(params, 0)
    x = _x(tcfg, s)
    want, wstate = jx.mlstm_apply(jp, jnp.asarray(x), jcfg, CTX,
                                  return_state=True)
    got, state = tx.mlstm_apply(tp, torch.tensor(x), tcfg, return_state=True)
    _close(got.numpy(), want, "out")
    for name in ("C", "n", "m", "conv"):
        assert state[name].dtype == torch.float32
        _close(state[name].numpy(), wstate[name], name)


def test_mlstm_decode_continues_the_parallel_form(arch):
    """Decode steps from a prefill's state match the JAX package's, and
    each equals the parallel form's output at that position."""
    jcfg, tcfg, params, _ = arch
    jp, tp = _layer(params, 1)
    x = _x(tcfg, 23)
    full, _ = tx.mlstm_apply(tp, torch.tensor(x), tcfg, return_state=True)
    _, state = tx.mlstm_apply(tp, torch.tensor(x[:, :19]), tcfg,
                              return_state=True)
    _, jstate = jx.mlstm_apply(jp, jnp.asarray(x[:, :19]), jcfg, CTX,
                               return_state=True)
    for t in range(19, 23):
        want, jstate = jx.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                       jstate, jcfg, CTX)
        got, state = tx.mlstm_decode(tp, torch.tensor(x[:, t:t + 1]), state,
                                     tcfg)
        _close(got.numpy(), want, f"step {t}")
        for name in ("C", "n", "m", "conv"):
            _close(state[name].numpy(), jstate[name], f"step {t} {name}")
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("s", [1, 9])
def test_slstm_apply_and_decode_match(arch, s):
    """The sequential cell over S steps and its final state, then three
    decode steps from it."""
    jcfg, tcfg, params, _ = arch
    jp, tp = _layer(params, 3)
    x = _x(tcfg, s + 3, seed=s)
    want, jstate = jx.slstm_apply(jp, jnp.asarray(x[:, :s]), jcfg, CTX,
                                  return_state=True)
    got, state = tx.slstm_apply(tp, torch.tensor(x[:, :s]), tcfg,
                                return_state=True)
    _close(got.numpy(), want, "out")
    for t in range(s, s + 3):
        for name in ("c", "n", "h", "m"):
            _close(state[name].numpy(), jstate[name], f"{t} {name}")
        want, jstate = jx.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                       jstate, jcfg, CTX)
        got, state = tx.slstm_decode(tp, torch.tensor(x[:, t:t + 1]), state,
                                     tcfg)
        _close(got.numpy(), want, f"step {t}")


def _bf16_layer(params, p):
    """Layer ``p``'s weights as a bf16 model holds them: the JAX arrays,
    and the port's bf16 copies (``F32_LEAVES`` in f32). The biases, zero
    at init, and the norm scales, one at init, are drawn at random here,
    so that where they are cast shows."""
    rng = np.random.default_rng(p)
    jp = {}
    for k, v in params["body"][p].items():
        v = np.asarray(v[0])
        if k in ("b", "conv_b"):
            v = rng.normal(0, 0.5, v.shape).astype(np.float32)
        elif k.startswith("ln"):
            v = (1 + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        jp[k] = jnp.asarray(v)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jp, {k: v if k in F32_LEAVES else v.to(torch.bfloat16)
                for k, v in tp.items()}


def _bf16_close(got, want, msg):
    """bf16 ``got`` against ``want``: at least 99% of the elements equal
    bit for bit, the others within one bf16 ulp of the largest value."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    share = float((g == w).mean())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    assert share >= 0.99, f"{msg}: {share:.4f} of the elements equal"
    assert float(np.abs(g - w).max()) <= ulp, f"{msg}: past one ulp"


@pytest.mark.parametrize("p", [0, 3], ids=["mlstm", "slstm"])
def test_bf16_cells_follow_the_reference(arch, p, monkeypatch):
    """In a bf16 model each cell, on the same bf16 input and weights, casts
    where the JAX package does: a prefill of 41 steps (a ragged last
    chunk) and three decode steps from its state give the JAX package's
    bf16 outputs (99% or more of them bit for bit, the rest an ulp off:
    the f32 carries sum in another order) and its f32 states within
    ``rtol=1e-5``. A cast moved (k scaled in bf16: 45% equal; a bias added
    in bf16) changes many outputs by ulps. The JAX package's ``silu`` is
    taken in f32 and rounded once, as PyTorch's bf16 ``silu`` is: XLA's
    bf16 logistic on the CPU rounds a third of the elements an ulp away,
    which would hide such a cast. Whole models part further (the sLSTM's
    exp-stabilised recurrence carries one ulp of its gates to a few per
    cent of its state in 40 steps): ``tests/torch_bf16_distance.py``
    measures xlstm-125m's."""
    silu = jax.nn.silu
    monkeypatch.setattr(jax.nn, "silu",
                        lambda x: silu(x.astype(jnp.float32)).astype(x.dtype))
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in arch[:2])
    jp, tp = _bf16_layer(arch[2], p)
    cell = "mlstm" if p == 0 else "slstm"
    japply, jdecode = (getattr(jx, f"{cell}_{f}") for f in ("apply",
                                                            "decode"))
    tapply, tdecode = (getattr(tx, f"{cell}_{f}") for f in ("apply",
                                                            "decode"))
    x = _x(tcfg, 44)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.tensor(x).to(
        torch.bfloat16)
    want, jstate = japply(jp, xj[:, :41], jcfg, CTX, return_state=True)
    got, state = tapply(tp, xt[:, :41], tcfg, return_state=True)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, "prefill")
    for t in range(41, 44):
        for k in jstate:
            assert state[k].dtype == torch.float32
            torch.testing.assert_close(
                state[k], torch.tensor(np.asarray(jstate[k])), rtol=1e-5,
                atol=1e-6, msg=lambda m, k=k, t=t: f"{t} {k}: {m}")
        want, jstate = jdecode(jp, xj[:, t:t + 1], jstate, jcfg, CTX)
        got, state = tdecode(tp, xt[:, t:t + 1], state, tcfg)
        _bf16_close(got, want, f"step {t}")


def test_slstm_recurrence_mixes_heads_as_the_reference():
    """The recurrent term is (B, nh, 4 dh) per head, read as (B, 4D) before
    the split into gates: with one head's recurrent weights set, the other
    heads' gate columns move too (and exactly as in the JAX package)."""
    nh, dh, B_ = 4, 3, 2
    rng = np.random.default_rng(0)
    r = np.zeros((nh, dh, 4 * dh), np.float32)
    r[0] = rng.normal(size=(dh, 4 * dh))
    carry = [rng.normal(size=(B_, nh * dh)).astype(np.float32)
             for _ in range(4)]
    gx = rng.normal(size=(B_, 4 * nh * dh)).astype(np.float32)
    want = jx._slstm_cell({"r": jnp.asarray(r)}, jnp.asarray(gx),
                          tuple(jnp.asarray(c) for c in carry), nh, dh)
    got = tx._slstm_cell(torch.tensor(r), torch.tensor(gx),
                         tuple(torch.tensor(c) for c in carry), nh, dh)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    # head 0's recurrent output spans gate i's columns of heads 0-3 only
    rec = torch.einsum("bhd,hde->bhe", torch.tensor(carry[2]).reshape(
        B_, nh, dh), torch.tensor(r)).reshape(B_, 4 * nh * dh)
    assert rec[:, :4 * dh].abs().sum() > 0 and not rec[:, 4 * dh:].any()


def test_model_holds_the_reference_weights(arch):
    """Layer kinds M M M S, no FFN (d_ff 0), the weights the JAX package's
    tree holds; the sLSTM's ``r`` and ``b`` and ``ln_inner`` stay f32 in a
    bf16 model."""
    _, tcfg, params, model = arch
    assert [layer.kind for layer in model.layers] == [
        "mlstm", "mlstm", "mlstm", "slstm"]
    leaves = jax.device_get(params)
    for p, layer in enumerate(model.layers):
        src = {k: v[0] for k, v in leaves["body"][p].items()}
        assert sorted(dict(layer.named_parameters())) == sorted(src)
        assert "ln2" not in src
        for name, t in layer.named_parameters():
            np.testing.assert_array_equal(t.numpy(), src[name])
    m16 = DecoderLM.from_tree(dataclasses.replace(tcfg, dtype="bfloat16"),
                              jax.tree.map(torch.tensor, leaves))
    w = m16.layers[3].weights()
    assert {"r", "b", "ln_inner"} <= set(F32_LEAVES)
    assert w["r"].dtype == w["b"].dtype == w["ln_inner"].dtype == torch.float32
    assert w["w"].dtype == w["up"].dtype == torch.bfloat16


def _layer_caches(jax_cache, n_layers):
    return [{k: np.asarray(v[0]) for k, v in jax_cache["body"][i].items()}
            for i in range(n_layers)]


@pytest.mark.parametrize("s", [8, 40])
def test_prefill_logits_and_caches_match(arch, s):
    """S = 8 (one short chunk), S = 40 (a ragged third chunk)."""
    jcfg, tcfg, params, model = arch
    toks = np.random.default_rng(s).integers(0, tcfg.vocab, (B, s),
                                             dtype=np.int32)
    want, wcache = jax_prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                               CTX, cache_seq_len=s + 4)
    kernels.reset_launches()
    got, cache = prefill(model, torch.tensor(toks), cache_seq_len=s + 4)
    assert sum(kernels.LAUNCHES.values()) == 0
    _close(got.numpy(), want, "logits")
    for i, (g, w) in enumerate(zip(cache, _layer_caches(wcache,
                                                         tcfg.n_layers))):
        assert sorted(g) == sorted(w), i
        for name in w:
            assert tuple(g[name].shape) == w[name].shape, (i, name)
            _close(g[name].numpy(), w[name], f"layer {i} {name}")
    empty = init_cache(model, B, s + 4)
    assert [{k: (t.shape, t.dtype) for k, t in c.items()} for c in empty] \
        == [{k: (t.shape, t.dtype) for k, t in c.items()} for c in cache]


def test_decode_steps_match(arch):
    jcfg, tcfg, params, model = arch
    s, n = 40, 3
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (B, s + n),
                                             dtype=np.int32)
    _, jcache = jax_prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                            jcfg, CTX, cache_seq_len=s + n)
    _, cache = prefill(model, torch.tensor(toks[:, :s]), cache_seq_len=s + n)
    for i in range(s, s + n):
        want, jcache = jax_decode_step(params, jcache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i), jcfg, CTX)
        got, cache = decode_step(model, cache, torch.tensor(toks[:, i:i + 1]),
                                 i)
        _close(got.numpy(), want, f"step {i}")
    for i, (g, w) in enumerate(zip(cache, _layer_caches(jcache,
                                                        tcfg.n_layers))):
        for name in w:
            _close(g[name].numpy(), w[name], f"layer {i} {name}")


def test_greedy_generate_matches(arch):
    jcfg, tcfg, params, model = arch
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (B, 20),
                                             dtype=np.int32)
    want = jax.jit(lambda p, t: jax_generate(jcfg, p, t, 8, ctx=CTX))(
        params, jnp.asarray(toks))
    got = generate(model, torch.tensor(toks), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [40, 2])
def test_prefill_then_decode_matches_longer_prefill(arch, s):
    """Prefill S then decode token S against a prefill of S + 1 (the JAX
    package's ``tests/test_prefill_decode.py``); S = 2 is shorter than the
    mLSTM's 3 steps of conv history, which the port pads with zeros (the
    JAX package keeps 2 there and its decode step fails on the shapes)."""
    _, tcfg, _, model = arch
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, tcfg.vocab, (B, s + 1), dtype=np.int32))
    want, _ = prefill(model, toks, cache_seq_len=s + 1)
    _, cache = prefill(model, toks[:, :s], cache_seq_len=s + 1)
    assert cache[0]["conv"].shape == (B, 3, tcfg.ssm.expand * tcfg.d_model)
    got, _ = decode_step(model, cache, toks[:, s:], s)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_bf16_decode_bound_catches_a_wrong_state():
    """``chip_smoke.py`` holds xlstm-125m's bf16 decode step as it holds the
    hybrid's: within twice the bf16 prefill's distance from the f32
    model's logits (bf16 rounding in 12 layers of exp-stabilised
    recurrences moves both far past 2e-2; on the pinned case the JAX
    package's own bf16 prefill is 1.43 off its f32 one and the port's
    1.45, ``tests/torch_bf16_distance.py``). On the reduced arch the
    decode step meets that bound, and a zeroed mLSTM matrix memory, conv
    history or sLSTM cell state in one layer does not."""
    cfg = reduced(get_arch(ARCH))
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m32 = DecoderLM.from_tree(cfg, tree)
    m16 = DecoderLM.from_tree(dataclasses.replace(cfg, dtype="bfloat16"),
                              tree)
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 41), dtype=np.int32))
    truth, _ = prefill(m32, toks, cache_seq_len=41)
    bound = 2.0 * float((prefill(m16, toks, cache_seq_len=41)[0]
                         - truth).abs().max())

    def off(layer, name):
        _, cache = prefill(m16, toks[:, :40], cache_seq_len=41)
        if name:
            cache[layer][name].zero_()
        got, _ = decode_step(m16, cache, toks[:, 40:], 40)
        return float((got - truth).abs().max())

    assert off(0, None) <= bound
    for layer, name in ((0, "C"), (0, "conv"), (3, "c")):
        assert off(layer, name) > bound, (layer, name)
