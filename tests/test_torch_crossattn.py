"""The port's cross-attention against the JAX package's, on the CPU, at
reduced widths: the VLM (llama-3.2-vision-11b: a ``CROSS`` layer every
second layer, 16 vision tokens) and the encoder-decoder (whisper-small: 2
encoder layers over 24 audio frames, a cross-attention in every decoder
layer, the plain GELU MLP).

The weights are the JAX package's ``init_params``, with every ``xgate``
set to XGATE (at init it is 0, and ``tanh(0)`` removes the VLM's cross
path from the output); the memory is the same numpy draw in both
packages. Covered: a ``CROSS`` layer with its gate open, the gate's
effect on the logits, the encoder, the plain MLP, each arch's prefill
logits and every cache leaf (``xk``/``xv`` included), decode steps (which
never write ``xk``/``xv``), greedy generation, prefill -> decode against
the longer prefill, prompts both shorter and longer than the memory (the
cross-attention's Sq > Sk), a ``CROSS`` layer's self-attention left
unwindowed under a sliding-window config, and the serve CLI. Floats agree
to ``rtol=1e-5`` (``atol=1e-5`` near zero), tokens exactly. In bf16 (the
VLM, whisper and xlstm-125m) the prefill logits and caches are held to
the JAX package's bf16 ones in norm, against its own bf16 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import blocks as jax_blocks
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.sharding.ctx import ShardCtx
from repro.train.serve_step import generate as jax_generate

from repro_torch import kernels
from repro_torch.configs import acceptance as A
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import blocks, layers
from repro_torch.models.layers import rope_cos_sin
from repro_torch.models.model import (
    decode_step,
    encoder_forward,
    init_cache,
    prefill,
)
from repro_torch.models.spec import layout
from repro_torch.train.serve_step import generate

VLM, WHISPER = "llama-3.2-vision-11b", "whisper-small"
CTX = ShardCtx(enabled=False)
RTOL, ATOL = 1e-5, 1e-5
XGATE = 0.7
B = 2
BF16_FACTOR = 1.5


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module", params=[VLM, WHISPER])
def arch(request):
    """(JAX config, port config, JAX params, port model, numpy memory,
    numpy weights)."""
    name = request.param
    jcfg = jax_reduced(jax_get_arch(name))
    tcfg = reduced(get_arch(name))
    tree = A.open_xgate(_numpy(jax_init_params(jcfg,
                                                       jax.random.key(0))),
                        XGATE)
    params = jax.tree.map(jnp.asarray, tree)
    model = lm_params_from_numpy(tree, tcfg, "cpu")
    return jcfg, tcfg, params, model, A.lm_memory(tcfg, B), tree


def _numpy(params):
    """Writable numpy copies of a JAX parameter tree."""
    return jax.tree.map(np.array, params)


def _batch(toks, memory):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in memory.items()}}


def _extras(memory):
    return {k: torch.tensor(v) for k, v in memory.items()}


def _layer_caches(jax_cache, cfg):
    period, R, _ = layout(cfg)
    out = []
    for i in range(cfg.n_layers):
        entry = ({k: v[i // period]
                  for k, v in jax_cache["body"][i % period].items()}
                 if i < R * period else jax_cache["tail"][i - R * period])
        out.append({k: np.asarray(v) for k, v in entry.items()})
    return out


def _check_caches(cache, jax_cache, cfg):
    want = _layer_caches(jax_cache, cfg)
    assert len(cache) == len(want)
    for i, (g, w) in enumerate(zip(cache, want)):
        assert sorted(g) == sorted(w), i
        for name in w:
            assert tuple(g[name].shape) == w[name].shape, (i, name)
            _close(g[name].numpy(), w[name], f"layer {i} {name}")


def test_the_memory_reaches_the_layers_that_attend_to_it(arch):
    """The VLM's odd layers are ``CROSS`` (their cache holds the vision
    tokens' k, v); every whisper decoder layer carries ``xattn`` weights."""
    _, tcfg, _, model, memory, tree = arch
    kinds = [layer.kind for layer in model.layers]
    if tcfg.enc_dec:
        assert set(memory) == {"audio"} and model.encoder is not None
        assert kinds == ["attn"] * tcfg.n_layers
        assert all(sorted(dict(layer.xattn.named_parameters())) ==
                   ["lnx", "xk", "xo", "xq", "xv"] for layer in model.layers)
    else:
        assert set(memory) == {"vision"} and model.encoder is None
        assert kinds == ["attn", "cross"]
        assert all(layer.xattn is None for layer in model.layers)
    with pytest.raises(ValueError, match="memory"):
        prefill(model, torch.zeros(B, 4, dtype=torch.int32))


def test_cross_layer_with_an_open_gate_matches():
    """One ``CROSS`` layer (self-attention, the gated cross-attention onto
    the vision tokens, the MLP) with ``xgate`` = 0.7, on prompts shorter and
    longer than the 16 vision tokens: output and k, v, xk, xv."""
    jcfg = jax_reduced(jax_get_arch(VLM))
    tcfg = reduced(get_arch(VLM))
    tree = A.open_xgate(_numpy(jax_init_params(jcfg,
                                                       jax.random.key(1))),
                        XGATE)
    jp = {k: jnp.asarray(v[0]) for k, v in tree["body"][1].items()}
    tp = {k: torch.tensor(v[0]) for k, v in tree["body"][1].items()}
    assert float(tp["xgate"]) == np.float32(XGATE)
    mem = A.lm_memory(tcfg, B)["vision"]
    for s in (9, 21):
        x = np.random.default_rng(s).normal(
            size=(B, s, tcfg.d_model)).astype(np.float32)
        pos = np.arange(s)
        want, _, wkv = jax_blocks.block_parallel(
            jp, jnp.asarray(x), "cross", False, jcfg, CTX,
            positions=jnp.asarray(pos), memory=jnp.asarray(mem),
            return_kv=True)
        got, kv = blocks.block_parallel(
            tp, torch.tensor(x), "cross", False, tcfg,
            rope=rope_cos_sin(torch.tensor(pos), tcfg.hd, tcfg.rope_theta),
            memory=torch.tensor(mem), return_kv=True)
        _close(got.numpy(), want, f"S {s}")
        assert sorted(kv) == sorted(wkv) == ["k", "v", "xk", "xv"]
        for name in kv:
            _close(kv[name].numpy(), wkv[name], f"S {s} {name}")


def test_the_logits_move_with_the_gate():
    """With ``xgate`` 0 (the init) the vision tokens do not reach the
    logits; with it open they do, and the port follows the JAX package
    at both."""
    jcfg = jax_reduced(jax_get_arch(VLM))
    tcfg = reduced(get_arch(VLM))
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (B, 12),
                                             dtype=np.int32)
    mem = A.lm_memory(tcfg, B)
    other = {"vision": 10.0 * mem["vision"][::-1].copy()}
    logits = {}
    for gate in (0.0, XGATE):
        tree = A.open_xgate(_numpy(jax_init_params(
            jcfg, jax.random.key(0))), gate)
        model = lm_params_from_numpy(tree, tcfg, "cpu")
        for name, m in (("mem", mem), ("other", other)):
            got, _ = prefill(model, torch.tensor(toks), extras=_extras(m))
            want, _ = jax_model.prefill(jax.tree.map(jnp.asarray, tree),
                                        _batch(toks, m), jcfg, CTX)
            _close(got.numpy(), want, f"gate {gate} {name}")
            logits[gate, name] = got
    assert torch.equal(logits[0.0, "mem"], logits[0.0, "other"])
    assert float((logits[XGATE, "mem"] - logits[0.0, "mem"]).abs().max()) \
        > 1e-3
    assert float((logits[XGATE, "mem"] - logits[XGATE, "other"]).abs()
                 .max()) > 1e-3


def test_encoder_matches():
    """whisper's encoder: non-causal attention layers with RoPE over the
    frames, the plain MLP, the final norm."""
    jcfg = jax_reduced(jax_get_arch(WHISPER))
    tcfg = reduced(get_arch(WHISPER))
    tree = _numpy(jax_init_params(jcfg, jax.random.key(2)))
    model = lm_params_from_numpy(tree, tcfg, "cpu")
    frames = A.lm_memory(tcfg, B)["audio"]
    kernels.reset_launches()
    got = encoder_forward(model, torch.tensor(frames))
    assert kernels.LAUNCHES["flash_attn"] == 0
    want = jax_model.encoder_forward(jax.tree.map(jnp.asarray,
                                                  tree["encoder"]),
                                     jnp.asarray(frames), jcfg, CTX)
    assert got.shape == (B, tcfg.n_audio_frames, tcfg.d_model)
    _close(got.numpy(), want)
    # not causal: the last frame moves the first frame's state
    bumped = frames.copy()
    bumped[:, -1] += 1.0
    moved = encoder_forward(model, torch.tensor(bumped))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_plain_gelu_mlp_matches():
    """``gelu(h wi) wo2`` with the tanh approximation (``jax.nn.gelu``'s
    default), and the gated MLP beside it."""
    rng = np.random.default_rng(4)
    w = {"ln2": rng.normal(size=64).astype(np.float32),
         "wi": rng.normal(size=(64, 96)).astype(np.float32) / 8,
         "wg": rng.normal(size=(64, 96)).astype(np.float32) / 8,
         "wo2": rng.normal(size=(96, 64)).astype(np.float32) / 10}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    for gated in (False, True):
        want = jax_layers.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                                    jnp.asarray(x), gated=gated, eps=1e-5)
        got = layers.mlp_apply({k: torch.tensor(v) for k, v in w.items()},
                               torch.tensor(x), gated=gated, eps=1e-5)
        _close(got.numpy(), want, f"gated {gated}")


@pytest.mark.parametrize("s", [9, 30])
def test_prefill_logits_and_caches_match(arch, s):
    """Prompts shorter (9) and longer (30) than the memory (16 vision
    tokens, 24 audio frames)."""
    jcfg, tcfg, params, model, memory, _ = arch
    toks = np.random.default_rng(s).integers(0, tcfg.vocab, (B, s),
                                             dtype=np.int32)
    want, wcache = jax_model.prefill(params, _batch(toks, memory), jcfg, CTX,
                                     cache_seq_len=s + 4)
    kernels.reset_launches()
    got, cache = prefill(model, torch.tensor(toks), cache_seq_len=s + 4,
                         extras=_extras(memory))
    assert kernels.LAUNCHES["flash_attn"] == 0     # the CPU path
    _close(got.numpy(), want, "logits")
    _check_caches(cache, wcache, tcfg)
    empty = init_cache(model, B, s + 4)
    assert [{k: (t.shape, t.dtype) for k, t in c.items()} for c in empty] \
        == [{k: (t.shape, t.dtype) for k, t in c.items()} for c in cache]


def test_decode_steps_match_and_leave_the_memory(arch):
    """Three decode steps against the JAX package's; the cross caches
    ``xk``/``xv`` are the prefill's tensors, unchanged."""
    jcfg, tcfg, params, model, memory, _ = arch
    s, n = 20, 3
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (B, s + n),
                                             dtype=np.int32)
    _, jcache = jax_model.prefill(params, _batch(toks[:, :s], memory), jcfg,
                                  CTX, cache_seq_len=s + n)
    _, cache = prefill(model, torch.tensor(toks[:, :s]), cache_seq_len=s + n,
                       extras=_extras(memory))
    held = [{k: (c[k], c[k].clone()) for k in ("xk", "xv") if k in c}
            for c in cache]
    assert sum(len(h) for h in held) == 2 * (
        tcfg.n_layers if tcfg.enc_dec else 1)
    for i in range(s, s + n):
        want, jcache = jax_model.decode_step(
            params, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i),
            jcfg, CTX)
        got, cache = decode_step(model, cache, torch.tensor(toks[:, i:i + 1]),
                                 i)
        _close(got.numpy(), want, f"step {i}")
    _check_caches(cache, jcache, tcfg)
    for c, h in zip(cache, held):
        for k, (t, before) in h.items():
            assert c[k] is t and torch.equal(t, before)


def test_greedy_generate_matches(arch):
    jcfg, tcfg, params, model, memory, _ = arch
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (B, 18),
                                             dtype=np.int32)
    ex = {k: jnp.asarray(v) for k, v in memory.items()}
    want = jax.jit(lambda p, t, e: jax_generate(jcfg, p, t, 8, ctx=CTX,
                                                extras=e))(
        params, jnp.asarray(toks), ex)
    got = generate(model, torch.tensor(toks), 8, extras=_extras(memory))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_longer_prefill(arch, dtype):
    """The JAX package's ``tests/test_prefill_decode.py`` invariant, at
    its tolerances (f32 1e-4, bf16 2e-2)."""
    _, tcfg, _, model, memory, tree = arch
    if dtype == "bfloat16":
        model = lm_params_from_numpy(tree, dataclasses.replace(
            tcfg, dtype=dtype), "cpu")
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, tcfg.vocab, (B, 31), dtype=np.int32))
    ex = _extras(memory)
    want, _ = prefill(model, toks, cache_seq_len=31, extras=ex)
    _, cache = prefill(model, toks[:, :30], cache_seq_len=31, extras=ex)
    got, _ = decode_step(model, cache, toks[:, 30:], 30)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch_name", [VLM, WHISPER, "xlstm-125m"])
def test_bf16_prefill_and_caches_match_the_reference(arch_name):
    """In bf16 both packages, on the same weights and memory, give prefill
    logits and cache leaves no farther apart (in norm) than BF16_FACTOR
    times the JAX package's own bf16 result from its f32 one: each
    package rounds its bf16 ops its own way (XLA's bf16 logistic and GELU
    on the CPU round elements an ulp away from PyTorch's, attention and
    the xLSTM's recurrences carry such ulps on), so the two bf16 results
    part about as far as bf16 parts from f32 (ratios up to 1.0 here). A cast
    that dropped a leaf to bf16 or held it in the wrong dtype shows in the
    dtypes checked; ``test_torch_xlstm.py`` holds the xLSTM cells' casts
    ulp by ulp."""
    jcfg = jax_reduced(jax_get_arch(arch_name))
    tcfg = reduced(get_arch(arch_name))
    tree = A.open_xgate(_numpy(jax_init_params(jcfg, jax.random.key(0))),
                        XGATE)
    params = jax.tree.map(jnp.asarray, tree)
    memory = A.lm_memory(tcfg, B)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (B, 30),
                                             dtype=np.int32)
    ref = {}
    for dtype in ("float32", "bfloat16"):
        logits, cache = jax_model.prefill(
            params, _batch(toks, memory),
            dataclasses.replace(jcfg, dtype=dtype), CTX, cache_seq_len=32)
        ref[dtype] = (np.asarray(logits), _layer_caches(
            cache, tcfg))
    t16 = dataclasses.replace(tcfg, dtype="bfloat16")
    got, cache = prefill(lm_params_from_numpy(tree, t16, "cpu"),
                         torch.tensor(toks), cache_seq_len=32,
                         extras=_extras(memory))
    (w16, c16), (w32, c32) = ref["bfloat16"], ref["float32"]
    assert _rel(got.numpy(), w16) <= BF16_FACTOR * _rel(w16, w32)
    for i, (g, w, f) in enumerate(zip(cache, c16, c32)):
        assert sorted(g) == sorted(w), i
        for name in w:
            assert str(g[name].dtype).split(".")[-1] == str(w[name].dtype), (
                i, name)
            a, b = g[name].float().numpy(), w[name].astype(np.float32)
            assert _rel(a, b) <= BF16_FACTOR * _rel(b, f[name]), (i, name)


@pytest.mark.parametrize("arch_name", [VLM, WHISPER, "xlstm-125m"])
def test_serve_cli_serves_the_arch_on_the_cpu(arch_name, capsys):
    """The CLI builds the reduced arch, draws its memory and generates."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch_name, "--reduced", "--batch", "2",
                      "--prompt-len", "12", "--gen", "4", "--iters", "1",
                      "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert bool(((out >= 0)
                 & (out < reduced(get_arch(arch_name)).vocab)).all())
    assert f"arch={arch_name}" in capsys.readouterr().out


def test_cross_layer_self_attention_ignores_the_window(monkeypatch):
    """A VLM config with a sliding window and no block pattern: the JAX
    package windows the self-attention of its plain layers and not that
    of its ``CROSS`` layers. The port does the same, and differs from a
    port that windowed both."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(VLM)), swa_window=8)
    tcfg = dataclasses.replace(reduced(get_arch(VLM)), swa_window=8)
    tree = A.open_xgate(_numpy(jax_init_params(jcfg, jax.random.key(1))),
                        XGATE)
    params = jax.tree.map(jnp.asarray, tree)
    model = lm_params_from_numpy(tree, tcfg, "cpu")
    memory = A.lm_memory(tcfg, B)
    s = 20
    toks = np.random.default_rng(8).integers(0, tcfg.vocab, (B, s),
                                             dtype=np.int32)
    want, wcache = jax_model.prefill(params, _batch(toks, memory), jcfg, CTX,
                                     cache_seq_len=s)
    got, cache = prefill(model, torch.tensor(toks), cache_seq_len=s,
                         extras=_extras(memory))
    _close(got.numpy(), want, "logits")
    _check_caches(cache, wcache, tcfg)
    monkeypatch.setattr(blocks, "self_window", blocks.layer_window)
    both, _ = prefill(model, torch.tensor(toks), cache_seq_len=s,
                      extras=_extras(memory))
    assert float((both - got).abs().max()) > 1e-3
