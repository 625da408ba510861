"""The port's dense LMs against the JAX package's, on the CPU.

Reduced configs (same block structure, narrow widths) of the dense archs;
the weights are the JAX package's ``init_params``, carried across with
``interop.lm_params_from_numpy``. The JAX side runs its serving path with
``attention_impl="pallas"`` (the flash-attention kernel in interpret
mode); the port's runs the kernel's plain version, as it does on the CPU.
Floats agree to ``rtol=1e-5`` (with ``atol=1e-5`` for values near zero:
logits and the qk-normed caches are of order 1), tokens exactly.
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
from repro.models.model import decode_step as jax_decode_step
from repro.models.spec import model_param_specs as jax_param_specs
from repro.sharding.ctx import ShardCtx
from repro.train.serve_step import generate as jax_generate

from repro_torch import kernels
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import (
    DecoderLM,
    count_params_analytic,
    init_params,
    model_param_specs,
    seeded_numpy_params,
)
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.models.spec import layout
from repro_torch.train.serve_step import generate

CTX = ShardCtx(enabled=False, attention_impl="pallas")
RTOL, ATOL = 1e-5, 1e-5
DENSE = ["gemma3-1b", "qwen3-4b", "granite-3-8b", "internlm2-20b"]
# (arch, overrides): gemma's window 16 makes the ring and the window bind
# at S = 48; its default window (512) leaves them unbound
CASES = [
    ("gemma3-1b", {}),
    ("gemma3-1b", {"swa_window": 16}),
    ("qwen3-4b", {}),
    ("granite-3-8b", {}),
    ("internlm2-20b", {}),
]
IDS = [a + ("-swa16" if o else "") for a, o in CASES]
B, S = 2, 48


def _configs(arch, overrides):
    jcfg = jax_reduced(jax_get_arch(arch))
    tcfg = reduced(get_arch(arch))
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """(JAX config, port config, JAX params, port model, tokens)."""
    jcfg, tcfg = _configs(*request.param)
    params = jax_init_params(jcfg, jax.random.key(0))
    model = lm_params_from_numpy(jax.device_get(params), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S + 1),
                                             dtype=np.int32)
    return jcfg, tcfg, params, model, toks


def _layer_caches(jax_cache, cfg):
    """The JAX package's stacked cache as one {'k', 'v'} per layer."""
    period, R, n_tail = layout(cfg)
    out = []
    for i in range(cfg.n_layers):
        if i < R * period:
            entry = {k: v[i // period]
                     for k, v in jax_cache["body"][i % period].items()}
        else:
            entry = jax_cache["tail"][i - R * period]
        out.append({k: np.asarray(v) for k, v in entry.items()})
    return out


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _check_caches(port_cache, jax_cache, cfg):
    want = _layer_caches(jax_cache, cfg)
    assert len(port_cache) == len(want) == cfg.n_layers
    for i, (p, j) in enumerate(zip(port_cache, want)):
        for name in ("k", "v"):
            assert tuple(p[name].shape) == j[name].shape, (i, name)
            _close(p[name].numpy(), j[name], f"layer {i} {name}")


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_configs_and_param_specs_match(arch):
    for full in (True, False):
        jcfg = jax_get_arch(arch)
        tcfg = get_arch(arch)
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        want = jax.tree.map(lambda s: tuple(s.shape), jax_param_specs(jcfg))
        assert model_param_specs(tcfg) == want
        assert tcfg.param_count() == count_params_analytic(tcfg) \
            == jcfg.param_count()


def test_repeat_kv_matches():
    from repro.models.layers import repeat_kv as jax_repeat_kv

    from repro_torch.models.layers import repeat_kv

    x = np.random.default_rng(0).normal(size=(2, 5, 2, 8)).astype(np.float32)
    for n_rep in (1, 3):
        np.testing.assert_array_equal(
            repeat_kv(torch.tensor(x), n_rep).numpy(),
            np.asarray(jax_repeat_kv(jnp.asarray(x), n_rep)))


def test_gemma3_1b_parameter_count():
    assert count_params_analytic(get_arch("gemma3-1b")) == 999_826_048


def test_model_holds_the_reference_weights(case):
    jcfg, tcfg, params, model, _ = case
    period, R, _ = layout(tcfg)
    leaves = jax.device_get(params)
    np.testing.assert_array_equal(model.emb.numpy(), leaves["emb"])
    for i, layer in enumerate(model.layers):
        src = (({k: v[i // period] for k, v in
                 leaves["body"][i % period].items()})
               if i < R * period else leaves["tail"][i - R * period])
        assert sorted(dict(layer.named_parameters())) == sorted(src)
        for name, p in layer.named_parameters():
            np.testing.assert_array_equal(p.numpy(), src[name])


def test_prefill_logits_and_caches_match(case):
    jcfg, tcfg, params, model, toks = case
    cache_len = S + 16
    want_logits, want_cache = jax_prefill(
        params, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, CTX,
        cache_seq_len=cache_len)
    kernels.reset_launches()
    got_logits, got_cache = prefill(model, torch.tensor(toks[:, :S]),
                                    cache_seq_len=cache_len)
    assert kernels.LAUNCHES["flash_attn"] == 0    # the CPU path
    assert got_logits.dtype == torch.float32
    _close(got_logits.numpy(), want_logits, "prefill logits")
    _check_caches(got_cache, want_cache, tcfg)
    empty = init_cache(model, B, cache_len)
    assert [{k: (t.shape, t.dtype) for k, t in c.items()} for c in empty] \
        == [{k: (t.shape, t.dtype) for k, t in c.items()} for c in got_cache]
    assert all(not t.any() for c in empty for t in c.values())


def test_decode_step_matches(case):
    jcfg, tcfg, params, model, toks = case
    _, jcache = jax_prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                            jcfg, CTX, cache_seq_len=S + 1)
    want, want_cache = jax_decode_step(params, jcache,
                                       jnp.asarray(toks[:, S:S + 1]),
                                       jnp.int32(S), jcfg, CTX)
    _, cache = prefill(model, torch.tensor(toks[:, :S]), cache_seq_len=S + 1)
    got, cache = decode_step(model, cache, torch.tensor(toks[:, S:S + 1]), S)
    _close(got.numpy(), want, "decode logits")
    _check_caches(cache, want_cache, tcfg)


def test_greedy_generate_matches(case):
    jcfg, tcfg, params, model, toks = case
    n = 16
    want = jax.jit(lambda p, t: jax_generate(jcfg, p, t, n, ctx=CTX))(
        params, jnp.asarray(toks[:, :S]))
    got = generate(model, torch.tensor(toks[:, :S]), n)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_then_decode_matches_longer_prefill(case):
    """The port's own invariant (the JAX package's
    ``tests/test_prefill_decode.py``): prefill S tokens then decode token S
    gives the logits of a prefill of S + 1 tokens."""
    _, _, _, model, toks = case
    want, _ = prefill(model, torch.tensor(toks), cache_seq_len=S + 1)
    _, cache = prefill(model, torch.tensor(toks[:, :S]), cache_seq_len=S + 1)
    got, _ = decode_step(model, cache, torch.tensor(toks[:, S:S + 1]), S)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-20b"])
def test_seeded_numpy_params_follow_the_documented_leaf_order(arch):
    """The JAX package's tree, drawn leaf by leaf in ``jax.tree.leaves``
    order from one generator: norms ones, the rest normal / sqrt(fan_in)."""
    jcfg, tcfg = _configs(arch, {})
    tree = seeded_numpy_params(tcfg, 3)
    specs = jax_param_specs(jcfg)
    assert jax.tree.structure(tree) == jax.tree.structure(specs)
    rng = np.random.default_rng(3)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = jax.tree_util.keystr(path)
        assert leaf.dtype == np.float32
        if name.split("'")[-2] in ("ln1", "ln2", "final_ln", "qn", "kn"):
            np.testing.assert_array_equal(leaf, 1.0)
            continue
        fan_in = leaf.shape[-2] if leaf.ndim >= 2 else leaf.shape[-1]
        want = rng.standard_normal(leaf.shape, dtype=np.float32)
        want /= np.float32(np.sqrt(fan_in))
        np.testing.assert_array_equal(leaf, want, err_msg=name)


def test_init_params_follow_the_reference_rules():
    cfg = reduced(get_arch("gemma3-1b"))
    gen = torch.Generator().manual_seed(0)
    tree = init_params(cfg, gen, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
        model_param_specs(cfg)
    emb = tree["emb"]                 # fan_in = vocab
    assert float(emb.abs().max()) <= 2.0 / np.sqrt(cfg.vocab) + 1e-7
    assert abs(float(emb.std()) * np.sqrt(cfg.vocab) - 0.88) < 0.02
    assert torch.equal(tree["body"][0]["ln1"], torch.ones(cfg.n_layers // 6,
                                                          cfg.d_model))
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["body"][3]["wq"], tree["body"][3]["wq"])
    model = DecoderLM.from_tree(cfg, tree)
    logits, _ = prefill(model, torch.zeros(1, 4, dtype=torch.int32))
    assert bool(torch.isfinite(logits).all())


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "qwen3-4b", "--reduced", "--batch", "2",
                      "--prompt-len", "20", "--gen", "5", "--iters", "1",
                      "--device", "cpu"])
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m",
                                  "mixtral-8x22b", "whisper-small",
                                  "llama-3.2-vision-11b", "grok-1-314b"])
def test_archs_of_later_slices_raise(arch):
    with pytest.raises(NotImplementedError, match="slice"):
        get_arch(arch)
