"""The port's LMs against the JAX package's, on the CPU.

Reduced configs (same block structure, narrow widths) of the dense archs
and of the jamba hybrid without its experts (7 Mamba layers and one
attention layer; the MoE archs and jamba with its experts are
``tests/test_torch_moe.py``'s); the weights are the JAX package's
``init_params``, carried across with
``interop.lm_params_from_numpy``. The JAX side runs its serving path with
``attention_impl="pallas"`` (the flash-attention kernel in interpret
mode; the Mamba layers run its jnp scan, ``kernels/ref.py::
selective_scan_ref``); the port's runs the kernels' plain versions, as it
does on the CPU. Floats agree to ``rtol=1e-5`` (with ``atol=1e-5`` for
values near zero: logits and the qk-normed caches are of order 1; the
hybrid's logits are off the JAX package's by up to 6e-6, since its scan
sums in chunks and the port's step by step), tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.model import decode_step as jax_decode_step
from repro.models.spec import model_param_specs as jax_param_specs
from repro.sharding.ctx import ShardCtx
from repro.train.serve_step import generate as jax_generate

from repro_torch import kernels
from repro_torch.configs import MoEConfig, acceptance, get_arch, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import (
    DecoderLM,
    count_params_analytic,
    init_params,
    model_param_specs,
    seeded_numpy_params,
)
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.models.spec import layout, leaves_with_names
from repro_torch.train.serve_step import generate

CTX = ShardCtx(enabled=False, attention_impl="pallas")
RTOL, ATOL = 1e-5, 1e-5
JAMBA = "jamba-1.5-large-398b"
DENSE = ["gemma3-1b", "qwen3-4b", "granite-3-8b", "internlm2-20b"]
NO_EXPERTS = {"moe": "none"}   # the hybrid's layers with the dense MLP
# (arch, overrides): gemma's window 16 makes the ring and the window bind
# at S = 48; its default window (512) leaves them unbound
CASES = [
    ("gemma3-1b", {}),
    ("gemma3-1b", {"swa_window": 16}),
    ("qwen3-4b", {}),
    ("granite-3-8b", {}),
    ("internlm2-20b", {}),
    (JAMBA, NO_EXPERTS),
]
IDS = [a + ("-swa16" if "swa_window" in o else "")
       + ("-no-experts" if "moe" in o else "") for a, o in CASES]
B, S = 2, 48


def _configs(arch, overrides, reduce=True):
    jcfg = jax_get_arch(arch)
    tcfg = get_arch(arch)
    if reduce:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    overrides = dict(overrides)
    if overrides.pop("moe", None):
        jcfg = dataclasses.replace(jcfg, moe=JaxMoEConfig())
        tcfg = dataclasses.replace(tcfg, moe=MoEConfig())
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
    """The JAX package's stacked cache as one entry per layer."""
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
        assert sorted(p) == sorted(j), i       # k, v or conv, ssm
        for name in j:
            assert tuple(p[name].shape) == j[name].shape, (i, name)
            _close(p[name].numpy(), j[name], f"layer {i} {name}")


@pytest.mark.parametrize("arch", DENSE + [JAMBA])
def test_reduced_configs_and_param_specs_match(arch):
    """Both packages' configs (full and reduced; jamba without its
    experts), parameter trees and counts."""
    for full in (True, False):
        jcfg, tcfg = _configs(arch, NO_EXPERTS if arch == JAMBA else {},
                              reduce=not full)
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


@pytest.mark.parametrize("n_layers,count", [(1, 2_098_077_696),
                                            (8, 8_999_034_880)])
def test_jamba_without_experts_parameter_counts(n_layers, count):
    """The serving cases' full-width jamba (``acceptance.jamba_config``):
    one layer (a Mamba mixer + the dense MLP) and one whole 7:1 period."""
    from repro.models.spec import count_params_analytic as jax_count

    from repro_torch.configs import acceptance

    jcfg, tcfg = _configs(JAMBA, NO_EXPERTS, reduce=False)
    jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    cfg = acceptance.jamba_config(n_layers, "float32")
    assert cfg == dataclasses.replace(tcfg, n_layers=n_layers,
                                      dtype="float32")
    assert count_params_analytic(cfg) == jax_count(jcfg) == count


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
    assert kernels.LAUNCHES["selective_scan"] == 0
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


def test_hybrid_decodes_after_a_prompt_shorter_than_the_conv():
    """A 2-token prompt leaves fewer steps than the conv's 3 of history:
    the port's conv cache holds them after zeros, and the decode step
    continues the prefill (the JAX package keeps a 2-step conv cache
    there, and its decode step then fails on the einsum's shapes)."""
    _, cfg = _configs(JAMBA, NO_EXPERTS)
    model = DecoderLM.from_tree(
        cfg, init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    toks = torch.tensor([[5, 9, 2], [7, 1, 3]], dtype=torch.int32)
    want, _ = prefill(model, toks, cache_seq_len=3)
    _, cache = prefill(model, toks[:, :2], cache_seq_len=3)
    assert cache[0]["conv"].shape == (2, cfg.ssm.d_conv - 1,
                                      cfg.ssm.expand * cfg.d_model)
    assert not cache[0]["conv"][:, 0].any()
    got, _ = decode_step(model, cache, toks[:, 2:], 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_bf16_decode_bound_catches_a_wrong_cache():
    """``chip_smoke.py`` holds the hybrid's bf16 decode step within twice
    the bf16 prefill's distance from the f32 model's logits (bf16 rounding
    moves both by about the same). On the reduced hybrid the decode step
    meets that bound, and a zeroed conv or ssm state in one layer does not
    (37x and 3.5x the bf16 prefill's distance)."""
    _, cfg = _configs(JAMBA, NO_EXPERTS)
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m32 = DecoderLM.from_tree(cfg, tree)
    m16 = DecoderLM.from_tree(dataclasses.replace(cfg, dtype="bfloat16"),
                              tree)
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 41), dtype=np.int32))
    truth, _ = prefill(m32, toks, cache_seq_len=41)
    bound = 2.0 * float((prefill(m16, toks, cache_seq_len=41)[0]
                         - truth).abs().max())

    def off(spoil):
        _, cache = prefill(m16, toks[:, :40], cache_seq_len=41)
        spoil(cache)
        got, _ = decode_step(m16, cache, toks[:, 40:], 40)
        return float((got - truth).abs().max())

    assert off(lambda c: None) <= bound
    assert off(lambda c: c[0]["conv"].zero_()) > bound
    assert off(lambda c: c[0]["ssm"].zero_()) > bound


@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-20b", JAMBA]
                         + ["xlstm-125m", "whisper-small",
                            "llama-3.2-vision-11b"])
def test_seeded_numpy_params_follow_the_documented_leaf_order(arch):
    """The JAX package's tree, drawn leaf by leaf in ``jax.tree.leaves``
    order from one generator: norms ones, the rest normal / sqrt(fan_in);
    in the hybrid's Mamba layers ``A_log``, ``D_skip`` and ``conv_b`` draw
    nothing and ``dt_b`` is the inverse softplus of one uniform draw; the
    sLSTM's ``b`` and the VLM's ``xgate`` draw nothing (zeros). Those
    follow the JAX package's ``init_params`` rules; an encoder-decoder's
    ``encoder`` and ``xattn_*`` trees draw in their flatten places."""
    jcfg, tcfg = _configs(arch, NO_EXPERTS if arch == JAMBA else {})
    tree = seeded_numpy_params(tcfg, 3)
    specs = jax_param_specs(jcfg)
    assert jax.tree.structure(tree) == jax.tree.structure(specs)
    rng = np.random.default_rng(3)
    jax_tree = jax.device_get(jax_init_params(jcfg, jax.random.key(3)))
    jax_leaves = dict(
        (jax.tree_util.keystr(p), v)
        for p, v in jax.tree_util.tree_leaves_with_path(jax_tree))
    n_mamba = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = jax.tree_util.keystr(path)
        base = name.split("'")[-2]
        assert leaf.dtype == np.float32
        if base in ("ln1", "ln2", "lnx", "ln_inner", "final_ln", "qn", "kn"):
            np.testing.assert_array_equal(leaf, 1.0)
            continue
        if base in ("b", "xgate"):
            np.testing.assert_array_equal(leaf, jax_leaves[name], name)
            np.testing.assert_array_equal(leaf, 0.0)
            continue
        if base in ("A_log", "D_skip", "conv_b"):
            n_mamba += 1
            np.testing.assert_array_equal(leaf, jax_leaves[name], name)
            continue
        if base == "dt_b":
            n_mamba += 1
            u = rng.uniform(1e-3, 1e-1, leaf.shape).astype(np.float32)
            np.testing.assert_array_equal(leaf, u + np.log(-np.expm1(-u)))
            for b in (leaf, jax_leaves[name]):   # softplus(dt_b) = u
                dt = np.log1p(np.exp(b.astype(np.float64)))
                assert 1e-3 * (1 - 1e-5) <= dt.min() <= dt.max() \
                    <= 1e-1 * (1 + 1e-5)
            continue
        fan_in = leaf.shape[-2] if leaf.ndim >= 2 else leaf.shape[-1]
        want = rng.standard_normal(leaf.shape, dtype=np.float32)
        want /= np.float32(np.sqrt(fan_in))
        np.testing.assert_array_equal(leaf, want, err_msg=name)
    # the hybrid's 7 Mamba layers; the reduced xLSTM's 3 mLSTM conv biases
    assert n_mamba == {JAMBA: 4 * 7, "xlstm-125m": 3}.get(arch, 0)


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


@pytest.mark.parametrize("make", ["init_params", "seeded_numpy_params"])
def test_weights_die_with_their_tree(make):
    """No reference cycle holds the weights: a tree dropped with the
    garbage collector off frees its leaves (a cycle kept a card's 36 GB
    of jamba masters alive into the next phase until a collection)."""
    import gc
    import weakref

    cfg = reduced(get_arch("gemma3-1b"))
    gc.collect()
    gc.disable()
    try:
        tree = (init_params(cfg, torch.Generator().manual_seed(0), "cpu")
                if make == "init_params" else seeded_numpy_params(cfg, 0))
        refs = [weakref.ref(tree["emb"]), weakref.ref(tree["body"][0]["wq"])]
        del tree
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_init_params_follow_the_mamba_rules():
    """The port's torch init of the hybrid's Mamba leaves, by the JAX
    package's rules: ``A_log`` = log(1..d_state), ``D_skip`` ones,
    ``conv_b`` zeros, ``softplus(dt_b)`` uniform in [1e-3, 1e-1]."""
    _, cfg = _configs(JAMBA, NO_EXPERTS)
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = tree["body"][0]                        # a Mamba layer, (R, ...)
    ds = cfg.ssm.d_state
    want = np.log(np.arange(1, ds + 1, dtype=np.float32))
    np.testing.assert_array_equal(layer["A_log"].numpy(),
                                  np.broadcast_to(want, layer["A_log"].shape))
    assert torch.equal(layer["D_skip"], torch.ones_like(layer["D_skip"]))
    assert torch.equal(layer["conv_b"], torch.zeros_like(layer["conv_b"]))
    dt = torch.nn.functional.softplus(layer["dt_b"].double())
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) < float(dt.max()) \
        <= 1e-1 * (1 + 1e-5)
    assert abs(float(dt.mean()) - 0.0505) < 0.005
    assert abs(float(layer["conv_w"].std()) - 0.88 / 2) < 0.05  # fan_in 4
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


MOE_ARCHS = [JAMBA, "mixtral-8x22b", "grok-1-314b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_serves_the_moe_archs_on_the_cpu(arch, capsys):
    """The CLI builds the reduced MoE archs (jamba with its experts) and
    generates on the CPU."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                      "--prompt-len", "12", "--gen", "4", "--iters", "1",
                      "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < reduced(get_arch(arch)).vocab)).all())
    assert f"arch={arch}" in capsys.readouterr().out


def _same_config_and_shapes(arch):
    """The port's config of ``arch`` is the JAX package's, and so is its
    parameter tree (the perf model counts it)."""
    cfg = get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_arch(arch))
    assert [tuple(x.shape) for x in jax.tree.leaves(jax_param_specs(
        jax_get_arch(arch)))] == [
            shape for _, shape in leaves_with_names(model_param_specs(cfg))]
    return cfg


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_archs_build_with_the_reference_config_and_shapes(arch):
    """The MoE archs' configs and parameter trees are the JAX package's,
    full and reduced; the model, the port's random init and the numpy
    weights both packages load build them (on the reduced config, which
    keeps the layer kinds and the MoE period), with the tree's shapes."""
    cfg = _same_config_and_shapes(arch)
    assert cfg.moe.n_experts == (16 if arch == JAMBA else 8)
    small = reduced(cfg)
    assert dataclasses.asdict(small) == dataclasses.asdict(
        jax_reduced(jax_get_arch(arch)))
    specs = jax.tree.map(lambda s: tuple(s.shape),
                         jax_param_specs(jax_reduced(jax_get_arch(arch))))
    tree = init_params(small, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == specs
    assert jax.tree.map(lambda a: a.shape,
                        seeded_numpy_params(small, 0)) == specs
    model = DecoderLM.from_tree(small, tree)
    assert [layer.is_moe for layer in model.layers] == [
        small.is_moe_layer(i) for i in range(small.n_layers)]
    assert small.param_count() == jax_reduced(
        jax_get_arch(arch)).param_count()


LAST_ARCHS = ["xlstm-125m", "whisper-small", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", LAST_ARCHS)
def test_the_last_archs_build_with_the_reference_tree(arch):
    """Every arch's config is the JAX package's, and so is its parameter
    tree (the perf model counts it). The xLSTM, VLM and encoder-decoder
    archs build (on the reduced config, which keeps the layer kinds) from
    the port's random init and from the numpy weights both packages load,
    with the JAX package's tree: the same leaves, the same shapes, and
    the fixed leaves by its rules (``ln_inner`` and ``lnx`` ones, ``b`` and
    ``xgate`` zeros); a prefill with the arch's memory is finite."""
    cfg = _same_config_and_shapes(arch)
    small = reduced(cfg)
    jsmall = jax_reduced(jax_get_arch(arch))
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    jax_tree = jax.device_get(jax_init_params(jsmall, jax.random.key(0)))
    jax_leaves = dict((jax.tree_util.keystr(p), v) for p, v in
                      jax.tree_util.tree_leaves_with_path(jax_tree))
    fixed = ("ln_inner", "lnx", "b", "xgate", "final_ln", "ln1", "ln2")
    for tree in (init_params(small, torch.Generator().manual_seed(0), "cpu"),
                 seeded_numpy_params(small, 0)):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(p) for p, _ in leaves] == list(jax_leaves)
        for path, leaf in leaves:
            name = jax.tree_util.keystr(path)
            assert tuple(leaf.shape) == jax_leaves[name].shape, name
            if name.split("'")[-2] in fixed:
                np.testing.assert_array_equal(np.asarray(leaf),
                                              jax_leaves[name], name)
        model = DecoderLM.from_tree(small, jax.tree.map(torch.as_tensor,
                                                        tree))
        assert [m.kind for m in model.layers] == [
            small.layer_kind(i) if not small.cross_attn_period
            or i % small.cross_attn_period != small.cross_attn_period - 1
            else "cross" for i in range(small.n_layers)]
        assert (model.encoder is not None) == small.enc_dec
        memory = {k: torch.tensor(v)
                  for k, v in acceptance.lm_memory(small, 1).items()}
        logits, _ = prefill(model, torch.zeros(1, 5, dtype=torch.int32),
                            extras=memory)
        assert bool(torch.isfinite(logits).all())
    assert small.param_count() == jsmall.param_count()
