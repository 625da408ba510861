"""The port's Mixture-of-Experts FFN against the JAX package's, on the CPU.

``moe_apply`` on the same seeded numpy inputs in both packages
(``ShardCtx(enabled=False)``, so G = 1 group unless ``dp_size`` says
otherwise): the output within ``2e-5 + 2e-5 |y|`` in f32 and ``2e-2`` in
bf16, the aux loss within ``rtol=1e-5``, and the routing exactly: the
experts each (token, k) slot picks, in ``lax.top_k``'s order, and which
slots drop past the capacity. The JAX package exposes no routing, so its
routing is recomputed from its own functions (``_torch_moe_ref.py``).
Then the reduced MoE archs (mixtral with a window of 24, also at a
capacity factor of 0.5 that drops slots, grok, jamba with its experts)
end to end: prefill and eight teacher-forced decode steps against the JAX
package's, the slots each layer dropped equal, and the port's own
prefill/decode invariant.
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
from repro.models import moe as jax_moe
from repro.models.model import decode_step as jax_decode_step
from repro.sharding.ctx import ShardCtx

from _torch_moe_ref import jax_dropped_slots, jax_routing

from repro_torch.configs import acceptance as A
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import DecoderLM, seeded_numpy_params
from repro_torch.models import moe
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.spec import layout

F32_TOL, BF16_TOL, AUX_RTOL = 2e-5, 2e-2, 1e-5
CTX = ShardCtx(enabled=False)
LM_CTX = ShardCtx(enabled=False, attention_impl="pallas")
D, FF = 64, 128
SHAPES = {"prefill": (2, 64), "decode": (4, 1)}
MOE_ARCHS = ["mixtral-8x22b", "grok-1-314b", "jamba-1.5-large-398b"]


def _configs(n_experts: int, top_k: int, dtype: str = "float32"):
    """(JAX config, port config): reduced mixtral with E experts, top-k."""
    def make(get, red):
        cfg = red(get("mixtral-8x22b"))
        return dataclasses.replace(
            cfg, dtype=dtype, d_model=D, d_ff=FF,
            moe=dataclasses.replace(cfg.moe, n_experts=n_experts,
                                    top_k=top_k))
    return make(jax_get_arch, jax_reduced), make(get_arch, reduced)


def _inputs(E: int, shape, seed: int, zero_router: bool = False):
    """f32 numpy weights of one MoE layer and its input x (B, S, D)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    w = {"ln2": (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
         "router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(f32),
         "e_wg": (rng.standard_normal((E, D, FF)) / np.sqrt(D)).astype(f32),
         "e_wi": (rng.standard_normal((E, D, FF)) / np.sqrt(D)).astype(f32),
         "e_wo": (rng.standard_normal((E, FF, D)) / np.sqrt(FF)).astype(f32)}
    if zero_router:
        w["router"][:] = 0.0
    x = rng.standard_normal(shape + (D,)).astype(f32)
    return w, x


def _jax_run(w, x, jcfg, cf, ctx=CTX):
    dt = jnp.dtype(jcfg.dtype)
    params = {k: jnp.asarray(v) for k, v in w.items()}
    y, aux = jax_moe.moe_apply(params, jnp.asarray(x).astype(dt), jcfg, ctx,
                               capacity_factor=cf)
    return np.asarray(y.astype(jnp.float32)), float(aux)


def _port_run(w, x, cfg, cf, groups=1):
    dt = getattr(torch, cfg.dtype)
    tw = {k: torch.tensor(v) if k in ("ln2", "router")
          else torch.tensor(v).to(dt) for k, v in w.items()}
    with moe.record_routing() as rec:
        y, aux = moe.moe_apply(tw, torch.tensor(x).to(dt), cfg,
                               capacity_factor=cf, groups=groups)
    assert y.dtype == dt and aux.dtype == torch.float32
    return y.float().numpy(), float(aux), rec[0]


def _check(jax_out, port_out, dtype):
    (jy, jaux), (py, paux) = jax_out, port_out
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(py, jy, rtol=tol, atol=tol)
    np.testing.assert_allclose(paux, jaux, rtol=AUX_RTOL)


def _jax_routing(w, x, jcfg, cf, groups=1):
    x = jnp.asarray(x).astype(jnp.dtype(jcfg.dtype))
    idx, keep, C = jax_routing(w, x, jcfg, cf, groups)
    return np.asarray(idx), np.asarray(keep), C


def _check_routing(ref, r: moe.Routing):
    idx, keep, C = ref
    assert r.capacity == C
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", list(SHAPES))
@pytest.mark.parametrize("cf", ["0.5", "1.25", "E/K"])
@pytest.mark.parametrize("E,K", [(8, 2), (16, 2)])
def test_moe_apply_matches_the_reference(E, K, cf, where, dtype):
    """0.5 forces drops at prefill, 1.25 is the published factor, E/K
    drops nothing."""
    cf = E / K if cf == "E/K" else float(cf)
    jcfg, cfg = _configs(E, K, dtype)
    w, x = _inputs(E, SHAPES[where], seed=E + int(4 * cf))
    want = _jax_run(w, x, jcfg, cf)
    y, aux, r = _port_run(w, x, cfg, cf)
    _check(want, (y, aux), dtype)
    _check_routing(_jax_routing(w, x, jcfg, cf), r)
    n_slots = int(np.prod(SHAPES[where])) * K
    dropped = int((~r.keep).sum())
    if where == "prefill" and cf == 0.5:
        assert dropped > 0
    if cf == E / K or where == "decode":
        assert dropped == 0
    # a dropped slot adds nothing; a token with both slots dropped gets 0
    gone = (~r.keep).reshape(-1, K).all(-1).numpy()
    assert not y.reshape(-1, D)[gone].any()
    assert dropped <= n_slots


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_ties_pick_the_lower_experts_and_drop_in_token_order(dtype):
    """A zero router: every prob is 1/E, so every slot picks experts
    0..K-1 in that order, the ranks follow the tokens, and exactly the
    slots past rank C - 1 drop (the later tokens)."""
    E, K, cf = 8, 2, 1.25
    jcfg, cfg = _configs(E, K, dtype)
    w, x = _inputs(E, (2, 64), seed=5, zero_router=True)
    want = _jax_run(w, x, jcfg, cf)
    y, aux, r = _port_run(w, x, cfg, cf)
    _check(want, (y, aux), dtype)
    _check_routing(_jax_routing(w, x, jcfg, cf), r)
    T = 2 * 64
    C = moe.capacity(cf, T, K, E)
    assert C == 40
    np.testing.assert_array_equal(r.expert_idx[0].numpy(),
                                  np.tile(np.arange(K), (T, 1)))
    np.testing.assert_array_equal(r.rank[0].numpy(),
                                  np.repeat(np.arange(T), K))
    np.testing.assert_array_equal(r.keep[0].numpy(),
                                  np.repeat(np.arange(T) < C, K))
    assert float(aux) == 2.0             # E * (K / E * 1 / E) * E
    assert torch.equal(r.gates, torch.full_like(r.gates, 0.5))
    assert not y.reshape(T, D)[C:].any() and y.reshape(T, D)[:C].any()


def test_capacity_is_the_references_expression():
    for cf in (0.01, 0.5, 1.0, 1.25, 1.3, 2.0, 4.0, 8.0):
        for Tg in (1, 3, 4, 7, 64, 640, 1280, 2560, 4096, 4100):
            for K in (1, 2):
                for E in (4, 8, 16):
                    want = jax_moe.round_up(int(cf * Tg * K / E) or 1, 8)
                    assert moe.capacity(cf, Tg, K, E) == want, (cf, Tg, K, E)
    assert moe.capacity(1.25, 1280, 2, 8) == 400     # serve_mixtral_1l
    assert moe.capacity(1.25, 4096, 2, 8) == 1280    # the card's tie check


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groups_rank_within_each_group(dtype):
    """G = 2 groups, as the JAX package groups by its data-parallel
    degree (``dp_size``): ranks and the capacity per group."""
    E, K, cf = 8, 2, 0.5
    jcfg, cfg = _configs(E, K, dtype)
    w, x = _inputs(E, (2, 64), seed=11)
    want = _jax_run(w, x, jcfg, cf, ShardCtx(enabled=False, dp_size=2))
    y, aux, r = _port_run(w, x, cfg, cf, groups=2)
    _check(want, (y, aux), dtype)
    _check_routing(_jax_routing(w, x, jcfg, cf, groups=2), r)
    assert r.capacity == moe.capacity(cf, 64, K, E)
    assert int((~r.keep[0]).sum()) > 0 and int((~r.keep[1]).sum()) > 0


def test_top_k_order_on_ties():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]])
    vals, idx = moe.top_k_desc(p, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_router_stays_f32_in_a_bf16_model():
    """The router is read in f32 from the master, as the JAX package
    reads it; the experts are bf16 copies."""
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x22b")),
                              dtype="bfloat16")
    model = lm_params_from_numpy(seeded_numpy_params(cfg, 0), cfg, "cpu")
    layer = model.layers[0]
    assert layer.is_moe
    w = layer.weights()
    assert w["router"].dtype == torch.float32
    assert w["router"].data_ptr() == layer.router.data_ptr()
    assert w["e_wg"].dtype == w["e_wo"].dtype == torch.bfloat16
    assert w["ln2"].dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_interop_carries_the_expert_leaves(arch):
    """``lm_params_from_numpy`` takes the JAX package's MoE leaves with
    no change: each layer holds its router and experts, bit for bit."""
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    tree = jax.device_get(jax_init_params(jcfg, jax.random.key(0)))
    model = lm_params_from_numpy(tree, cfg, "cpu")
    period, R, _ = layout(cfg)
    n_moe = 0
    for i, layer in enumerate(model.layers):
        src = ({k: v[i // period] for k, v in tree["body"][i % period].items()}
               if i < R * period else tree["tail"][i - R * period])
        assert layer.is_moe == cfg.is_moe_layer(i)
        assert sorted(dict(layer.named_parameters())) == sorted(src)
        for name, p in layer.named_parameters():
            np.testing.assert_array_equal(p.numpy(), src[name])
        n_moe += layer.is_moe
        assert ("router" in src) == layer.is_moe
    assert n_moe == sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) > 0


def test_seeded_expert_leaves_follow_the_documented_order():
    """An MoE layer's leaves in sorted key order (``e_wg, e_wi, e_wo``
    before the norms, ``router`` after them), each a normal over
    sqrt(fan_in): D for the router and ``e_wg`` / ``e_wi``, F for
    ``e_wo``."""
    cfg = reduced(get_arch("mixtral-8x22b"))
    tree = seeded_numpy_params(cfg, 4)
    layer = tree["body"][0]
    assert list(sorted(layer)) == ["e_wg", "e_wi", "e_wo", "ln1", "ln2",
                                   "router", "wk", "wo", "wq", "wv"]
    rng = np.random.default_rng(4)
    for name in sorted(layer):
        leaf = layer[name]
        if name in ("ln1", "ln2"):
            np.testing.assert_array_equal(leaf, 1.0)
            continue
        want = rng.standard_normal(leaf.shape, dtype=np.float32)
        want /= np.float32(np.sqrt(leaf.shape[-2]))
        np.testing.assert_array_equal(leaf, want, err_msg=name)
    E, F = cfg.moe.n_experts, cfg.d_ff
    assert layer["router"].shape == (cfg.n_layers, cfg.d_model, E)
    assert layer["e_wo"].shape == (cfg.n_layers, E, F, cfg.d_model)


# ---------------------------------------------------------------------------
# the reduced MoE archs end to end
B, S, N = 2, 48, 8
LM_CASES = {"mixtral-8x22b": {"swa_window": 24},
            "mixtral-8x22b-cf0.5": {"swa_window": 24, "cf": 0.5},
            "grok-1-314b": {}, "jamba-1.5-large-398b": {}}


def _lm_configs(case: str):
    """(JAX config, port config) of a reduced serving case: the arch's
    ``reduced()`` (capacity factor 4.0: nothing drops) with overrides."""
    over = dict(LM_CASES[case])
    arch = case.split("-cf")[0]
    jcfg = jax_reduced(jax_get_arch(arch))
    cfg = reduced(get_arch(arch))
    cf = over.pop("cf", None)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(cfg, **over))


@pytest.fixture(scope="module", params=list(LM_CASES))
def lm_case(request):
    jcfg, cfg = _lm_configs(request.param)
    tree = seeded_numpy_params(cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + N),
                                             dtype=np.int32)
    return request.param, jcfg, cfg, tree, toks


def test_reduced_moe_serving_matches_the_reference(lm_case):
    """Prefill S tokens into a cache of S + N, then N teacher-forced
    decode steps: logits within 1e-5 of the JAX package's at each, and
    each MoE layer's dropped slots equal."""
    case, jcfg, cfg, tree, toks = lm_case
    params = jax.tree.map(jnp.asarray, tree)
    with jax_dropped_slots() as jax_drops:
        want, cache = jax_prefill(
            params, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, LM_CTX,
            cache_seq_len=S + N)
        wants = [np.asarray(want)]
        for i in range(N):
            want, cache = jax_decode_step(
                params, cache, jnp.asarray(toks[:, S + i:S + i + 1]),
                jnp.int32(S + i), jcfg, LM_CTX)
            wants.append(np.asarray(want))
        jax.effects_barrier()
    model = lm_params_from_numpy(tree, cfg, "cpu")
    drops = []
    gots = A.run_lm(model, torch.tensor(toks), S, N, dropped=drops)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert n_moe > 0 and [len(d) for d in drops] == [n_moe] * (1 + N)
    assert [c for step in drops for c in step] == jax_drops
    if "cf0.5" in case:
        assert all(c > 0 for c in drops[0])
        assert not any(c for step in drops[1:] for c in step)
    else:
        assert not any(c for step in drops for c in step)
    for i, (g, w) in enumerate(zip(gots, wants)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i}")
        assert np.array_equal(g.numpy().argmax(-1), w.argmax(-1)), i


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_prefill_then_decode_matches_longer_prefill(arch):
    """The port's own invariant at the reduced config's capacity (4.0 >=
    E / K: nothing drops)."""
    cfg = reduced(get_arch(arch))
    model = lm_params_from_numpy(seeded_numpy_params(cfg, 0), cfg, "cpu")
    t = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + 1), dtype=np.int32))
    with moe.record_routing() as rec:
        want, _ = prefill(model, t, cache_seq_len=S + 1)
    assert rec and not any(bool((~r.keep).any()) for r in rec)
    _, cache = prefill(model, t[:, :S], cache_seq_len=S + 1)
    got, _ = decode_step(model, cache, t[:, S:S + 1], S)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_bf16_decode_bound_catches_a_wrong_cache():
    """``chip_smoke.py`` holds ``serve_mixtral_4l``'s bf16 decode step
    within twice the bf16 prefill's distance from the f32 model's logits
    (at capacity E / K, where routing agrees). On reduced mixtral the
    decode step meets that bound, and a zeroed k or v cache of its first
    layer does not."""
    cfg = reduced(get_arch("mixtral-8x22b"))
    tree = jax.tree.map(torch.from_numpy, seeded_numpy_params(cfg, 0))
    m32 = DecoderLM.from_tree(cfg, tree)
    m16 = DecoderLM.from_tree(dataclasses.replace(cfg, dtype="bfloat16"),
                              tree)
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1), dtype=np.int32))
    truth, _ = prefill(m32, toks, cache_seq_len=S + 1)
    bound = 2.0 * float((prefill(m16, toks, cache_seq_len=S + 1)[0]
                         - truth).abs().max())

    def off(spoil):
        _, cache = prefill(m16, toks[:, :S], cache_seq_len=S + 1)
        spoil(cache)
        got, _ = decode_step(m16, cache, toks[:, S:], S)
        return float((got - truth).abs().max())

    assert off(lambda c: None) <= bound
    assert off(lambda c: c[0]["k"].zero_()) > bound
    assert off(lambda c: c[0]["v"].zero_()) > bound


def test_decoder_lm_builds_every_moe_arch_at_full_shapes():
    """The full configs pass ``check_ported``: the model's layers know
    which FFNs are experts (mixtral and grok every layer, jamba every
    second)."""
    for arch in MOE_ARCHS:
        cfg = get_arch(arch)
        kinds = [cfg.is_moe_layer(i) for i in range(cfg.n_layers)]
        assert all(kinds) if arch != MOE_ARCHS[2] else (
            kinds == [i % 2 == 1 for i in range(cfg.n_layers)])
        small = dataclasses.replace(reduced(cfg), dtype="bfloat16")
        model = DecoderLM.from_tree(small, jax.tree.map(
            torch.from_numpy, seeded_numpy_params(small, 0)))
        assert [m.is_moe for m in model.layers] == [
            small.is_moe_layer(i) for i in range(small.n_layers)]
