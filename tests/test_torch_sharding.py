"""The LM half of the port's ``sharding/specs.py`` against the JAX
package's, with no world: for each of the ten archs, at meshes of (16,
16), (2, 16, 16), (2, 4), (8, 1) and none, with ``fsdp`` and
``expert_parallel`` each switched off too, the param, batch, cache and
train-state specs equal the JAX package's ``tuple(P)`` leaf by leaf (a
mesh is a dict of axis sizes on the port's side and an object with the
JAX mesh's ``axis_names`` and ``devices.shape`` on the JAX side). Also
the port of the JAX package's three spec tests
(``tests/test_hlo_and_specs.py``), ``ShardCtx``'s methods and
``placements``.
"""

import types

import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShape
from repro.optim import Adafactor as JaxAdafactor
from repro.optim import AdamW as JaxAdamW
from repro.sharding import specs as JS
from repro.sharding.ctx import ShardCtx as JaxCtx
from repro.sharding.ctx import make_ctx as jax_make_ctx
from repro.train.state import train_state_pspecs as jax_train_state_pspecs
from repro.utils.tree import tree_map_with_path_names as jax_named_map

from repro_torch.configs import ARCHS, ShapeConfig, get_arch
from repro_torch.models import spec as S
from repro_torch.optim import Adafactor, AdamW
from repro_torch.sharding import specs as PS
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx, make_ctx
from repro_torch.train import train_state_pspecs

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "8x1": {"data": 8, "model": 1},
          "none": None}
VARIANTS = {"default": {}, "no_fsdp": {"fsdp": False},
            "no_ep": {"expert_parallel": False}}


def _jax_mesh(sizes):
    if sizes is None:
        return None
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _ctxs(mesh_name, variant):
    sizes = MESHES[mesh_name] or {}
    multi = "pod" in sizes
    kw = dict(VARIANTS[variant])
    if sizes:
        kw.update(tp_size=sizes["model"],
                  dp_size=sizes["data"] * sizes.get("pod", 1))
    return make_ctx(multi, **kw), jax_make_ctx(multi, **kw)


def _jax_leaves(tree) -> dict:
    out = {}
    jax_named_map(lambda n, p: out.__setitem__(n, tuple(p)), tree)
    return out


def _port_leaves(tree) -> dict:
    return dict(PS.spec_leaves(tree))


def _same(got, want):
    got, want = _port_leaves(got), _jax_leaves(want)
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n] == want[n], (n, got[n], want[n])
    return got


def _jax_shape(shape):
    return JaxShape(shape.name, shape.seq_len, shape.global_batch,
                    shape.mode)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_jax_package(arch, mesh_name, variant):
    """param, train-state (AdamW, Adafactor), batch (train, prefill,
    decode) and cache specs, leaf by leaf."""
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    ctx, jctx = _ctxs(mesh_name, variant)
    mesh, jmesh = MESHES[mesh_name], _jax_mesh(MESHES[mesh_name])
    _same(PS.param_pspecs(cfg, ctx, mesh), JS.param_pspecs(jcfg, jctx, jmesh))
    for opt, jopt in ((AdamW(), JaxAdamW()), (Adafactor(), JaxAdafactor())):
        _same(train_state_pspecs(cfg, ctx, opt, mesh),
              jax_train_state_pspecs(jcfg, jctx, jopt, jmesh))
        _same(PS.train_state_pspecs(cfg, ctx, opt, mesh),
              JS.train_state_pspecs(jcfg, jctx, jopt, jmesh))
    for mode in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", 64, 8, mode)
        _same(PS.batch_pspecs(cfg, shape, ctx),
              JS.batch_pspecs(jcfg, _jax_shape(shape), jctx))
    assert PS.batch_pspec(ctx) == tuple(JS.batch_pspec(jctx))


@pytest.mark.parametrize("kv_shard", ["seq", "seq2d", "head", "none"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_decode_specs_under_every_kv_shard(arch, kv_shard):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for multi in (False, True):
        ctx = make_ctx(multi, decode_kv_shard=kv_shard)
        jctx = jax_make_ctx(multi, decode_kv_shard=kv_shard)
        _same(PS.cache_pspecs(cfg, ctx), JS.cache_pspecs(jcfg, jctx))
        shape = ShapeConfig("d", 64, 8, "decode")
        _same(PS.batch_pspecs(cfg, shape, ctx),
              JS.batch_pspecs(jcfg, _jax_shape(shape), jctx))
        assert ctx.kv_cache_pspec() == tuple(jctx.kv_cache_pspec())
    # disabled: every cache spec unsharded, as the JAX package's
    _same(PS.cache_pspecs(cfg, ShardCtx(decode_kv_shard=kv_shard)),
          JS.cache_pspecs(jcfg, JaxCtx(decode_kv_shard=kv_shard)))


# ---------------------------------------------------------------------------
# the JAX package's spec tests (tests/test_hlo_and_specs.py), ported
@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "gemma3-1b"])
def test_param_pspecs_divide_evenly(arch):
    """Every sharded dim divides by its mesh axes' product: the builder
    drops shardings that do not."""
    cfg = get_arch(arch)
    sizes = {"data": 16, "model": 16}
    specs = _port_leaves(PS.param_pspecs(cfg, make_ctx(False), sizes))
    for name, shape in S.leaves_with_names(S.model_param_specs(cfg)):
        for dim, ax in zip(shape, specs[name] + (None,) * 8):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([sizes[a] for a in axes]))
            assert dim % total == 0, f"{name}: {dim} % {total}"


def test_expert_parallel_only_when_divisible():
    ctx = make_ctx(False)
    jam = _port_leaves(PS.param_pspecs(get_arch("jamba-1.5-large-398b"),
                                       ctx))                 # 16 experts
    mix = _port_leaves(PS.param_pspecs(get_arch("mixtral-8x22b"), ctx))
    first = lambda t: next(v for n, v in sorted(t.items())  # noqa: E731
                           if n.endswith("e_wg"))
    assert first(jam)[1] == "model"     # stacked: (None, E='model', ...)
    assert first(mix)[1] is None        # 8 experts over 16: not sharded


def test_cache_pspecs_structure_matches_cache():
    from repro_torch.models.model import cache_specs
    from repro_torch.utils.tree import tree_leaves_with_names

    cfg = get_arch("jamba-1.5-large-398b")
    ps = _port_leaves(PS.cache_pspecs(cfg, make_ctx(False)))
    leaves = dict(tree_leaves_with_names(cache_specs(cfg, 8, 64)))
    assert sorted(ps) == sorted(leaves)
    for n, t in leaves.items():
        assert len(ps[n]) == t.dim(), n
        assert t.is_meta


# ---------------------------------------------------------------------------
# the context and the placements
def test_ctx_methods_equal_the_jax_package():
    for multi in (False, True):
        ctx, jctx = make_ctx(multi, tp_size=4), jax_make_ctx(multi, tp_size=4)
        for logical in ("dp", "fsdp", "sp", "tp", None):
            assert ctx.axis(logical) == jctx.axis(logical)
        assert ctx.pspec("dp", "sp", None) == tuple(
            jctx.pspec("dp", "sp", None))
        for h in (1, 2, 4, 6, 8):
            assert ctx.heads_axis(h) == jctx.heads_axis(h)
        nsp = ctx.with_(seq_parallel=False)
        assert nsp.axis("sp") is None and nsp.tp_size == 4
    assert UNSHARDED == ShardCtx() and not UNSHARDED.enabled
    assert UNSHARDED.remat == JaxCtx().remat
    assert UNSHARDED.logit_chunk == JaxCtx().logit_chunk
    assert UNSHARDED.cast_params_bf16 == JaxCtx().cast_params_bf16
    with pytest.raises(ValueError, match="remat"):
        ShardCtx(remat="superblock")
    with pytest.raises(ValueError, match="logical"):
        make_ctx(False).axis("ep")


def test_constrain_is_a_no_op_off_the_mesh():
    import torch

    x = torch.ones(2, 3)
    assert make_ctx(False).constrain(x, "dp", None) is x
    assert UNSHARDED.constrain(x, "dp", None) is x


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    assert PS.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert PS.placements((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert PS.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        PS.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="two dims"):
        PS.placements(("model", "model"), mesh)
