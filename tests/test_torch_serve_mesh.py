"""Sharded serving of the dense family on ``torch.distributed`` (DTensor
meshes) against the JAX package's unsharded ``prefill`` and
``decode_step``, on the CPU.

One gloo world of 4 CPU ranks (``launch.mesh.spawn_world``, its rank
programs in ``tests/_torch_serve_mesh_workers.py``) serves reduced
gemma3-1b (cut to a window layer with a ring of 8 slots and a global
layer, Kv 1) and reduced qwen3-4b (Kv 2) on meshes (1, 2), (2, 1) and
(2, 2), under each ``decode_kv_shard``: a 15-token prompt (the ring
wraps at prefill), then decode steps at positions 15 and 16 (slots 7 and
0 of the ring).
The JAX references run in this process meanwhile, on the same
``seeded_numpy_params`` and tokens, with the plain attention
(``attention_impl="full"``). Every rank's logits must match within
``LM_F32_TOL`` (2e-5 + 2e-5 |x|); after the prefill and after every
decode step each cache leaf keeps the placements of
``sharding.specs.layer_cache_pspecs``; and no decode step all-gathers a
tensor of a cache leaf's local shape. ``generate`` on (2, 2) gives the
one-device run's tokens. The families that do not serve on a mesh yet
refuse a sharded context.
"""

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import prefill as jax_prefill
from repro.models.model import decode_step as jax_decode_step
from repro.sharding.ctx import ShardCtx

from repro_torch.configs import acceptance as A
from repro_torch.configs import get_arch, reduced
from repro_torch.models import DecoderLM
from repro_torch.models.model import check_mesh_serving, decode_step, prefill
from repro_torch.sharding.ctx import make_ctx

sys.path.insert(0, os.path.dirname(__file__))
import _torch_serve_mesh_workers as W  # noqa: E402

CASES = [(arch, mesh, kv) for arch in W.ARCHS for mesh in W.MESHES
         for kv in W.KV_SHARDS]
IDS = [f"{a}-{d}x{m}-{kv}" for a, (d, m), kv in CASES]
OTHERS = ["mixtral-8x22b", "grok-1-314b", "jamba-1.5-large-398b",
          "xlstm-125m", "llama-3.2-vision-11b", "whisper-small"]


def _jax_logits(arch: str) -> np.ndarray:
    """The JAX package's unsharded prefill and decode steps on the case:
    (1 + DECODE, B, V) f32."""
    cfg = W.case_config(arch)
    jcfg = dataclasses.replace(
        jax_reduced(jax_get_arch(arch)), swa_window=cfg.swa_window,
        n_layers=cfg.n_layers, block_pattern=cfg.block_pattern)
    params = jax.tree.map(jnp.asarray, W.case_tree(cfg))
    toks = jnp.asarray(W.case_tokens(cfg))
    ctx = ShardCtx(enabled=False, attention_impl="full")
    logits, cache = jax_prefill(params, {"tokens": toks[:, :W.PROMPT]},
                                jcfg, ctx,
                                cache_seq_len=W.PROMPT + W.DECODE)
    out = [logits]
    for i in range(W.DECODE):
        pos = W.PROMPT + i
        logits, cache = jax_decode_step(params, cache, toks[:, pos:pos + 1],
                                        jnp.int32(pos), jcfg, ctx)
        out.append(logits)
    return np.stack([np.asarray(x) for x in out])


@pytest.fixture(scope="module")
def world():
    """(every rank's results, the JAX references by arch): the world runs
    in a thread while the references are computed here."""
    from repro_torch.launch.mesh import spawn_world

    done = {}

    def run():
        try:
            done["ranks"] = spawn_world(W.serve_cases, 4, backend="gloo",
                                        devices=["cpu"] * 4, timeout=600)
        except BaseException as e:  # noqa: BLE001
            done["error"] = e

    t = threading.Thread(target=run)
    t.start()
    refs = {arch: _jax_logits(arch) for arch in W.ARCHS}
    t.join()
    if "error" in done:
        raise done["error"]
    return done["ranks"], refs


def _ranks_of(ranks, case):
    """Each rank's result for ``case`` (the ranks of its mesh)."""
    got = [r[case] for r in ranks if case in r]
    assert len(got) == (4 if case[1] == (2, 2) else 2)
    return got


@pytest.mark.parametrize("arch,mesh,kv", CASES, ids=IDS)
def test_every_rank_matches_the_unsharded_reference(world, arch, mesh, kv):
    ranks, refs = world
    want = refs[arch]
    tol = A.LM_F32_TOL
    for got in _ranks_of(ranks, (arch, mesh, kv)):
        err = np.abs(got["logits"] - want)
        assert np.all(err <= tol + tol * np.abs(want)), float(err.max())


@pytest.mark.parametrize("arch,mesh,kv", CASES, ids=IDS)
def test_the_cache_keeps_its_layout(world, arch, mesh, kv):
    ranks, _ = world
    for got in _ranks_of(ranks, (arch, mesh, kv)):
        assert got["faults"] == []


@pytest.mark.parametrize("arch,mesh,kv", CASES, ids=IDS)
def test_decode_gathers_no_cache_leaf(world, arch, mesh, kv):
    ranks, _ = world
    for got in _ranks_of(ranks, (arch, mesh, kv)):
        leaves = set(got["cache_shapes"])
        assert not leaves & set(got["gathers"]), (leaves, got["gathers"])


def test_generate_on_a_mesh_gives_the_one_device_tokens(world):
    """``train.serve_step.generate`` with a sharded ``ctx`` (its prefill
    step, the sampled tokens laid out for the decode steps) on (2, 2)
    under ``"seq2d"``: every rank's greedy tokens are the unsharded run's
    (reduced gemma3-1b)."""
    ranks, _ = world
    for r in ranks:
        got, want = r["generate"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", OTHERS)
def test_the_other_families_refuse_a_sharded_context(arch):
    import torch

    from repro_torch.models import seeded_numpy_params
    from repro_torch.utils.tree import tree_map

    cfg = reduced(get_arch(arch))
    ctx = make_ctx(False, tp_size=2, dp_size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        check_mesh_serving(cfg, ctx)
    if arch == "xlstm-125m":   # the entry points refuse before any work
        model = DecoderLM.from_tree(cfg, tree_map(
            torch.from_numpy, seeded_numpy_params(cfg, 0)))
        toks = torch.zeros((1, 4), dtype=torch.int32)
        with pytest.raises(NotImplementedError):
            prefill(model, toks, ctx=ctx)
        with pytest.raises(NotImplementedError):
            decode_step(model, [], toks[:, :1], 4, ctx=ctx)
