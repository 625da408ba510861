"""The full-width serving cases on the CPU: the JAX package gives the
values pinned in ``repro_torch.configs.acceptance``, and the port meets
them with ``check_lm(..., "float32")``.

- ``serve_gemma3_1b``: gemma3-1b (26 layers, d_model 1152, vocab 262144;
  999,826,048 parameters) at ``dtype="float32"``, weights from
  ``seeded_numpy_params(cfg, 0)``; B = 2 prompts of 1024 ids, then 8
  teacher-forced decode steps. About 4 GB of weights; one run of each
  package takes about half a minute here.
- ``serve_jamba_1l``: one full-width layer of the jamba hybrid without its
  experts (a Mamba mixer + the dense MLP; 2,098,077,696 parameters) at
  ``dtype="float32"``, weights from ``seeded_numpy_params(cfg, 0)``; B = 2
  prompts of 640 ids (2.5 of the JAX scan's 256-step chunks), then 8
  teacher-forced decode steps. About 8.4 GB of weights (42 s to draw); the
  JAX package's run peaks near 20 GB of RSS and takes about 20 s here.

- ``serve_mixtral_1l``: one full-width layer of mixtral-8x22b (8
  experts of d_ff 16384, top-2; 2,906,720,256 parameters) at
  ``dtype="float32"``, weights from ``seeded_numpy_params(cfg, 0)``; B = 2
  prompts of 640 ids (C = 400 of the prefill's 2,560 slots an expert),
  then 8 teacher-forced decode steps; the slots each step dropped are
  pinned too. About 11.6 GB of weights; the JAX package's arrays are
  freed before the port runs.

- ``serve_xlstm``, ``serve_whisper``, ``serve_vlm``
  (``acceptance.LAST_CASES``): the whole xlstm-125m (B = 2 prompts of 600
  ids, the mLSTM's padded last chunk), the whole whisper-small (B = 2, its
  1,500 audio frames, prompts of 64 ids) and llama-3.2-vision-11b cut to
  its first 5 layers (4 self-attention layers and the ``CROSS`` layer with
  ``xgate`` opened to ``acceptance.VLM_XGATE``; B = 1, 1,601 vision tokens,
  a prompt of 1,632 ids), each with 4 decode steps, the memory from
  ``acceptance.lm_memory``. The JAX package's attention is its
  ``attention_full`` here (``ShardCtx(enabled=False)``): its Pallas
  kernel refuses memories of 1,601 and 1,500 keys. The VLM's 8.7 GB of
  weights take about 50 s to draw.

The weights are held for one case at a time (``_weights``: drawing a
case's drops the other's), and the port's model shares them without a
copy. The cases stay in this one file, so that a run split by file never
holds two at once.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import prefill as jax_prefill
from repro.models.model import decode_step as jax_decode_step
from repro.sharding.ctx import ShardCtx

from _torch_moe_ref import jax_dropped_slots

from repro_torch import kernels
from repro_torch.configs import acceptance as A
from repro_torch.interop import lm_params_from_numpy

CTX = ShardCtx(enabled=False, attention_impl="pallas")


_HELD: dict = {}     # the one case whose weights are alive


def _weights(case: str):
    """(config, numpy weights, tokens) of ``case``, made once; making one
    case's frees the other's."""
    if case not in _HELD:
        _HELD.clear()
        cfg, tree, toks, _ = A.lm_case_inputs(case)
        _HELD[case] = cfg, tree, toks
    return _HELD[case]


@pytest.fixture
def weights():
    return _weights(A.LM_CASE)


@pytest.fixture
def jamba_weights():
    return _weights(A.JAMBA_CASE)


@pytest.fixture
def mixtral_weights():
    return _weights(A.MIXTRAL_CASE)


def _jax_logits(jcfg, tree, toks, prompt, decode, ctx, memory=None):
    """The JAX package's prefill (with the numpy ``memory``, if any) +
    teacher-forced decode steps."""
    params = jax.tree.map(jnp.asarray, tree)
    extras = {k: jnp.asarray(v) for k, v in (memory or {}).items()}
    run_prefill = jax.jit(lambda p, t, e: jax_prefill(
        p, {"tokens": t, **e}, jcfg, ctx, cache_seq_len=prompt + decode))
    run_decode = jax.jit(lambda p, c, t, n: jax_decode_step(
        p, c, t, n, jcfg, ctx))
    logits, cache = run_prefill(params, jnp.asarray(toks[:, :prompt]),
                                extras)
    out = [np.asarray(logits)]
    for i in range(decode):
        pos = prompt + i
        logits, cache = run_decode(params, cache,
                                   jnp.asarray(toks[:, pos:pos + 1]),
                                   jnp.int32(pos))
        out.append(np.asarray(logits))
    return out


def test_jax_package_gives_the_pins(weights):
    _, tree, toks = weights
    jcfg = dataclasses.replace(jax_get_arch(A.LM_ARCH), dtype="float32")
    out = _jax_logits(jcfg, tree, toks, A.LM_PROMPT, A.LM_DECODE, CTX)
    got = A.lm_summary(out)
    assert got["argmax"] == A.PINNED_LM["argmax"]
    A.check_lm(got, "float32")


def test_port_on_the_cpu_meets_the_pins(weights):
    cfg, tree, toks = weights
    model = lm_params_from_numpy(tree, cfg, "cpu")
    # the model shares the numpy weights: no 4 GB copy
    assert model.emb.data_ptr() == tree["emb"].ctypes.data
    kernels.reset_launches()
    logits = A.run_lm(model, torch.tensor(toks))
    assert kernels.LAUNCHES["flash_attn"] == 0     # the CPU path
    assert len(logits) == 1 + A.LM_DECODE
    assert all(x.shape == (A.LM_BATCH, cfg.vocab) and x.dtype == torch.float32
               and bool(torch.isfinite(x).all()) for x in logits)
    report = A.check_lm(A.lm_summary([x.numpy() for x in logits]), "float32")
    assert report["argmax_agree"] == report["argmax_total"]


def test_jax_package_gives_the_jamba_pins(jamba_weights):
    _, tree, toks = jamba_weights
    jcfg = dataclasses.replace(jax_get_arch(A.JAMBA_ARCH),
                               moe=JaxMoEConfig(), n_layers=1,
                               dtype="float32")
    out = _jax_logits(jcfg, tree, toks, A.JAMBA_PROMPT, A.JAMBA_DECODE,
                      ShardCtx(enabled=False))
    got = A.lm_summary(out)
    assert got["argmax"] == A.PINNED_JAMBA["argmax"]
    A.check_lm(got, "float32", pins=A.PINNED_JAMBA, case=A.JAMBA_CASE)


def test_port_on_the_cpu_meets_the_jamba_pins(jamba_weights):
    cfg, tree, toks = jamba_weights
    model = lm_params_from_numpy(tree, cfg, "cpu")
    assert model.emb.data_ptr() == tree["emb"].ctypes.data   # no copy
    assert model.layers[0].kind == "mamba"
    kernels.reset_launches()
    logits = A.run_lm(model, torch.tensor(toks), A.JAMBA_PROMPT,
                      A.JAMBA_DECODE)
    assert kernels.LAUNCHES["selective_scan"] == 0     # the CPU path
    assert len(logits) == 1 + A.JAMBA_DECODE
    assert all(x.shape == (A.JAMBA_BATCH, cfg.vocab)
               and x.dtype == torch.float32
               and bool(torch.isfinite(x).all()) for x in logits)
    report = A.check_lm(A.lm_summary([x.numpy() for x in logits]),
                        "float32", pins=A.PINNED_JAMBA, case=A.JAMBA_CASE)
    assert report["argmax_agree"] == report["argmax_total"]


def mixtral_jax_summary(tree, toks) -> dict:
    """``serve_mixtral_1l`` on the JAX package: ``lm_summary`` of its
    logits with the slots its one MoE layer dropped at each step. Its
    arrays are freed on return."""
    jcfg = dataclasses.replace(jax_get_arch(A.MIXTRAL_ARCH), n_layers=1,
                               dtype="float32")
    ctx = ShardCtx(enabled=False, attention_impl="pallas",
                   block_q=A.MIXTRAL_BLOCK, block_k=A.MIXTRAL_BLOCK)
    with jax_dropped_slots() as drops:
        out = _jax_logits(jcfg, tree, toks, A.MIXTRAL_PROMPT,
                          A.MIXTRAL_DECODE, ctx)
        jax.effects_barrier()
    jax.clear_caches()
    gc.collect()
    return A.lm_summary(out, [[d] for d in drops])


def test_jax_package_gives_the_mixtral_pins(mixtral_weights):
    _, tree, toks = mixtral_weights
    got = mixtral_jax_summary(tree, toks)
    assert got["argmax"] == A.PINNED_MIXTRAL["argmax"]
    assert got["dropped"] == A.PINNED_MIXTRAL["dropped"]
    A.check_lm(got, "float32", pins=A.PINNED_MIXTRAL, case=A.MIXTRAL_CASE)


def test_port_on_the_cpu_meets_the_mixtral_pins(mixtral_weights):
    cfg, tree, toks = mixtral_weights
    model = lm_params_from_numpy(tree, cfg, "cpu")
    assert model.emb.data_ptr() == tree["emb"].ctypes.data   # no copy
    assert model.layers[0].is_moe
    kernels.reset_launches()
    dropped = []
    logits = A.run_lm(model, torch.tensor(toks), A.MIXTRAL_PROMPT,
                      A.MIXTRAL_DECODE, dropped=dropped)
    assert kernels.LAUNCHES["flash_attn"] == 0     # the CPU path
    assert len(logits) == 1 + A.MIXTRAL_DECODE
    assert all(x.shape == (A.MIXTRAL_BATCH, cfg.vocab)
               and x.dtype == torch.float32
               and bool(torch.isfinite(x).all()) for x in logits)
    report = A.check_lm(A.lm_summary([x.numpy() for x in logits], dropped),
                        "float32", pins=A.PINNED_MIXTRAL, case=A.MIXTRAL_CASE)
    assert report["argmax_agree"] == report["argmax_total"]


# (case, package): each case's two tests run one after the other, so its
# weights are drawn once
LAST = [(case, side) for case in A.LAST_CASES for side in ("jax", "port")]


@pytest.mark.parametrize("case,side", LAST, ids=[f"{c}-{s}" for c, s in LAST])
def test_the_last_families_meet_their_pins(case, side):
    """The JAX package gives ``acceptance.PINNED_CASES[case]``, and the port
    on the CPU meets them: every argmax id, the pinned values within the
    case's tolerance (``check_lm``), the flash_attn wrapper on its plain
    version."""
    cfg, tree, toks = _weights(case)
    _, batch, prompt, decode, _ = A.lm_case(case)
    memory = A.lm_memory(cfg, batch)
    pins = A.PINNED_CASES[case]
    if side == "jax":
        jcfg = dataclasses.replace(jax_get_arch(cfg.name),
                                   n_layers=cfg.n_layers, dtype="float32")
        out = _jax_logits(jcfg, tree, toks, prompt, decode,
                          ShardCtx(enabled=False), memory)
        jax.clear_caches()
        gc.collect()
        got = A.lm_summary(out)
    else:
        model = lm_params_from_numpy(tree, cfg, "cpu")
        assert model.emb.data_ptr() == tree["emb"].ctypes.data   # no copy
        kernels.reset_launches()
        logits = A.run_lm(model, torch.tensor(toks), prompt, decode,
                          extras={k: torch.tensor(v)
                                  for k, v in memory.items()})
        assert sum(kernels.LAUNCHES.values()) == 0     # the CPU path
        assert len(logits) == 1 + decode
        assert all(x.shape == (batch, cfg.vocab) and x.dtype == torch.float32
                   and bool(torch.isfinite(x).all()) for x in logits)
        got = A.lm_summary([x.numpy() for x in logits])
    assert got["argmax"] == pins["argmax"]
    report = A.check_lm(got, "float32", pins=pins, case=case)
    assert report["argmax_agree"] == report["argmax_total"]
