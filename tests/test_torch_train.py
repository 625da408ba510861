"""The port's LM training forward and train step against the JAX
package's, on the CPU, for every arch at ``reduced()`` widths.

The weights are the JAX package's ``init_params``, carried across with
``interop.tree_from_numpy``; the batch (B 2, S 32, a ``-1`` label, and the
VLM's vision tokens or whisper's audio frames) comes from one seeded numpy
generator. The JAX side runs ``forward_train`` under
``jax.value_and_grad`` with ``attention_impl="pallas"`` (the
flash-attention kernel in interpret mode, its ``custom_vjp`` backward
through the jnp chunked attention); the port runs the kernels' plain
versions under autograd, as it does on the CPU.

- The loss and its metrics, and every gradient leaf by its JAX name.
  Measured: the loss within 5e-7 of the JAX package's, each gradient leaf
  within 7.2e-6 of it relative to the leaf's largest value (jamba, whose
  scan the JAX package sums in chunks); held to ``rtol`` = ``GRAD_TOL`` =
  1e-4 with ``atol`` = 1e-4 x the leaf's largest value.
- One ``make_train_step`` step (AdamW, clipping at 1.0) against the JAX
  package's ``clip_by_global_norm``, ``all_finite`` guard and
  ``AdamW.update`` applied to the same gradients (the port's, read back):
  new params, both moments, ``grad_norm`` and ``skipped`` within
  ``STEP_TOL`` = 1e-5.
- A bfloat16 model: the gradients land in the f32 masters.

The JAX package's ``make_train_step`` itself is held to the port's in
``tests/test_torch_train_step.py``.
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
from repro.models.model import forward_train as jax_forward_train
from repro.optim import AdamW as JaxAdamW
from repro.optim.base import clip_by_global_norm as jax_clip
from repro.sharding.ctx import ShardCtx
from repro.utils.tree import all_finite as jax_all_finite

from repro_torch.configs import arch_names, get_arch, reduced
from repro_torch.interop import tree_from_numpy
from repro_torch.models.model import forward_train
from repro_torch.optim import AdamW
from repro_torch.train import create_train_state, make_train_step
from repro_torch.utils.tree import (
    tree_leaves_with_names,
    tree_map_with_path_names,
)

CTX = ShardCtx(enabled=False, attention_impl="pallas")
B, S = 2, 32
LR = 1e-3
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
LOSS_TOL = 1e-6


def batch_for(cfg, seed: int = 0) -> dict:
    """numpy tokens and labels (one ``-1``), and the memory the model
    attends to."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    out["labels"][0, 3] = -1
    if cfg.n_vision_tokens:
        out["vision"] = 0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model), np.float32)
    if cfg.enc_dec:
        out["audio"] = 0.02 * rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model), np.float32)
    return out


def port_grads(params, batch, cfg):
    """(loss, metrics, {name: gradient}) of the port's forward_train."""
    names, leaves = zip(*tree_leaves_with_names(params))
    live = dict(zip(names, (x.detach().requires_grad_(True)
                            for x in leaves)))
    loss, metrics = forward_train(
        tree_map_with_path_names(lambda n, _: live[n], params), batch, cfg)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: torch.zeros_like(x) if g is None else g
        for (n, x), g in zip(live.items(), grads)}


@pytest.fixture(scope="module", params=arch_names())
def case(request):
    arch = request.param
    jcfg, tcfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    params = jax_init_params(jcfg, jax.random.key(0))
    batch = batch_for(tcfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_forward_train(p, b, jcfg, CTX), has_aux=True))
    (jloss, jmetrics), jgrads = vg(params, jax.tree.map(jnp.asarray, batch))
    host = jax.device_get(params)
    return dict(arch=arch, cfg=tcfg, host=host, batch=batch,
                jloss=float(jloss),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=dict(tree_leaves_with_names(jax.device_get(jgrads))))


def test_forward_train_loss_and_grads(case):
    cfg = case["cfg"]
    params = tree_from_numpy(case["host"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, metrics, grads = port_grads(params, batch, cfg)
    np.testing.assert_allclose(float(loss), case["jloss"], rtol=LOSS_TOL)
    for k, want in case["jmetrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    assert float(metrics["tokens"]) == B * S - 1      # the -1 label
    assert sorted(grads) == sorted(case["jgrads"])
    for name, want in case["jgrads"].items():
        want = np.asarray(want)
        got = grads[name].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale,
                                   err_msg=f"{case['arch']}: {name}")


@jax.jit
def _jax_step(params, grads, opt_state):
    """The JAX package's step body at step 0 on given gradients: clip,
    guard, AdamW update."""
    jopt = JaxAdamW(lr=LR)
    grads, gnorm = jax_clip(grads, 1.0)
    good = jax_all_finite(grads)
    new_p, new_opt = jopt.update(grads, opt_state, params, jnp.int32(0))
    keep = lambda n, o: jnp.where(good, n, o)  # noqa: E731
    return (jax.tree.map(keep, new_p, params),
            jax.tree.map(keep, new_opt, opt_state), gnorm, ~good)


def test_train_step_matches_the_jax_update(case):
    cfg = case["cfg"]
    params = tree_from_numpy(case["host"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    opt = AdamW(lr=LR)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    new, m = make_train_step(cfg, opt)(state, batch)
    _, _, grads = port_grads(params, batch, cfg)

    jparams = jax.tree.map(jnp.asarray, case["host"])
    jgrads = jax.tree.map(lambda p, n: jnp.asarray(grads[n].numpy()),
                          jparams, _names(jparams))
    want_p, want_opt, gnorm, skipped = _jax_step(
        jparams, jgrads, JaxAdamW(lr=LR).init(jparams))
    assert int(new["step"]) == 1
    assert float(m["skipped"]) == float(skipped) == 0.0
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm),
                               rtol=STEP_TOL)
    np.testing.assert_allclose(float(m["loss"]), case["jmetrics"]["loss"],
                               rtol=LOSS_TOL)
    for tree_got, tree_want, what in (
            (new["params"], want_p, "params"),
            (new["opt"]["m"], want_opt["m"], "m"),
            (new["opt"]["v"], want_opt["v"], "v")):
        want = dict(tree_leaves_with_names(jax.device_get(tree_want)))
        for name, got in tree_leaves_with_names(tree_got):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(want[name]), rtol=STEP_TOL,
                atol=STEP_TOL * float(np.abs(want[name]).max()),
                err_msg=f"{case['arch']}: {what} {name}")


def _names(tree):
    """``tree`` with each leaf replaced by its name."""
    names = iter(n for n, _ in tree_leaves_with_names(
        jax.tree.map(np.asarray, tree)))
    return jax.tree.map(lambda _: next(names), tree)


def test_bf16_gradients_land_in_the_f32_masters():
    """A bfloat16 model: the step casts every master inside autograd, so
    each gradient reaches its f32 master (the step changes every leaf the
    loss reads), and the state stays f32."""
    cfg = dataclasses.replace(reduced(get_arch("gemma3-1b")),
                              dtype="bfloat16")
    opt = AdamW(lr=LR)
    state = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                               "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    new, m = make_train_step(cfg, opt)(state, batch)
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["loss"]))
    old = dict(tree_leaves_with_names(state["params"]))
    for tree in (new["params"], new["opt"]["m"], new["opt"]["v"]):
        for name, x in tree_leaves_with_names(tree):
            assert x.dtype == torch.float32, name
    moved = {n: bool((x != old[n]).any())
             for n, x in tree_leaves_with_names(new["params"])}
    assert all(moved.values()), [n for n, v in moved.items() if not v]
    # the bf16 loss is the f32 model's to bf16 accuracy
    f32 = dataclasses.replace(cfg, dtype="float32")
    loss32, _ = forward_train(state["params"], batch, f32)
    np.testing.assert_allclose(float(m["loss"]), float(loss32), rtol=2e-2)
