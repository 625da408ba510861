"""The port's ``make_train_step`` against the JAX package's, on the CPU,
step for step, on a config whose stack has both a body and a tail.

The config is gemma3-1b at ``reduced()`` widths with a two-layer pattern
(a sliding-window layer of 16, then a global one) over 5 layers: two
superblocks in ``body`` (leaves stacked (2, ...)) and one ``tail`` layer.
So a body norm scale is (2, 64) and a tail one (64,): the JAX package's
optimizers decide by the stored leaf's rank, AdamW decays the first and
not the second, and Adafactor factors the first and clips by each stacked
leaf's RMS. The JAX side is its ``make_train_step`` under ``jax.jit``
with ``attention_impl="pallas"`` (interpret mode); both start from the
JAX package's ``init_params`` and take the same seeded batches.

Measured over the two steps of each variant below: params within 1.3e-6
and optimizer state within 6.4e-6 of the JAX package's (relative to a
leaf's largest value; Adafactor's factors at step 1), loss and
``grad_norm`` within 2.4e-7; held to ``TOL`` = 1e-5. AdamW takes ``eps`` = 1e-3 here:
at its first step ``m / sqrt(v)`` is ``g / |g|``, so with the default
1e-8 a gradient of order 1e-9, whose sign the two packages' rounding can
disagree on, would move its parameter by +-lr either way. With int8
compression a few elements land one quantization step apart (``_close``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs.base import ATTN, ATTN_LOCAL
from repro.models import init_params as jax_init_params
from repro.optim import Adafactor as JaxAdafactor
from repro.optim import AdamW as JaxAdamW
from repro.sharding.ctx import ShardCtx
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.configs import get_arch, reduced
from repro_torch.interop import tree_from_numpy
from repro_torch.models import spec
from repro_torch.optim import Adafactor, AdamW
from repro_torch.train import make_train_step
from repro_torch.utils.tree import tree_leaves_with_names

CTX = ShardCtx(enabled=False, attention_impl="pallas")
STACK = dict(block_pattern=(ATTN_LOCAL, ATTN), n_layers=5, swa_window=16)
B, S = 4, 32
TOL = 1e-5
FLIP_SHARE, FLIP_TOL = 1e-3, 2 / 127
STEPS = 2
OPTIMIZERS = {
    "adamw": (dict(lr=1e-3, eps=1e-3, weight_decay=0.1), AdamW, JaxAdamW),
    "adafactor": (dict(lr=1e-2, weight_decay=0.1), Adafactor, JaxAdafactor),
}
# (optimizer, make_train_step keywords)
VARIANTS = {
    "adamw": ("adamw", {}),
    "adafactor": ("adafactor", {}),
    "microbatches2": ("adamw", dict(microbatches=2)),
    "int8": ("adamw", dict(compress="int8")),
}


def configs():
    return (dataclasses.replace(jax_reduced(jax_get_arch("gemma3-1b")),
                                **STACK),
            dataclasses.replace(reduced(get_arch("gemma3-1b")), **STACK))


def batches(cfg, n: int):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


def _close(got, want, what: str, flips: bool = False):
    """Leaf by leaf within TOL (and TOL x the leaf's largest value). With
    ``flips`` (int8 compression), up to FLIP_SHARE of a leaf's elements
    may be off by up to FLIP_TOL x its largest value: where the two
    packages' gradients straddle a rounding edge of the int8 grid, one
    element lands a quantization step away, 1/127 of the largest gradient
    (up to 2/127 of v's largest value, v holding g**2). Measured: 1
    element of 16,384 at step 0, its m off by 1/127 of the leaf's
    largest, its param by 3.9e-4."""
    want = dict(tree_leaves_with_names(jax.device_get(want)))
    got = dict(tree_leaves_with_names(got))
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w, g = np.asarray(w), got[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        if flips:
            off = np.abs(g - w) > TOL * np.abs(w) + TOL * scale
            assert off.mean() <= FLIP_SHARE, f"{what} {name}: {off.mean()}"
            assert np.abs(g - w).max() <= FLIP_TOL * scale, f"{what} {name}"
            continue
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=f"{what} {name}")


def test_the_config_has_a_body_and_a_tail():
    period, R, n_tail = spec.layout(configs()[1])
    assert (period, R, n_tail) == (2, 2, 1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_the_jax_package(variant):
    opt_name, kw = VARIANTS[variant]
    opt_kw, Opt, JaxOpt = OPTIMIZERS[opt_name]
    jcfg, tcfg = configs()
    params = jax_init_params(jcfg, jax.random.key(0))
    jopt = JaxOpt(**opt_kw)
    jstate = {"params": params, "opt": jopt.init(params),
              "step": jnp.int32(0)}
    state = tree_from_numpy(jax.device_get(jstate), "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, CTX, **kw))
    step = make_train_step(tcfg, Opt(**opt_kw), **kw)
    flips = kw.get("compress") == "int8"
    # int8: one step, as the second would compound the first's flips
    for i, batch in enumerate(batches(tcfg, 1 if flips else STEPS)):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                       err_msg=f"step {i}: {k}")
        assert float(m["skipped"]) == 0.0
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        _close(state["params"], jstate["params"], f"step {i}: params", flips)
        _close(state["opt"], jstate["opt"], f"step {i}: opt", flips)


def _stacked_tree():
    """A body norm (R, d), a tail norm (d,) and a body matrix, by their
    JAX names, from ``init_params``-like values."""
    rng = np.random.default_rng(2)
    return {"body": [{"ln1": 1.0 + 0.1 * rng.standard_normal((2, 8)),
                      "wq": rng.standard_normal((2, 8, 4))}],
            "tail": [{"ln1": 1.0 + 0.1 * rng.standard_normal(8)}]}


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_stacked_leaf_rules(opt_name):
    """The decay, factoring and clipping rules read the stored leaf: a
    body norm (R, d) is decayed and factored as a matrix, a tail norm (d,)
    is not; Adafactor clips each stacked leaf by its whole RMS. Equal to
    the JAX package's update on the same tree, gradients and step."""
    opt_kw, Opt, JaxOpt = OPTIMIZERS[opt_name]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        _stacked_tree())
    grads = jax.tree.map(lambda a: np.asarray(
        np.random.default_rng(a.size).standard_normal(a.shape), np.float32),
        tree)
    jopt, opt = JaxOpt(**opt_kw), Opt(**opt_kw)
    jp = jax.tree.map(jnp.asarray, tree)
    jnew, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jopt.init(jp),
                            jp, jnp.int32(3))
    tp = tree_from_numpy(tree, "cpu")
    st = opt.init(tp)
    if opt_name == "adafactor":
        assert tuple(st["f"]["body"][0]["ln1"]["vr"].shape) == (2,)
        assert tuple(st["f"]["body"][0]["ln1"]["vc"].shape) == (8,)
        assert sorted(st["f"]["tail"][0]["ln1"]) == ["v"]
    new, st = opt.update(tree_from_numpy(grads, "cpu"), st, tp,
                         torch.tensor(3, dtype=torch.int32))
    _close(new, jnew, "params")
    _close(st, jst, "state")
    # decay: zero gradients move the stacked body norm, not the tail's
    zero = tree_from_numpy(jax.tree.map(np.zeros_like, tree), "cpu")
    moved, _ = Opt(**{**opt_kw, "lr": 1.0}).update(
        zero, opt.init(tp), tp, torch.tensor(0, dtype=torch.int32))
    assert not torch.equal(moved["body"][0]["ln1"], tp["body"][0]["ln1"])
    assert torch.equal(moved["tail"][0]["ln1"], tp["tail"][0]["ln1"])


def test_non_finite_batch_skips_the_step():
    """A NaN in the VLM's vision tokens: the step reports ``skipped`` 1,
    keeps params and optimizer state bit for bit and still advances."""
    from repro_torch.train import create_train_state

    cfg = reduced(get_arch("llama-3.2-vision-11b"))
    opt = AdamW(lr=1e-3)
    state = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                               "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S + 1),
                                         dtype=np.int32))
    vision = torch.from_numpy(0.02 * rng.standard_normal(
        (2, cfg.n_vision_tokens, cfg.d_model), np.float32))
    vision[1, 2, 3] = float("nan")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "vision": vision}
    new, m = make_train_step(cfg, opt)(state, batch)
    assert float(m["skipped"]) == 1.0
    assert not np.isfinite(float(m["loss"]))
    assert int(new["step"]) == 1
    for what in ("params", "opt"):
        old = dict(tree_leaves_with_names(state[what]))
        for name, x in tree_leaves_with_names(new[what]):
            assert torch.equal(x, old[name]), f"{what} {name}"


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, their launch stood in for on the CPU
def _grads(fn, inputs, seed: int = 0):
    """Gradients of a fixed random projection of ``fn(*inputs)``'s
    outputs with respect to ``inputs``."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum()
               for o in outs)
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("kernel", ["flash_attn", "mamba_scan"])
def test_kernel_functions_take_the_plain_vjp(kernel, monkeypatch):
    """Each kernel's ``autograd.Function`` with its launch replaced by the
    plain version (the card's kernel matches it; ``chip_smoke.py`` holds
    them): its gradients equal plain autograd's, its backward launches
    nothing, and its forward runs with recording off."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attn as pfa
    from repro_torch.kernels import selective_scan as pss

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    calls = []
    if kernel == "flash_attn":
        inputs = (t(2, 12, 4, 16), t(2, 12, 2, 16), t(2, 12, 2, 16))
        kw = dict(causal=True, window=5)

        def stand_in(*a):
            calls.append(torch.is_grad_enabled())
            return pfa.attention_torch(*a[:3], causal=a[3], window=a[4])

        monkeypatch.setattr(pfa, "_launch", stand_in)
        fn = lambda q, k, v: pfa.FlashAttention.apply(  # noqa: E731
            q, k, v, kw["causal"], kw["window"])
        plain = lambda q, k, v: pfa.attention_torch(q, k, v, **kw)  # noqa
    else:
        A = -torch.arange(1, 5, dtype=torch.float32).repeat(6, 1)
        inputs = (t(2, 7, 6), t(2, 7, 6), t(6), A, t(2, 7, 4), t(2, 7, 4),
                  t(2, 7, 6), t(6))
        plain = pss.mamba_scan_torch

        def stand_in(*a):
            calls.append(torch.is_grad_enabled())
            return plain(*a)

        monkeypatch.setattr(pss, "_launch_mamba", stand_in)
        fn = pss.MambaScan.apply
    before = dict(kernels.LAUNCHES)
    got = _grads(fn, inputs)
    want = _grads(plain, inputs)
    assert calls == [False]            # one forward, recording off
    assert kernels.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", ["flash_attn", "selective_scan",
                                    "mamba_scan"])
def test_raw_launch_refuses_recorded_tensors(kernel):
    """A kernel's raw launch on tensors autograd records raises instead
    of handing back an output with no gradient (``selective_scan``, which
    nothing differentiates, has no ``Function`` and so always raises)."""
    from repro_torch import kernels

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"^{kernel}: .*gradients"):
        kernels.refuse_autograd(kernel, x.detach(), x)
    with torch.no_grad():
        kernels.refuse_autograd(kernel, x)
    kernels.refuse_autograd(kernel, x.detach())
