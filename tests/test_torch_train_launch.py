"""The port's LM training plumbing against the JAX package's, on the
CPU: the synthetic corpus, the schedules, the optimizers' states, exact
resume within the port and across the two packages, the example, and the
training pins' generator at reduced widths.

Tolerances, each from its measured distance:
- ``lm_batch_at``: tokens and labels bit for bit; the VLM's and
  whisper's extras (``0.02 * normal``): the normal under them within 3
  ulps, the distance of the port's ``prng.normal`` from JAX's (XLA's
  ``erfinv`` polynomial rounds differently; ``tests/test_torch_rl_prng.py``;
  at most 3 over 2**20 values of each of 20 keys), and each package's
  scaling of its own normal exactly. (The scaled values themselves can
  part by 4 ulps where the scaling crosses a binade edge, so they are not
  held in ulps.) A draw made a block of rows at a time equals the whole
  draw bit for bit.
- the schedules: within one f32 ulp of the peak rate of the JAX
  package's jitted values (measured: 9.1e-12 at 3e-4, 0.31 ulp of the
  peak; ``torch.cos`` and XLA's are an ulp apart, which ``1 + cos``
  makes several ulps of the small rates at the end of the cosine).
- AdamW on a schedule and Adafactor: params and states within 1e-6 of the
  JAX package's over 3 updates of the same gradients.
- resume within the port: bit for bit; across the packages: a state the
  JAX package's launcher checkpointed resumes in the port's, and the
  next step's loss and grad norm are within 1e-5 and its params and
  moments within 1e-5 of the leaf's largest value of the JAX launcher's
  own next step.
- the pins' generator at reduced widths: the port within
  ``acceptance.TRAIN_TOLS`` of the JAX package's run.
"""

import dataclasses
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.data.synth_lm import lm_batch_at as jax_lm_batch_at
from repro.optim import Adafactor as JaxAdafactor
from repro.optim import AdamW as JaxAdamW
from repro.optim import constant as jax_constant
from repro.optim import cosine_warmup as jax_cosine_warmup

from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import acceptance as A
from repro_torch.configs import get_arch, reduced
from repro_torch.data.synth_lm import lm_batch_at
from repro_torch.interop import tree_from_numpy, tree_to_numpy
from repro_torch.models import seeded_numpy_params
from repro_torch.optim import (
    Adafactor,
    AdamW,
    constant,
    cosine_warmup,
    default_optimizer_for,
    get_optimizer,
)
from repro_torch.train import abstract_train_state, create_train_state
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_leaves_with_names

sys.path.insert(0, os.path.dirname(__file__))
import torch_train_pins  # noqa: E402

NORMAL_ULPS = 3
OPT_TOL = 1e-6
RESUME_TOL = 1e-5


# ---------------------------------------------------------------------------
# the corpus
@pytest.mark.parametrize("kw", [
    dict(step=0, vocab=512, batch=2, seq_len=64, seed=0),
    dict(step=5, vocab=1000, batch=4, seq_len=33, seed=7),
    dict(step=2, vocab=777, batch=4, seq_len=16, seed=3, host_id=1,
         n_hosts=2),
    dict(step=1, vocab=512, batch=2, seq_len=16, seed=0,
         extras={"vision": (16, 64), "audio": (24, 64)}),
], ids=["plain", "seed7", "host1of2", "extras"])
def test_lm_batch_at_matches_the_jax_package(kw):
    kw = dict(kw)
    step = kw.pop("step")
    want = jax_lm_batch_at(step, **kw)
    got = lm_batch_at(step, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # each extra is 0.02 * normal(fold_in(key, hash(name) % 2**31)) of the
    # step's key in both packages (hash is salted per process, so both
    # draws are made here)
    host = kw.get("host_id", 0)
    jkey = jax.random.fold_in(jax.random.fold_in(
        jax.random.key(kw["seed"]), step), host)
    pkey = prng.fold_in(prng.fold_in(prng.key_words(kw["seed"]), step), host)
    for k, shape in (kw.get("extras") or {}).items():
        shape = (kw["batch"],) + tuple(shape)
        jn = np.asarray(jax.random.normal(
            jax.random.fold_in(jkey, hash(k) % 2**31), shape))
        pn = prng.normal(torch.as_tensor(
            prng.fold_in(pkey, hash(k) % 2**31)), shape).numpy()
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      np.float32(0.02) * jn, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.float32(0.02) * pn, err_msg=k)
        ulp = np.spacing(np.abs(jn).astype(np.float32))
        assert np.all(np.abs(pn - jn) <= NORMAL_ULPS * ulp), k


@pytest.mark.parametrize("rows", [1, 7, 41])
def test_block_wise_draw_equals_the_whole_draw(rows, monkeypatch):
    """The rows drawn ``rows`` at a time (``BLOCK_VALUES`` cut to that
    many rows of the vocabulary) equal the draw made at once."""
    from repro_torch.data import synth_lm

    kw = dict(vocab=300, batch=2, seq_len=20, seed=4, device="cpu")
    whole = lm_batch_at(3, **kw)
    monkeypatch.setattr(synth_lm, "BLOCK_VALUES", rows * kw["vocab"])
    part = lm_batch_at(3, **kw)
    for k in whole:
        assert torch.equal(part[k], whole[k]), k


def test_host_shards_tile_the_global_batch():
    """Each host draws from its own key: two hosts' slices are the JAX
    package's, and differ from each other."""
    kw = dict(vocab=512, batch=4, seq_len=16, seed=0, n_hosts=2)
    a = lm_batch_at(0, host_id=0, device="cpu", **kw)["tokens"]
    b = lm_batch_at(0, host_id=1, device="cpu", **kw)["tokens"]
    assert a.shape == b.shape == (2, 16)
    assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# schedules and optimizers
@pytest.mark.parametrize("which", ["cosine", "cosine_floor", "constant"])
def test_schedules_match_the_jax_package(which):
    if which == "constant":
        got_f, want_f = constant(3e-4), jax_constant(3e-4)
    else:
        floor = 1e-5 if which == "cosine_floor" else 0.0
        got_f = cosine_warmup(3e-4, 5, 40, floor)
        want_f = jax_cosine_warmup(3e-4, 5, 40, floor)
    want_f = jax.jit(want_f)
    for step in range(0, 45):
        got = got_f(torch.tensor(step, dtype=torch.int32))
        want = np.float32(want_f(jnp.int32(step)))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= np.spacing(
            np.float32(3e-4)), step


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"body": [{"ln1": (1 + 0.1 * rng.standard_normal((3, 8))),
                      "wq": rng.standard_normal((3, 8, 6))}],
            "emb": rng.standard_normal((10, 8)),
            "tail": [{"ln1": 1 + 0.1 * rng.standard_normal(8)}]}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_states_match_the_jax_package(name):
    """Three updates on a cosine schedule: params and every state leaf."""
    kw = dict(lr=cosine_warmup(1e-2, 1, 3), weight_decay=0.05)
    jkw = dict(lr=jax_cosine_warmup(1e-2, 1, 3), weight_decay=0.05)
    opt, jopt = ((AdamW(**kw), JaxAdamW(**jkw)) if name == "adamw"
                 else (Adafactor(**kw), JaxAdafactor(**jkw)))
    params = _f32(_tree(0))
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        g = _f32(_tree(10 + step))
        jp, js = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), js, jp,
                                      jnp.int32(step))
        tp, ts = opt.update(tree_from_numpy(g, "cpu"), ts, tp,
                            torch.tensor(step, dtype=torch.int32))
    for got, want in ((tp, jp), (ts, js)):
        want = dict(tree_leaves_with_names(jax.device_get(want)))
        got = dict(tree_leaves_with_names(got))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                       rtol=OPT_TOL, atol=OPT_TOL, err_msg=k)


def test_get_optimizer_and_default():
    assert default_optimizer_for(99e9) == "adamw"
    assert default_optimizer_for(100e9) == "adafactor"
    assert isinstance(get_optimizer("adamw", lr=1.0), AdamW)
    assert isinstance(get_optimizer("adafactor"), Adafactor)
    with pytest.raises(KeyError):
        get_optimizer("sgd")


def test_abstract_train_state_mirrors_the_real_one():
    cfg = dataclasses.replace(reduced(get_arch("gemma3-1b")), n_layers=8)
    for opt in (AdamW(), Adafactor()):
        real = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                  "cpu")
        meta = abstract_train_state(cfg, opt)
        a = [(n, tuple(x.shape), x.dtype)
             for n, x in tree_leaves_with_names(real)]
        b = [(n, tuple(x.shape), x.dtype)
             for n, x in tree_leaves_with_names(meta)]
        assert a == b
        assert all(x.is_meta for _, x in tree_leaves_with_names(meta))


# ---------------------------------------------------------------------------
# the launcher: resume, across packages, the example
def _port_launch(tmp, *extra):
    from repro_torch.launch import train as port_train

    return port_train.main(["--arch", "qwen3-4b", "--reduced", "--batch",
                            "2", "--seq", "32", "--ckpt", str(tmp),
                            "--log-every", "1", "--warmup", "1",
                            "--device", "cpu", *extra])


def _state_like():
    cfg = reduced(get_arch("qwen3-4b"))
    return create_train_state(cfg, AdamW(), torch.Generator().manual_seed(1),
                              "cpu")


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run bit for bit
    (deterministic data, seekable corpus, checkpoint): the twin of the
    JAX package's ``tests/test_checkpoint.py::test_train_resume_is_exact``,
    every leaf of the state compared too."""
    from repro_torch.checkpoint import save
    from repro_torch.train import make_train_step

    cfg = reduced(get_arch("qwen3-4b"))
    opt = AdamW(lr=1e-3)
    state = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                               "cpu")
    step_fn = make_train_step(cfg, opt)

    def data(i):
        return lm_batch_at(i, vocab=cfg.vocab, batch=2, seq_len=32,
                           device="cpu")

    s = state
    for i in range(6):
        s, _ = step_fn(s, data(i))
    _, m = step_fn(s, data(6))

    s2 = state
    for i in range(3):
        s2, _ = step_fn(s2, data(i))
    save(str(tmp_path), 3, s2)
    s3 = restore(str(tmp_path), 3, state)
    for i in range(3, 6):
        s3, _ = step_fn(s3, data(i))
    _, m2 = step_fn(s3, data(6))
    assert float(m2["loss"]) == float(m["loss"])
    for (n, a), (_, b) in zip(tree_leaves_with_names(s),
                              tree_leaves_with_names(s3)):
        assert torch.equal(a, b), n


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's launcher trains 3 steps, checkpointing each; its
    checkpoint after step 2 goes to the port's launcher, which runs step
    3: the loss and grad norm, params and moments match the JAX run's
    own third step."""
    from repro.checkpoint import restore as jax_restore
    from repro.launch import train as jax_train

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    args = ["--arch", "qwen3-4b", "--reduced", "--batch", "2", "--seq",
            "32", "--log-every", "1", "--warmup", "1", "--steps", "3",
            "--ckpt-every", "1"]
    jhist = jax_train.main(args + ["--ckpt", str(jdir)])
    assert latest_step(str(jdir)) == 2
    pdir.mkdir()
    shutil.copytree(jdir / "step_0000000001", pdir / "step_0000000001")
    phist = _port_launch(pdir, "--steps", "3", "--ckpt-every", "1",
                         "--resume")
    assert [h["step"] for h in phist] == [2]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(phist[0][k], jhist[2][k], rtol=RESUME_TOL,
                                   err_msg=k)
    like = _state_like()
    got = dict(tree_leaves_with_names(restore(str(pdir), 2, like)))
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         tree_to_numpy(like))
    want = dict(tree_leaves_with_names(jax_restore(str(jdir), 2, jlike)))
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(want["step"]) == 3
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[n].numpy(), w, rtol=RESUME_TOL,
            atol=RESUME_TOL * max(float(np.abs(w).max()), 1e-30), err_msg=n)


def test_model_axis_is_refused():
    from repro_torch.launch import train as port_train

    with pytest.raises(ValueError, match="sharding"):
        port_train.main(["--arch", "qwen3-4b", "--reduced", "--model-axis",
                         "2", "--device", "cpu"])


def test_train_lm_example_tiny(tmp_path):
    from repro_torch.examples import train_lm

    hist = train_lm.main(["--tiny", "--device", "cpu", "--ckpt",
                          str(tmp_path / "ckpt")])
    assert [h["step"] for h in hist] == [0, 4, 9, 14, 19, 24, 29]
    assert all(np.isfinite(h["loss"]) and not h["skipped"] for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert latest_step(str(tmp_path / "ckpt")) == 29


# ---------------------------------------------------------------------------
# the training pins' generator
def test_train_pins_generator_at_reduced_width():
    """``torch_train_pins.jax_train_summary`` (the JAX package's run that
    makes ``PINNED_TRAIN``) and ``acceptance.run_train`` (the port's, as
    ``chip_smoke.py`` runs it) on gemma3-1b at ``reduced()`` widths with
    8 layers (a body and a tail), B 2, S 64: the port within
    ``TRAIN_TOLS`` of the JAX package (measured: metrics 3.5e-7, leaf sums
    1.9e-7, the changes' sums 6.3e-6)."""
    tcfg = dataclasses.replace(reduced(A.train_config()), n_layers=8)
    jcfg = dataclasses.replace(jax_reduced(torch_train_pins.jax_config()),
                               n_layers=8)
    kw = dict(steps=A.TRAIN_STEPS, batch=2, seq=64)
    pins = torch_train_pins.jax_train_summary(
        jcfg, seeded_numpy_params(tcfg, A.LM_SEED), **kw)
    got, _, _ = A.run_train(tcfg, seeded_numpy_params(tcfg, A.LM_SEED),
                            "cpu", **kw)
    report = A.check_train(got, pins)
    assert report["dist_loss"] <= A.TRAIN_TOLS["loss"]
    assert got["skipped"] == [0.0] * A.TRAIN_STEPS
