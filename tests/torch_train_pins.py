"""Print the LM training pins for ``repro_torch.configs.acceptance``: what
the JAX package gives on the CPU.

- ``PINNED_TRAIN``: ``acceptance.train_summary`` of TRAIN_STEPS steps of
  the JAX package's ``make_train_step`` (jitted, ``ShardCtx(enabled=False,
  attention_impl="pallas")``: the flash-attention kernel in interpret
  mode) with ``AdamW(lr=cosine_warmup(TRAIN_LR, TRAIN_WARMUP,
  TRAIN_STEPS))`` on gemma3-1b at full width in f32
  (``acceptance.train_config``), weights ``seeded_numpy_params(cfg,
  LM_SEED)``, batches from the JAX package's ``lm_batch_at``.
- With ``--port``, the same run on the port on the CPU afterwards, and its
  ``acceptance.train_distance`` from the pins (the measured distance that
  ``acceptance.TRAIN_TOLS`` is set from), on standard error.
- With ``--mesh``, ``PINNED_TRAIN_MESH`` instead: the same run of
  ``acceptance.train_mesh_config`` (gemma3-1b cut to its first
  ``TRAIN_MESH_LAYERS`` layers).
- With ``--family CASE``, one entry of ``PINNED_TRAIN_FAMILIES`` instead:
  the case of ``acceptance.TRAIN_FAMILY_LEAVES`` (mixtral's, jamba's or
  whisper's training on the JAX package, unsharded, with the case's
  ``dp_size``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_pins.py [--port]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_pins.py --mesh
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_pins.py \
        --family train_jamba_1l

Not a test module: at full width each package takes ~25 GB and ~5 min on
an 8-core CPU. It prints the assignment to paste into ``acceptance.py``
on standard output. ``tests/test_torch_train_launch.py`` runs
``jax_train_summary`` and the port at reduced widths.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jax_get_arch
from repro.data.synth_lm import lm_batch_at
from repro.optim import cosine_warmup, get_optimizer
from repro.sharding.ctx import ShardCtx
from repro.train.train_step import make_train_step

from repro_torch.configs import acceptance as A
from repro_torch.utils.tree import tree_leaves_with_names

CTX = ShardCtx(enabled=False, attention_impl="pallas")


def jax_config(dtype: str = "float32"):
    """The JAX package's config of ``acceptance.train_config``."""
    return dataclasses.replace(jax_get_arch(A.LM_ARCH), dtype=dtype)


def jax_train_summary(jcfg, tree: dict, *, steps: int = A.TRAIN_STEPS,
                      batch: int = A.TRAIN_BATCH,
                      seq: int = A.TRAIN_SEQ, optimizer: str = "adamw",
                      leaves=A.TRAIN_LEAVES, dp_size: int = 1,
                      attention_impl: str = "pallas") -> dict:
    """``acceptance.train_summary`` of ``leaves`` of the training case on
    the JAX package with config ``jcfg`` and ``optimizer`` ("adamw" or
    "adafactor"), from the numpy weights ``tree`` (emptied as they are
    carried over, to free them), the batches with their
    ``acceptance.train_extras``. ``dp_size``: the context's data-parallel
    degree, which sets an MoE layer's groups (nothing is sharded);
    ``attention_impl``: "pallas" (the kernel in interpret mode) or "xla"
    (its jnp attention, for memories its blocks do not divide)."""
    params0 = dict(tree_leaves_with_names(tree))
    params0 = {n: params0[n].copy() for n in leaves}
    params = jax.tree.map(jnp.asarray, tree)
    tree.clear()
    gc.collect()
    opt = get_optimizer(optimizer, lr=cosine_warmup(A.TRAIN_LR,
                                                     A.TRAIN_WARMUP, steps))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.int32(0)}
    del params
    ctx = dataclasses.replace(CTX, dp_size=dp_size,
                              attention_impl=attention_impl)
    step = jax.jit(make_train_step(jcfg, opt, ctx), donate_argnums=(0,))
    metrics, tokens = [], []
    for i in range(steps):
        b = lm_batch_at(i, vocab=jcfg.vocab, batch=batch, seq_len=seq,
                        seed=A.TRAIN_DATA_SEED)
        b.update({k: jnp.asarray(v)
                  for k, v in A.train_extras(jcfg, i, batch).items()})
        t0 = time.perf_counter()
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        tokens.append(np.asarray(b["tokens"]))
        print(f"jax step {i}: {time.perf_counter() - t0:.1f} s "
              f"{metrics[-1]}", file=sys.stderr)
    named = dict(tree_leaves_with_names(jax.device_get(state["params"])))
    return A.train_summary(metrics, tokens, params0,
                           {n: named[n] for n in leaves}, leaves)


def literal(got: dict) -> str:
    return "PINNED_TRAIN = " + json.dumps(got, indent=4)


def family(case: str) -> None:
    """Print ``"case": summary,`` for ``PINNED_TRAIN_FAMILIES``: the case
    of ``acceptance.TRAIN_FAMILY_LEAVES`` on the JAX package."""
    from repro.configs import get_arch as jax_get_arch_

    from repro_torch.models import seeded_numpy_params

    cfg = A.train_family_config(case)
    # the JAX package's config with the port's cuts (depth; jamba's dense
    # MLP), every width as published
    jcfg = dataclasses.replace(jax_get_arch_(cfg.name), n_layers=cfg.n_layers,
                               dtype=cfg.dtype, moe=dataclasses.replace(
                                   jax_get_arch_(cfg.name).moe,
                                   **dataclasses.asdict(cfg.moe)))
    t0 = time.perf_counter()
    got = jax_train_summary(jcfg, seeded_numpy_params(cfg, A.LM_SEED),
                            optimizer=A.TRAIN_FAMILY_OPTIMIZER,
                            leaves=A.TRAIN_FAMILY_LEAVES[case],
                            dp_size=A.TRAIN_FAMILY_DP,
                            attention_impl="xla" if cfg.enc_dec
                            else "pallas")
    print(f"{case}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(f'    "{case}": ' + json.dumps(got, indent=4) + ",", flush=True)


def main(argv) -> None:
    from repro_torch.models import seeded_numpy_params

    if argv[:1] == ["--family"]:
        family(argv[1])
        return
    if argv[:1] == ["--mesh"]:
        cfg = A.train_mesh_config()
        pins = jax_train_summary(
            dataclasses.replace(jax_config(), n_layers=cfg.n_layers),
            seeded_numpy_params(cfg, A.LM_SEED))
        print("PINNED_TRAIN_MESH = " + json.dumps(pins, indent=4),
              flush=True)
        return

    cfg = A.train_config()
    pins = jax_train_summary(jax_config(),
                             seeded_numpy_params(cfg, A.LM_SEED))
    print(literal(pins), flush=True)
    if "--port" in argv:
        gc.collect()
        t0 = time.perf_counter()
        got, _, _ = A.run_train(cfg, seeded_numpy_params(cfg, A.LM_SEED),
                                "cpu")
        print(json.dumps({"port_s": time.perf_counter() - t0,
                          "port": got,
                          "distance": A.train_distance(got, pins)}),
              file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
