"""Print how far a bf16 prefill of a pinned LM case lies from the f32 one,
in the JAX package and in the port, on the CPU: the same weights
(``acceptance.lm_case_inputs``), tokens and memory in both packages.

For each case (xlstm-125m's ``serve_xlstm`` by default: B = 2 prompts of
600 ids, the whole arch) it prints one JSON line with the largest
absolute difference of the last token's logits between

- the JAX package's bf16 and f32 prefills (``jax_bf16_vs_f32``),
- the port's bf16 and f32 prefills (``port_bf16_vs_f32``),
- the port's and the JAX package's bf16 prefills (``port_vs_jax_bf16``),
- the port's and the JAX package's f32 prefills (``port_vs_jax_f32``),

and the largest |logit| (``logit_scale``). ``chip_smoke.py``'s
``serve_xlstm`` pins report the port's bf16 distance on the card for the
same case (``bf16_prefill_vs_f32_max_abs``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bf16_distance.py \
        [case ...]

Not a test module: xlstm-125m takes ~2 min on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import prefill as jax_prefill
from repro.sharding.ctx import ShardCtx

from repro_torch.configs import acceptance as A
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models.model import prefill


def distances(case: str) -> dict:
    cfg, tree, toks, memory = A.lm_case_inputs(case)
    _, _, prompt, _, _ = A.lm_case(case)
    toks = toks[:, :prompt]
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in memory.items()}}
    extras = {k: torch.tensor(v) for k, v in memory.items()}
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_get_arch(cfg.name),
                                   n_layers=cfg.n_layers, dtype=dtype)
        run = jax.jit(lambda p, b: jax_prefill(p, b, jcfg,
                                               ShardCtx(enabled=False))[0])
        out["jax", dtype] = np.asarray(run(params, batch))
        jax.clear_caches()
        model = lm_params_from_numpy(
            tree, dataclasses.replace(cfg, dtype=dtype), "cpu")
        out["port", dtype] = prefill(model, torch.tensor(toks),
                                     extras=extras)[0].numpy()
        del model

    def gap(a, b):
        return float(np.abs(out[a] - out[b]).max())

    return {"case": case, "arch": cfg.name, "batch": toks.shape[0],
            "prompt": prompt,
            "jax_bf16_vs_f32": gap(("jax", "bfloat16"), ("jax", "float32")),
            "port_bf16_vs_f32": gap(("port", "bfloat16"),
                                    ("port", "float32")),
            "port_vs_jax_bf16": gap(("port", "bfloat16"),
                                    ("jax", "bfloat16")),
            "port_vs_jax_f32": gap(("port", "float32"), ("jax", "float32")),
            "logit_scale": float(np.abs(out["jax", "float32"]).max())}


def main(argv: list[str]) -> int:
    for case in argv or [A.XLSTM_CASE]:
        t0 = time.perf_counter()
        rec = distances(case)
        print(json.dumps({**rec, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
