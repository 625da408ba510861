"""``serve_gemma3_1b`` at full width and full depth on the CPU: the JAX
package gives the values pinned in ``repro_torch.configs.acceptance``, and
the port meets them with ``check_lm(..., "float32")``.

gemma3-1b (26 layers, d_model 1152, vocab 262144; 999,826,048 parameters)
at ``dtype="float32"``, weights from ``seeded_numpy_params(cfg, 0)``; B = 2
prompts of 1024 ids, then 8 teacher-forced decode steps. The weights are
made once for the module (about 4 GB, shared by the port's model without a
copy); one run of each package takes about half a minute here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import prefill as jax_prefill
from repro.models.model import decode_step as jax_decode_step
from repro.sharding.ctx import ShardCtx

from repro_torch import kernels
from repro_torch.configs import acceptance as A
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import seeded_numpy_params

CTX = ShardCtx(enabled=False, attention_impl="pallas")


@pytest.fixture(scope="module")
def weights():
    cfg = A.lm_config("float32")
    return cfg, seeded_numpy_params(cfg, A.LM_SEED), A.lm_tokens(cfg)


def test_jax_package_gives_the_pins(weights):
    _, tree, toks = weights
    jcfg = dataclasses.replace(jax_get_arch(A.LM_ARCH), dtype="float32")
    S, N = A.LM_PROMPT, A.LM_DECODE
    params = jax.tree.map(jnp.asarray, tree)
    run_prefill = jax.jit(lambda p, t: jax_prefill(
        p, {"tokens": t}, jcfg, CTX, cache_seq_len=S + N))
    run_decode = jax.jit(lambda p, c, t, n: jax_decode_step(
        p, c, t, n, jcfg, CTX))
    logits, cache = run_prefill(params, jnp.asarray(toks[:, :S]))
    out = [np.asarray(logits)]
    for i in range(N):
        logits, cache = run_decode(params, cache,
                                   jnp.asarray(toks[:, S + i:S + i + 1]),
                                   jnp.int32(S + i))
        out.append(np.asarray(logits))
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
