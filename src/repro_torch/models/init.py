"""Parameters of the dense LMs, in the JAX package's tree layout
(``spec.model_param_specs``): ``emb``, ``final_ln``, ``head`` when the
embeddings are untied, ``body[p][name]`` stacked over the R superblocks and
``tail[j]``. ``model.DecoderLM.from_tree`` builds the model from either.

- ``init_params(cfg, generator)``: the port's own random init with an
  explicit ``torch.Generator``, for the CLI. It follows the JAX package's
  rules (norms ones, everything else a normal truncated to +-2 std with
  std ``1/sqrt(fan_in)``) but is not bitwise with ``jax.random``.
- ``seeded_numpy_params(cfg, seed)``: numpy weights that both packages
  can load, so that the tests and ``chip_smoke.py`` compute the same thing
  without JAX on the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec as S

NORMS = ("ln1", "ln2", "final_ln", "qn", "kn")


def _fan_in(shape) -> int:
    return max(shape[-2] if len(shape) >= 2 else shape[-1], 1)


def _unflatten(specs: Dict[str, Any], leaves: Dict[str, Any]) -> Dict[str, Any]:
    """``specs`` with each leaf replaced by ``leaves[name]``."""
    def build(path: str, node):
        if isinstance(node, dict):
            return {k: build(f"{path}/{k}" if path else k, v)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [build(f"{path}/{i}", v) for i, v in enumerate(node)]
        return leaves[path]

    return build("", specs)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random f32 parameters on ``device`` (the generator's device when
    None), leaf by leaf in the JAX package's flatten order."""
    device = torch.device(device or generator.device)
    specs = S.model_param_specs(cfg)
    leaves = {}
    for name, shape in S.leaves_with_names(specs):
        if name.rsplit("/", 1)[-1] in NORMS:
            leaves[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        leaves[name] = t.mul_(1.0 / math.sqrt(_fan_in(shape)))
    return _unflatten(specs, leaves)


def seeded_numpy_params(cfg: ModelConfig, seed: int) -> Dict[str, Any]:
    """f32 numpy weights in the JAX package's tree layout, from one
    ``np.random.default_rng(seed)``.

    Leaf order is the JAX package's flatten order (``jax.tree.leaves`` of
    ``model_param_specs``: dict keys sorted, lists in order): ``body``
    (position 0's leaves in sorted key order ``kn, ln1, ln2, qn, wg, wi,
    wk, wo, wo2, wq, wv``, then position 1's, ...), ``emb``, ``final_ln``,
    ``head`` (untied embeddings only), then ``tail`` (layer by layer, the
    same key order). The norms (``ln1``, ``ln2``, ``final_ln``, ``qn``,
    ``kn``) are ones and draw nothing; every other leaf, in that order, is
    ``rng.standard_normal(shape, float32) / sqrt(fan_in)`` with ``fan_in``
    the second-to-last dimension (the last for a vector), as the JAX
    package's ``init_params`` scales its draws.
    """
    rng = np.random.default_rng(seed)
    specs = S.model_param_specs(cfg)
    leaves = {}
    for name, shape in S.leaves_with_names(specs):
        if name.rsplit("/", 1)[-1] in NORMS:
            leaves[name] = np.ones(shape, np.float32)
            continue
        a = rng.standard_normal(shape, dtype=np.float32)
        a /= np.float32(math.sqrt(_fan_in(shape)))
        leaves[name] = a
    return _unflatten(specs, leaves)
