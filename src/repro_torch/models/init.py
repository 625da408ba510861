"""Parameters of the LMs, in the JAX package's tree layout
(``spec.model_param_specs``): ``emb``, ``final_ln``, ``head`` when the
embeddings are untied, ``body[p][name]`` stacked over the R superblocks and
``tail[j]``, and for an encoder-decoder ``encoder`` and ``xattn_body`` /
``xattn_tail``. ``model.DecoderLM.from_tree`` builds the model from either.

Both follow the JAX package's init rules (``models/init.py`` there):
norms (``ln1``, ``ln2``, ``lnx``, ``ln_inner``, ``final_ln``, ``qn``,
``kn``) and ``D_skip`` ones, ``conv_b``, the sLSTM's ``b`` and the VLM's
``xgate`` zeros (its cross-attention starts disabled: ``tanh(0)``),
``A_log`` the log of 1..d_state along its last axis, ``dt_b`` the inverse
softplus of a uniform draw in [1e-3, 1e-1]; every other leaf a normal
scaled by ``1/sqrt(fan_in)``.

- ``init_params(cfg, generator)``: the port's own random init with an
  explicit ``torch.Generator``, for the CLI and the full-width hybrid. Its
  normals are truncated to +-2 std, as the JAX package's are, but it is not
  bitwise with ``jax.random``.
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

NORMS = ("ln1", "ln2", "lnx", "ln_inner", "final_ln", "qn", "kn")
ZEROS = ("conv_b", "b", "xgate")
DT_MIN, DT_MAX = 1e-3, 1e-1     # the range of softplus(dt_b) at init


def _base(name: str) -> str:
    return name.rsplit("/", 1)[-1]


def _fixed(base: str, shape):
    """The value of a leaf that draws nothing (numpy f32), else None."""
    if base in NORMS or base == "D_skip":
        return np.ones(shape, np.float32)
    if base in ZEROS:
        return np.zeros(shape, np.float32)
    if base == "A_log":
        a = np.arange(1, shape[-1] + 1, dtype=np.float32)
        return np.log(np.broadcast_to(a, shape)).astype(np.float32)
    return None


def _fan_in(shape) -> int:
    return max(shape[-2] if len(shape) >= 2 else shape[-1], 1)


def _unflatten(specs: Dict[str, Any], leaves: Dict[str, Any],
               path: str = "") -> Dict[str, Any]:
    """``specs`` with each leaf replaced by ``leaves[name]``. A plain
    recursion: a nested function that called itself would hold ``leaves``
    in a reference cycle, so the weights would outlive the tree until a
    garbage collection."""
    if isinstance(specs, dict):
        return {k: _unflatten(v, leaves, f"{path}/{k}" if path else k)
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [_unflatten(v, leaves, f"{path}/{i}")
                for i, v in enumerate(specs)]
    return leaves[path]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random f32 parameters on ``device`` (the generator's device when
    None), leaf by leaf in the JAX package's flatten order."""
    device = torch.device(device or generator.device)
    specs = S.model_param_specs(cfg)
    leaves = {}
    for name, shape in S.leaves_with_names(specs):
        fixed = _fixed(_base(name), shape)
        if fixed is not None:
            leaves[name] = torch.from_numpy(fixed).to(device)
            continue
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if _base(name) == "dt_b":
            t.uniform_(DT_MIN, DT_MAX, generator=generator)
            leaves[name] = t + torch.log(-torch.expm1(-t))
            continue
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        leaves[name] = t.mul_(1.0 / math.sqrt(_fan_in(shape)))
    return _unflatten(specs, leaves)


def seeded_numpy_params(cfg: ModelConfig, seed: int) -> Dict[str, Any]:
    """f32 numpy weights in the JAX package's tree layout, from one
    ``np.random.default_rng(seed)``.

    Leaf order is the JAX package's flatten order (``jax.tree.leaves`` of
    ``model_param_specs``: dict keys sorted, uppercase first, lists in
    order): ``body`` (position 0's leaves in sorted key order, ``kn, ln1,
    ln2, qn, wg, wi, wk, wo, wo2, wq, wv`` for an attention layer and
    ``A_log, D_skip, conv_b, conv_w, dt_b, dt_w, in_proj, ln1, ln2,
    out_proj, wg, wi, wo2, x_proj`` for a Mamba layer; on an MoE layer
    the experts and the router take the dense MLP's place: ``e_wg, e_wi,
    e_wo, kn, ln1, ln2, qn, router, wk, wo, wq, wv`` for attention and
    ``A_log, D_skip, conv_b, conv_w, dt_b, dt_w, e_wg, e_wi, e_wo,
    in_proj, ln1, ln2, out_proj, router, x_proj`` for Mamba; then position
    1's, ...), ``emb``, then an encoder-decoder's ``encoder`` (its stacked
    ``layers``, then its ``final_ln``), ``final_ln``, ``head`` (untied
    embeddings only), ``tail`` (layer by layer, the same key order), and
    last an encoder-decoder's ``xattn_body`` and ``xattn_tail`` (``lnx, xk,
    xo, xq, xv``). The norms (``ln1``, ``ln2``, ``lnx``, ``ln_inner``,
    ``final_ln``, ``qn``, ``kn``), ``D_skip``, ``conv_b``, ``b``, ``xgate``
    and ``A_log`` take their fixed values and draw nothing. ``dt_b`` is one
    ``rng.uniform(1e-3, 1e-1, shape)`` draw, cast to f32 and passed through
    the inverse softplus ``u + log(-expm1(-u))`` in f32. Every other leaf,
    in that order, is ``rng.standard_normal(shape, float32) /
    sqrt(fan_in)`` with ``fan_in`` the second-to-last dimension (the last
    for a vector), as the JAX package's ``init_params`` scales its draws:
    D for ``router`` (D, E), ``e_wg`` and ``e_wi`` (E, D, F), F for
    ``e_wo`` (E, F, D).
    A dense config draws exactly what it drew before the Mamba leaves
    existed, and the dense, MoE and hybrid configs what they drew before
    the xLSTM, cross-attention and encoder-decoder leaves existed.
    """
    rng = np.random.default_rng(seed)
    specs = S.model_param_specs(cfg)
    leaves = {}
    for name, shape in S.leaves_with_names(specs):
        fixed = _fixed(_base(name), shape)
        if fixed is not None:
            leaves[name] = fixed
            continue
        if _base(name) == "dt_b":
            u = rng.uniform(DT_MIN, DT_MAX, shape).astype(np.float32)
            leaves[name] = u + np.log(-np.expm1(-u))
            continue
        a = rng.standard_normal(shape, dtype=np.float32)
        a /= np.float32(math.sqrt(_fan_in(shape)))
        leaves[name] = a
    return _unflatten(specs, leaves)
