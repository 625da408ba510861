"""The LM train state (the JAX package's ``train/state.py``): a dict
``{"params", "opt", "step"}`` of f32 tensors in the JAX package's tree
layout (``params`` stacked as ``models.spec.model_param_specs`` lays them
out, ``opt`` the optimizer's state of the same leaves, ``step`` a 0-d
int32), so gradients, optimizer rules, checkpoints and the global norm's
leaf order all follow the JAX package's leaves; and its spec tree on a
mesh (``train_state_pspecs``), by which ``sharding.specs.distribute``
makes it a tree of DTensors."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec as S
from repro_torch.models.init import _unflatten, init_params
from repro_torch.sharding.specs import train_state_pspecs  # noqa: F401

TrainState = Dict[str, Any]   # {"params", "opt", "step"}


def create_train_state(cfg: ModelConfig, optimizer,
                       generator: torch.Generator, device=None) -> TrainState:
    """Fresh parameters from ``models.init_params`` (on ``device``, the
    generator's by default), the optimizer's initial state, step 0."""
    params = init_params(cfg, generator, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["emb"].device)}


def abstract_train_state(cfg: ModelConfig, optimizer) -> TrainState:
    """The train state's structure, shapes and dtypes as tensors on the
    ``meta`` device (never allocated), from ``models.spec``'s shapes."""
    specs = S.model_param_specs(cfg)
    params = _unflatten(specs, {
        name: torch.empty(shape, dtype=torch.float32, device="meta")
        for name, shape in S.leaves_with_names(specs)})
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
