"""AdamW with decoupled weight decay and f32 moments, the JAX package's
math (``optim/adamw.py``), not ``torch.optim.AdamW``'s: bias correction
divides each moment (``m / (1 - b1**t)``, ``v / (1 - b2**t)``) before
``eps`` is added to ``sqrt(v_hat)``; ``t`` is the ``step`` argument
plus one, whatever the caller counts (PPO passes its iteration index to
every minibatch update of the iteration); ``lr`` is a float or a
``Schedule`` of the step.

Decay applies to the leaves with two or more dimensions. The rule reads
the leaf as stored: an LM's ``body`` leaves hold the R repeats of a layer
on a leading axis, so a body norm scale (R, d) is decayed and a tail one
(d,) is not, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple, Union

import torch

from repro_torch.optim.base import Schedule, by_name
from repro_torch.utils.tree import tree_map, tree_map_with_path_names


@dataclass(frozen=True)
class AdamW:
    lr: Union[float, Schedule] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01

    def _lr(self, step: torch.Tensor):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params: Any) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(self, grads: Any, state: dict, params: Any,
               step: torch.Tensor) -> Tuple[Any, dict]:
        """(new params, new state). ``step`` an int32 tensor (0-d)."""
        t = step.to(torch.float32) + 1.0
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        g_, m_, v_ = by_name(grads), by_name(state["m"]), by_name(state["v"])
        out = {}

        def upd(name, p):
            g = g_[name].to(torch.float32)
            m = b1 * m_[name] + (1 - b1) * g
            v = b2 * v_[name] + (1 - b2) * torch.square(g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if p.dim() >= 2:  # no decay on norms/biases
                delta = delta + self.weight_decay * p.to(torch.float32)
            out[name] = (m, v)
            return (p.to(torch.float32) - lr * delta).to(p.dtype)

        new_params = tree_map_with_path_names(upd, params)
        return new_params, {
            "m": tree_map_with_path_names(lambda n, _: out[n][0], params),
            "v": tree_map_with_path_names(lambda n, _: out[n][1], params)}

    def state_pspecs(self, param_specs: Any, param_pspecs: Any) -> dict:
        """The state's spec tree (``sharding.specs``): both moments as
        their params."""
        return {"m": param_pspecs, "v": param_pspecs}
