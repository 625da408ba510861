"""AdamW with decoupled weight decay and f32 moments, the JAX package's
math (``optim/adamw.py``), not ``torch.optim.AdamW``'s: bias correction
divides each moment (``m / (1 - b1**t)``, ``v / (1 - b2**t)``) before
``eps`` is added to ``sqrt(v_hat)``; ``t`` is the ``step`` argument
plus one, whatever the caller counts (PPO passes its iteration index to
every minibatch update of the iteration); decay applies only to
parameters with two or more dimensions."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01

    def init(self, params: Tree) -> Dict[str, Tree]:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        return {"m": zeros(), "v": zeros()}

    def update(self, grads: Tree, state: Dict[str, Tree], params: Tree,
               step: torch.Tensor) -> Tuple[Tree, Dict[str, Tree]]:
        """(new params, new state). ``step`` an int32 tensor (0-d)."""
        t = step.to(torch.float32) + 1.0
        b1, b2 = self.b1, self.b2
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if p.dim() >= 2:  # no decay on norms/biases
                delta = delta + self.weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32) - self.lr * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}
