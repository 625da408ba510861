"""MLP actor-critic (shared torso, categorical policy head + value head).

The parameters are named and laid out as the JAX package's (``w0, b0,
..., w_pi, b_pi, w_v, b_v``, weights (in, out)), so a parameter dict
carries across (``interop.actor_critic_params_from_numpy``). ``init``
draws them from key words with the JAX package's key splits and
``jax.random.normal``'s transform (``utils.prng.normal``). ``apply`` and
``act`` take a parameter dict, as the JAX package's do; the module's own
parameters (``load``, ``params``) serve ``forward``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.utils import prng
from repro_torch.utils.device import full

Params = Dict[str, torch.Tensor]


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, n_actions: int, hidden=(128, 128),
                 device: str | torch.device | None = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        for name, shape in self._shapes().items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device)))

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        sizes = (self.obs_dim,) + self.hidden
        shapes = {}
        for i in range(len(sizes) - 1):
            shapes[f"w{i}"] = (sizes[i], sizes[i + 1])
            shapes[f"b{i}"] = (sizes[i + 1],)
        shapes["w_pi"] = (sizes[-1], self.n_actions)
        shapes["b_pi"] = (self.n_actions,)
        shapes["w_v"] = (sizes[-1], 1)
        shapes["b_v"] = (1,)
        return shapes

    def init(self, key) -> Params:
        """Parameters from key words (2,), on the module's device: He-normal
        torso, a 0.01-scaled policy head, a 1/sqrt(fan-in) value head."""
        sizes = (self.obs_dim,) + self.hidden
        dev = self.w_pi.device
        words = (key if isinstance(key, torch.Tensor)
                 else torch.from_numpy(np.asarray(key, np.int64)))
        keys = prng.split(words.to(device=dev, dtype=torch.int64),
                          len(sizes) + 2)

        def scaled(k, shape, scale):
            return prng.normal(k, shape) * float(np.float32(scale))

        params: Params = {}
        for i in range(len(sizes) - 1):
            params[f"w{i}"] = scaled(keys[i], (sizes[i], sizes[i + 1]),
                                     np.sqrt(2.0 / sizes[i]))
            params[f"b{i}"] = torch.zeros(sizes[i + 1], device=dev)
        params["w_pi"] = scaled(keys[-2], (sizes[-1], self.n_actions), 0.01)
        params["b_pi"] = torch.zeros(self.n_actions, device=dev)
        # a division by a tensor: on CUDA a Python divisor becomes a
        # multiplication by its reciprocal
        params["w_v"] = (prng.normal(keys[-1], (sizes[-1], 1))
                         / full(float(np.float32(np.sqrt(sizes[-1]))),
                                torch.float32, dev))
        params["b_v"] = torch.zeros(1, device=dev)
        return params

    def load(self, params: Params) -> None:
        """Copy ``params`` into the module's own parameters."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(params[name])

    def params(self) -> Params:
        return dict(self.named_parameters())

    def apply(self, params: Params,
              obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (..., n_actions), value (...))."""
        h = obs
        for i in range(len(self.hidden)):
            h = torch.tanh(torch.matmul(h, params[f"w{i}"]) + params[f"b{i}"])
        logits = torch.matmul(h, params["w_pi"]) + params["b_pi"]
        value = (torch.matmul(h, params["w_v"]) + params["b_v"])[..., 0]
        return logits, value

    def forward(self, obs: torch.Tensor):
        return self.apply(self.params(), obs)

    def act(self, params: Params, obs: torch.Tensor, key):
        """(action, log-prob, value): one categorical draw per row of
        ``obs`` from key words (2,), or per key from a (B, 2) batch."""
        logits, value = self.apply(params, obs)
        action = prng.categorical(key, logits)
        logp = torch.log_softmax(logits, -1)
        lp = torch.gather(logp, -1, action[..., None])[..., 0]
        return action, lp, value
