"""Generalized Advantage Estimation: a reverse loop over T."""

from __future__ import annotations

import torch


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, *, gamma: float = 0.99,
        lam: float = 0.95):
    """All inputs (T, N), ``last_value`` (N,). Returns (advantages,
    returns), each (T, N)."""
    nonterm = 1.0 - dones.to(torch.float32)
    adv_next = last_value * 0.0
    v_next = last_value
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * nonterm[t] - values[t]
        adv_next = delta + gamma * lam * nonterm[t] * adv_next
        v_next = values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + values
