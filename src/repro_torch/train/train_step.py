"""The LM training step (the JAX package's ``train/train_step.py``): loss
-> gradients -> (compress, clip, guard) -> optimizer update.

- Gradient (micro)accumulation: the batch split into M microbatches run
  one after another, their gradients summed then divided by M, as the
  JAX package's scan does: activation memory for 1/M of the batch.
- Optional int8 gradient compression (``optim.compress``).
- Global-norm clipping.
- A non-finite guard: a step whose gradients or loss hold an inf or a NaN
  keeps the params and the optimizer state (``torch.where``) and still
  advances the step.

After the backward pass the step holds each gradient once: clipping
scales them one leaf at a time, and the optimizer updates one leaf at a
time (its own update on that leaf alone), each leaf's gradient released
and its guard applied as soon as its update is made. So at the update
the step holds the old state, the gradients not yet used, the new leaves
made so far and one leaf's temporaries: about two copies of the params
where a whole-tree update would hold three and every leaf's
temporaries.

In a bfloat16 model every f32 master is cast to bf16 before the forward
(``ShardCtx.cast_params_bf16``; else at each use), inside autograd, so
the gradients land in the f32 masters. Nothing in the step reads the
device from the host.

On a mesh (an enabled ``ShardCtx``) the state and the batch are DTensors
(``sharding.specs.distribute`` by ``train_state_pspecs`` and
``batch_pspecs``): the forward and backward run as DTensor operations,
each gradient comes back laid out as its parameter, the global norm and
the guard are the whole tree's (``optim.base``), the microbatches are
constrained to (None, dp) as in the JAX package, and every new leaf of
the state is laid out as the old one (the JAX package's
``out_shardings``). Every family runs under a mesh; an MoE model's
load-balancing loss enters the loss as in ``models.model.forward_train``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward_train
from repro_torch.optim.base import (
    all_finite,
    by_name,
    clip_scale,
    global_norm,
    plain,
)
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx
from repro_torch.utils.tree import (
    tree_leaves_with_names,
    tree_map,
    tree_map_with_path_names,
)


def _rebuild(like: Any, values: Dict[str, torch.Tensor]) -> Any:
    return tree_map_with_path_names(lambda name, _: values[name], like)


def _at(tree: Any, name: str) -> Any:
    """The subtree of ``tree`` at the leaf name ``name``."""
    for part in name.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _laid_out_as(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` with ``old``'s placements where both are DTensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(old, DTensor) and tuple(new.placements) != tuple(
            old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def make_train_step(cfg: ModelConfig, optimizer, ctx: ShardCtx = UNSHARDED,
                    *, microbatches: int = 1, grad_clip: float = 1.0,
                    compress: Optional[str] = None) -> Callable:
    """``train_step(state, batch) -> (new state, metrics)``: metrics
    ``loss``, ``grad_norm``, ``skipped`` (1.0 where the guard kept the
    state), ``moe_aux`` and ``tokens``, 0-d tensors on the state's
    device."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got {compress!r}")
    cast = cfg.dtype == "bfloat16" and ctx.cast_params_bf16

    def loss_fn(params, batch):
        if cast:
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        return forward_train(params, batch, cfg, ctx)

    def grad_fn(params, batch):
        names, leaves = zip(*tree_leaves_with_names(params))
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, metrics = loss_fn(_rebuild(params, dict(zip(names, live))),
                                    batch)
            loss = plain(loss)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else _laid_out_as(g, p)
                 for n, p, g in zip(names, live, grads)}
        return (loss.detach(),
                {k: plain(v).detach() for k, v in metrics.items()},
                _rebuild(params, grads))

    def compute_grads(params, batch):
        if microbatches == 1:
            return grad_fn(params, batch)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        parts = {k: ctx.constrain(v.reshape(
            (microbatches, b // microbatches) + tuple(v.shape[1:])),
            None, "dp") for k, v in batch.items()}
        g_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        l_sum = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        seen = []
        for i in range(microbatches):
            loss, metrics, g = grad_fn(params, {k: v[i]
                                                for k, v in parts.items()})
            g_ = by_name(g)
            g_sum = tree_map_with_path_names(
                lambda n, acc: acc + g_[n], g_sum)
            l_sum = l_sum + loss
            seen.append(metrics)
        grads = tree_map(lambda g: g / microbatches, g_sum)
        metrics = {k: torch.mean(torch.stack([m[k] for m in seen]))
                   for k in seen[0]}
        return l_sum / microbatches, metrics, grads

    def train_step(state: Dict[str, Any], batch) -> tuple:
        params, opt_state, step = state["params"], state["opt"], state["step"]
        loss, metrics, grads = compute_grads(params, batch)
        if compress == "int8":
            from repro_torch.optim.compress import quantize_dequantize

            grads = quantize_dequantize(grads)
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, grad_clip)
        flat = by_name(grads)      # from here the step's only reference
        del grads
        for name in flat:
            flat[name] = flat[name] * scale
        good = all_finite(flat) & torch.isfinite(loss)

        def keep(new, old):
            if not ctx.enabled:
                return torch.where(good, new, old, out=new)
            return torch.where(good, _laid_out_as(new, old), old)

        new_p, new_s = {}, {}
        for name, p in tree_leaves_with_names(params):
            g = {name: flat.pop(name)}
            sub = {k: {name: _at(opt_state[k], name)} for k in opt_state}
            upd_p, upd_s = optimizer.update(g, sub, {name: p}, step)
            del g
            new_p[name] = keep(upd_p[name], p)
            old_s = by_name(sub)
            new_s.update((n, keep(x, old_s[n]))
                         for n, x in tree_leaves_with_names(upd_s))
        new_state = {"params": _rebuild(params, new_p),
                     "opt": _rebuild(opt_state, new_s), "step": step + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "skipped": (~good).to(torch.float32), **metrics}

    return train_step
