"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in the same module.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else, so a run can
show that the main path went through the kernel.

The kernels write their outputs through raw pointers, so autograd cannot
see through them. A kernel on a differentiable path (``flash_attn``,
``selective_scan``'s fused entry ``mamba_scan``) is launched from the
forward of a ``torch.autograd.Function`` whose backward is the vjp of the
kernel's plain version (``plain_vjp``), as the JAX package's
``custom_vjp``s take theirs; a raw launch on tensors that autograd is
recording raises (``refuse_autograd``) instead of giving no gradient.

On ``meta`` tensors a wrapper launches nothing and computes nothing: it
returns outputs of the kernel's shapes and dtypes and reports the call's
FLOPs and bytes (``meta_cost``), by a formula beside the wrapper that
counts what the plain version computes; that is how ``launch.dryrun``
traces a step with no device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

LAUNCHES: dict[str, int] = {"power_scatter": 0, "rack_thermal": 0,
                             "node_power": 0, "flash_attn": 0,
                             "selective_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Sinks of the costs a kernel's wrapper reports when it is called on meta
# tensors (``launch.dryrun`` traces a step so): each is called with the
# call's (FLOPs, bytes), computed by the formula beside the wrapper.
META_SINKS: list = []


def meta_cost(flops: int, nbytes: int) -> None:
    """Report one meta call's cost to every sink in META_SINKS."""
    for sink in META_SINKS:
        sink(int(flops), int(nbytes))


def nbytes(*tensors: torch.Tensor) -> int:
    """The bytes of ``tensors`` at their shapes and dtypes."""
    return sum(t.numel() * t.element_size() for t in tensors)


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd is recording and any of ``tensors`` needs a
    gradient: the kernel's output would carry none (its
    ``autograd.Function`` launches it with recording off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a raw kernel launch on tensors that need gradients "
            "would give them none; call the differentiable wrapper")


def plain_vjp(plain: Callable, inputs: Sequence[torch.Tensor],
              needs: Sequence[bool], grads: Sequence[torch.Tensor],
              **kw) -> tuple:
    """The gradients of ``plain(*inputs, **kw)`` (a tensor or a tuple of
    tensors) at output gradients ``grads``, for the inputs whose ``needs``
    is set (None for the others): the backward of a kernel's
    ``autograd.Function``, by recomputing its plain version."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = plain(*ins, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads,
                                       allow_unused=True) if wanted else ())
    return tuple(next(got) if n else None for n in needs)
