"""Run the bf16 training step of
``tests/test_torch_train.py::test_bf16_gradients_land_in_the_f32_masters``
(reduced gemma3-1b in bfloat16, one AdamW step on the CPU) N times, each
under a dispatch mode that checks every op's floating output for a NaN,
and print the first op that made one, with its inputs' dtypes, shapes,
strides and whether they held a NaN already.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_nan_spy.py 30

Not a test module: the tool that hunts ROADMAP queue 3's fault (a), a
NaN loss the test read now and then on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(__file__))


class NaNSpy(TorchDispatchMode):
    """Records the first op whose floating output holds a NaN."""

    def __init__(self):
        super().__init__()
        self.first = None
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if self.first is None:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if any(isinstance(o, torch.Tensor) and o.is_floating_point()
                   and o.numel() and bool(torch.isnan(o).any())
                   for o in outs):
                self.first = (self.ops, str(func), [
                    (a.dtype, tuple(a.shape), a.stride(),
                     bool(torch.isnan(a).any()) if a.is_floating_point()
                     else None)
                    for a in args if isinstance(a, torch.Tensor)])
        return out


def main(n: int) -> int:
    from test_torch_train import LR, batch_for

    from repro_torch.configs import get_arch, reduced
    from repro_torch.optim import AdamW
    from repro_torch.train import create_train_state, make_train_step

    cfg = dataclasses.replace(reduced(get_arch("gemma3-1b")),
                              dtype="bfloat16")
    opt = AdamW(lr=LR)
    bad = 0
    for i in range(n):
        state = create_train_state(cfg, opt,
                                   torch.Generator().manual_seed(0), "cpu")
        batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
        with NaNSpy() as spy:
            _, m = make_train_step(cfg, opt)(state, batch)
        if not np.isfinite(float(m["loss"])) or float(m["skipped"]):
            bad += 1
            print(f"step {i}: loss {float(m['loss'])}; first NaN op: "
                  f"{spy.first}", flush=True)
    print(f"{n} steps, {bad} with a NaN", flush=True)
    return bad


if __name__ == "__main__":
    sys.exit(1 if main(int(sys.argv[1]) if len(sys.argv) > 1 else 30)
             else 0)
