"""Adafactor (Shazeer & Stern 2018), the JAX package's math
(``optim/adafactor.py``): factored second moments, no first moment.

A leaf with two or more dimensions keeps ``vr`` (its shape without the
last axis) and ``vc`` (without the second-to-last); a vector keeps ``v``.
The decay of the second moments follows ``beta2 = 1 - t**-decay`` (t the
step plus one). The update ``g / sqrt(v)`` is clipped to an RMS of at
most ``clip_threshold`` over the whole leaf, and ``weight_decay`` applies
to the leaves with two or more dimensions.

As in AdamW, the rules read each leaf as stored: an LM's stacked ``body``
leaf (R, ...) is factored and clipped as one tensor, its norm scales (R,
d) factored over (R,) and (d,), and a tail norm (d,) kept whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple, Union

import torch

from repro_torch.optim.base import Schedule, by_name
from repro_torch.utils.tree import tree_map, tree_map_with_path_names


@dataclass(frozen=True)
class Adafactor:
    lr: Union[float, Schedule] = 1e-2
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _lr(self, step: torch.Tensor):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params: Any) -> dict:
        def make(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            if p.dim() >= 2:
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return {"f": tree_map(make, params)}

    def update(self, grads: Any, state: dict, params: Any,
               step: torch.Tensor) -> Tuple[Any, dict]:
        """(new params, new state). ``step`` an int32 tensor (0-d)."""
        t = step.to(torch.float32) + 1.0
        beta2 = 1.0 - t ** (-self.decay)
        lr = self._lr(step)
        g_, f_ = by_name(grads), by_name(state["f"])
        new_f = {}

        def upd(name, p):
            g = g_[name].to(torch.float32)
            f = {k: f_[f"{name}/{k}"] for k in ("vr", "vc", "v")
                 if f"{name}/{k}" in f_}
            # the leaf-sized temporaries are released, or reused in place,
            # as soon as they are spent (the same values as out of place)
            g2 = torch.square(g) + self.eps
            if p.dim() >= 2:
                vr = beta2 * f["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * f["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                del g2
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=self.eps)
                v = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                new_f[name] = {"vr": vr, "vc": vc}
            else:
                v = beta2 * f["v"] + (1 - beta2) * g2
                new_f[name] = {"v": v}
            clamped = torch.clamp(v, min=self.eps)
            del v
            root = torch.sqrt(clamped)
            del clamped
            u = g / root
            del g, root
            # update clipping (RMS <= threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u.div_(torch.clamp(rms / self.clip_threshold, min=1.0))
            if self.weight_decay and p.dim() >= 2:
                u.add_(self.weight_decay * p.to(torch.float32))
            return (p.to(torch.float32) - u.mul_(lr)).to(p.dtype)

        new_params = tree_map_with_path_names(upd, params)
        return new_params, {"f": tree_map_with_path_names(
            lambda n, _: new_f[n], params)}

    def state_pspecs(self, param_specs: Any, param_pspecs: Any) -> dict:
        """The state's spec tree (``sharding.specs``) from the params'
        shapes (``models.spec.model_param_specs``) and specs: ``vr``
        drops the param spec's last axis, ``vc`` its second-to-last."""
        from repro_torch.models.spec import leaves_with_names
        from repro_torch.sharding.specs import spec_map

        shapes = dict(leaves_with_names(param_specs))

        def make(name, spec):
            nd = len(shapes[name])
            axes = list(spec) + [None] * (nd - len(spec))
            if nd >= 2:
                return {"vr": tuple(axes[:-1]),
                        "vc": tuple(axes[:-2] + axes[-1:])}
            return {"v": tuple(axes)}

        return {"f": spec_map(make, param_pspecs)}
