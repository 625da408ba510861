"""The optimizers of the port's training paths (the JAX package's
``repro.optim`` math): AdamW and Adafactor over trees of f32 tensors, the
learning-rate schedules, clipping by the global norm."""

from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.base import (
    Schedule,
    all_finite,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine_warmup


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(f"unknown optimizer {name}")


def default_optimizer_for(n_params: int) -> str:
    """Adafactor from 100e9 parameters (f32 Adam moments are 8 bytes a
    parameter more), AdamW below, as the JAX package chooses."""
    return "adafactor" if n_params >= 100e9 else "adamw"
