"""The optimizers the port's training paths use (the JAX package's math)."""

from repro_torch.optim.adamw import AdamW
from repro_torch.optim.base import clip_by_global_norm, global_norm
