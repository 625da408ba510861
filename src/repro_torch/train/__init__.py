"""The LMs' training and serving steps (the JAX package's
``repro.train``)."""

from repro_torch.train.state import (
    abstract_train_state,
    create_train_state,
    train_state_pspecs,
)
from repro_torch.train.train_step import make_train_step
