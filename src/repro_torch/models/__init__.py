"""The LMs of the port (the JAX package's ``repro.models``): every arch's
layers, serving (``DecoderLM``, ``prefill``, ``decode_step``) and the
training loss (``forward_train``)."""

from repro_torch.models.init import init_params, seeded_numpy_params
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward_train,
    init_cache,
    prefill,
)
from repro_torch.models.spec import count_params_analytic, model_param_specs
