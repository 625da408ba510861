"""The LMs of the port (the JAX package's ``repro.models``, for the
``attn`` / ``attn_local`` and ``mamba`` layers with a dense gated MLP or
the top-k experts)."""

from repro_torch.models.init import init_params, seeded_numpy_params
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    init_cache,
    prefill,
)
from repro_torch.models.spec import count_params_analytic, model_param_specs
