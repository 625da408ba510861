from repro_torch.utils.errors import (
    CheckpointError,
    ConfigError,
    ReproError,
    SignalValidationError,
    TraceValidationError,
)
