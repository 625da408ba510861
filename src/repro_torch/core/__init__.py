"""The datacenter digital twin on tensors: trace replay, rescheduling and
the power/cooling/carbon chain (thermal, faults and serving arrive with
their slices)."""

from repro_torch.core.placement import PLACEMENT_MASKS, PLACEMENTS
from repro_torch.core.schedulers import SCHEDULERS
from repro_torch.core.sim import (
    StepOut,
    TelemetrySummary,
    make_step,
    run_episode,
    summary,
    summary_columns,
)
from repro_torch.core.state import (
    DONE,
    EMPTY,
    FAILED,
    QUEUED,
    RUNNING,
    SimState,
    Statics,
    build_statics,
    init_state,
    load_jobs,
)
