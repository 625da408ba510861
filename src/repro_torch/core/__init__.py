"""The datacenter digital twin on tensors: trace replay, rescheduling,
the power/cooling/carbon chain and the rack thermal twin, for one
datacenter or a fleet of replicas (faults and serving arrive with their
slices)."""

from repro_torch.core.fleet import (
    fleet_summary,
    policy_scenario_grid,
    prepare_fleet,
    run_fleet,
)
from repro_torch.core.placement import (
    PLACE_IDS,
    PLACEMENT_MASKS,
    PLACEMENTS,
    Policy,
    make_policy,
    policy_grid,
    stack_policies,
)
from repro_torch.core.schedulers import SCHEDULERS, SELECT_IDS
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
    broadcast_state,
    build_statics,
    init_state,
    load_jobs,
)
