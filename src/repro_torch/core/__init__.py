"""The datacenter digital twin on tensors: trace replay, rescheduling,
the power/cooling/carbon chain, the rack thermal twin and the resilience
twin (faults, outages, checkpoint-restart, the degradation ladder) and
the serving twin (request-mass flow, overload ladder, autoscale, SLO
ledger), tick by tick or macro-stepped, for one datacenter or a fleet of
replicas."""

from repro_torch.core.faults import (
    LVL_DRAIN,
    LVL_EVICT,
    LVL_GATE,
    LVL_NORMAL,
    LVL_THROTTLE,
    apply_faults,
    effective_level,
    next_fault_event,
)
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
from repro_torch.core.serving import (
    apply_serving,
    next_serving_event,
    retry_backoff,
    serving_crossing_horizon,
    serving_flow,
    serving_power,
    serving_trigger,
)
from repro_torch.core.sim import (
    StepOut,
    TelemetrySummary,
    make_macro_step,
    make_step,
    quiet_horizon,
    run_episode,
    run_segment,
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
