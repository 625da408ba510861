"""Grid-signal scenarios for the twin: time-varying carbon / price /
weather signals, demand-response power-cap events, outage windows and the
serving twin's traffic and flash-crowd windows, as tensors."""

from repro_torch.scenarios.events import (
    BurstSchedule,
    CapSchedule,
    OutageSchedule,
    burst_events,
    burst_mult_at,
    cap_events,
    next_burst_event,
    next_cap_event,
    next_outage_event,
    no_bursts,
    no_cap,
    no_outages,
    outage_down,
    outage_events,
    outage_level_at,
    power_cap_at,
)
from repro_torch.scenarios.scenario import (
    SCENARIOS,
    Scenario,
    carbon_trace,
    default_scenario,
    demand_response,
    diurnal_serving,
    heatwave,
    n_replicas,
    resilience_drill,
    sample_scenarios,
    solar_heavy,
    stack_scenarios,
    thermal_stress,
)
from repro_torch.scenarios.signals import (
    Signal,
    constant,
    eval_signal,
    from_trace,
    integrate_signal,
    mean_signal,
    signal_bounds,
    sinusoid,
    to_trace,
)
