"""Grid-signal scenarios for the twin: time-varying carbon / price /
weather signals and demand-response power-cap events, as tensors."""

from repro_torch.scenarios.events import (
    CapSchedule,
    cap_events,
    next_cap_event,
    no_cap,
    power_cap_at,
)
from repro_torch.scenarios.scenario import (
    Scenario,
    carbon_trace,
    default_scenario,
    demand_response,
    heatwave,
    n_replicas,
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
    sinusoid,
)
