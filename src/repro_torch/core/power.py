"""RAPS power chain: job utilization -> node IT power -> rectification /
voltage-conversion losses -> cooling (COP model) -> facility power, plus
delivered GFLOP/s.

The replay tick calls ``power_tick``: one launch of
``kernels.node_power.power_tick`` takes the job table through utilisation,
the placement scatter, the node chain and the facility totals, and with
the thermal twin on through the tail's derate as well (its plain version
on the CPU). ``compute_power`` is the same chain without the derate,
composed from the plain pieces below with the placement-scatter +
power-chain pass (``kernels.node_power.power_scatter``); the tick's plain
version is held to it bitwise. Float results are held to a tolerance
against the JAX package (whose dense and scatter paths sum in other
orders), not to bit-equality.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core.state import RUNNING, SimState, Statics
from repro_torch.core.thermal import throttle_params
from repro_torch.kernels import node_power as npw
from repro_torch.kernels.node_power import node_chain, power_scatter, scatter_loads
from repro_torch.scenarios.signals import eval_signal
from repro_torch.utils.device import full, take


class PowerOut(NamedTuple):
    node_it_w: torch.Tensor      # (N,)
    node_input_w: torch.Tensor   # (N,) after rectifier+conversion losses
    it_w: torch.Tensor           # 0-d
    input_w: torch.Tensor
    cooling_w: torch.Tensor
    facility_w: torch.Tensor
    pue: torch.Tensor
    gflops: torch.Tensor         # utilization-weighted delivered GFLOP/s


def _chain_kw(cfg: SimConfig) -> dict:
    return dict(rect_peak=cfg.rect_eff_peak, rect_load=cfg.rect_eff_load,
                rect_curv=cfg.rect_eff_curv, conv_eff=cfg.conv_eff)


def job_utilization(cfg: SimConfig, state: SimState, statics: Statics):
    """Per-job cpu/gpu utilization at the current sim time from the
    telemetry bank (quanta-averaged, as RAPS replays traces)."""
    running = (state.jstate == RUNNING).to(torch.float32)
    age = torch.clamp(state.t - state.start_t, min=0.0)
    q = statics.cpu_trace.shape[-1]
    # divide by a device tensor: on CUDA a division by a Python scalar is
    # a multiply by its reciprocal, which can round the quantum index
    quanta = full(cfg.trace_quanta, torch.float32, age.device)
    qi = torch.clamp((age / quanta).to(torch.int32), 0, q - 1).long()[:, None]
    cpu_trace, gpu_trace = statics.cpu_trace, statics.gpu_trace
    if cpu_trace.dim() == 3:     # banked: this state's slice
        cpu_trace = take(cpu_trace, state.workload, dim=0)
        gpu_trace = take(gpu_trace, state.workload, dim=0)
    cpu = torch.gather(cpu_trace, 1, qi)[:, 0]
    gpu = torch.gather(gpu_trace, 1, qi)[:, 0]
    return cpu * running, gpu * running


def placement_amounts(state: SimState, cpu_util: torch.Tensor,
                      gpu_util: torch.Tensor):
    """Flattened per-placement-slot absolute utilized resources:
    (place_flat (J*K,) int32, cpu_abs (J*K,), gpu_abs (J*K,)), the job-table
    form the fused kernel consumes (invalid slots: place -1, zero amounts)."""
    place = state.placement                          # (J, K)
    w = (place >= 0).to(torch.float32)
    cpu_abs = (state.req[0][:, None] * cpu_util[:, None]) * w
    gpu_abs = (state.req[1][:, None] * gpu_util[:, None]) * w
    return place.reshape(-1), cpu_abs.reshape(-1), gpu_abs.reshape(-1)


def node_loads(cfg: SimConfig, state: SimState, statics: Statics,
               cpu_util: torch.Tensor, gpu_util: torch.Tensor):
    """Scatter per-job utilized resources onto nodes. Returns (cpu_frac,
    gpu_frac), fractions of node capacity in [0, 1]."""
    N = statics.capacity.shape[1]
    place, cpu_abs, gpu_abs = placement_amounts(state, cpu_util, gpu_util)
    cpu_node = scatter_loads(place[None], cpu_abs[None], N)[0]
    gpu_node = scatter_loads(place[None], gpu_abs[None], N)[0]
    cpu_frac = torch.clamp(
        cpu_node / torch.clamp(statics.capacity[0], min=1e-6), 0.0, 1.0)
    gpu_frac = torch.clamp(
        gpu_node / torch.clamp(statics.capacity[1], min=1e-6), 0.0, 1.0)
    return cpu_frac, gpu_frac


def finish_power(cfg: SimConfig, state: SimState, statics: Statics,
                 node_it: torch.Tensor, node_input: torch.Tensor,
                 cpu_frac: torch.Tensor, gpu_frac: torch.Tensor) -> PowerOut:
    """Per-node IT/input power -> facility totals, cooling (COP model),
    PUE and delivered GFLOP/s."""
    it_w = torch.sum(node_it)
    input_w = torch.sum(node_input)
    wb = eval_signal(statics.scenario.wetbulb, state.t)
    cop = torch.clamp(
        cfg.cop_base + cfg.cop_wetbulb_coef * (wb - cfg.wetbulb_ref_c),
        min=cfg.cop_min)
    cooling_w = input_w / cop
    facility_w = input_w + cooling_w
    # PUE is undefined at zero IT load: report the 1.0 ideal
    pue = torch.where(it_w > 1.0, facility_w / torch.clamp(it_w, min=1.0),
                      1.0)
    gflops = torch.sum(
        statics.peak_gflops * torch.maximum(cpu_frac, gpu_frac)
        * state.node_up)
    return PowerOut(node_it, node_input, it_w, input_w, cooling_w,
                    facility_w, pue, gflops)


def power_from_fracs(cfg: SimConfig, state: SimState, statics: Statics,
                     cpu_frac: torch.Tensor, gpu_frac: torch.Tensor) -> PowerOut:
    """Per-node load fractions -> full power chain."""
    node_it, node_input = node_chain(
        cpu_frac, gpu_frac, statics.idle_w, statics.cpu_dyn_w,
        statics.gpu_dyn_w, state.node_up, statics.node_max_w,
        **_chain_kw(cfg))
    return finish_power(cfg, state, statics, node_it, node_input,
                        cpu_frac, gpu_frac)


def compute_power(cfg: SimConfig, state: SimState,
                  statics: Statics) -> PowerOut:
    """Job table -> power chain in one fused pass (kernel on the card)."""
    cpu_util, gpu_util = job_utilization(cfg, state, statics)
    place, cpu_abs, gpu_abs = placement_amounts(state, cpu_util, gpu_util)
    outs = power_scatter(
        place[None], cpu_abs[None], gpu_abs[None], statics.capacity[0],
        statics.capacity[1], statics.idle_w, statics.cpu_dyn_w,
        statics.gpu_dyn_w, state.node_up[None], statics.node_max_w,
        **_chain_kw(cfg))
    node_it, node_input, cpu_frac, gpu_frac = (o[0] for o in outs)
    return finish_power(cfg, state, statics, node_it, node_input,
                        cpu_frac, gpu_frac)


def tick_consts(cfg: SimConfig) -> npw.TickConsts:
    """The config numbers ``power_tick`` needs, as its kernel and its plain
    version take them."""
    return npw.TickConsts(
        trace_quanta=cfg.trace_quanta, **_chain_kw(cfg),
        cop_base=cfg.cop_base, cop_wetbulb_coef=cfg.cop_wetbulb_coef,
        wetbulb_ref_c=cfg.wetbulb_ref_c, cop_min=cfg.cop_min,
        thermal=cfg.thermal_enabled,
        throttle=throttle_params(cfg),
        nameplate_w=max(cfg.nameplate_it_w, 1.0),
        cop_load_coef=cfg.cop_load_coef, cop_load_ref=cfg.cop_load_ref)


def tick_statics(cfg: SimConfig, statics: Statics) -> npw.TickStatics:
    """``power_tick``'s fixed inputs, checked (and on the card packed) once
    per ``make_step``; a banked trace keeps its (W, J, Q) layout."""
    return npw.tick_statics(
        statics.cpu_trace, statics.gpu_trace, statics.capacity[0],
        statics.capacity[1], statics.idle_w, statics.cpu_dyn_w,
        statics.gpu_dyn_w, statics.node_max_w, statics.peak_gflops,
        statics.node_rack, n_slots=cfg.max_nodes_per_job,
        n_racks=statics.rack_r_th.shape[0], n_res=statics.capacity.shape[0],
        consts=tick_consts(cfg))


def power_tick(ts: npw.TickStatics, state: SimState, wetbulb: torch.Tensor):
    """One tick's power chain in one launch (the plain version on the
    CPU), at the wetbulb the step evaluated, for one state or a fleet's
    (each replica reads its workload's slice of a banked trace). Returns
    (``PowerOut``, cop, the up nodes' idle power, and with thermals each
    job's clock factor (..., J), else None); with thermals the
    ``PowerOut`` is the derated one."""
    node_it, node_input, s, job_th = npw.power_tick(
        ts, state.jstate, state.t, state.start_t, state.placement, state.req,
        state.node_up, state.rack_outlet_c, wetbulb, state.workload)
    it_w, input_w, cooling_w, facility_w, pue, gflops, cop, idle_w = s.unbind(-1)
    return (PowerOut(node_it, node_input, it_w, input_w, cooling_w,
                     facility_w, pue, gflops), cop, idle_w, job_th)
