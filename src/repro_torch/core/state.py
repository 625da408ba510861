"""Simulator state: fixed-shape NamedTuples of tensors, so the twin is a
plain ``step(state, action) -> state`` function on one device.

Field names and dtypes (f32, int32) are those of the JAX package, so the
parity tests compare the two field by field. A fleet's state is the same
NamedTuple with a leading replica axis E on every field
(``broadcast_state`` makes one from a single state); the step runs on
either form. ``SimState`` keeps every field, the thermal, fault and
serving carries included; with a model off its carry is written once
here and never again.

Job lifecycle: EMPTY -> QUEUED -> RUNNING -> DONE (slot then reusable),
plus the terminal FAILED state of the fault engine (``core.faults``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.scenarios.scenario import Scenario, default_scenario
from repro_torch.utils.device import full, resolve_device, tree_to
from repro_torch.utils.prng import exponential, key_words, split

EMPTY, QUEUED, RUNNING, DONE, FAILED = 0, 1, 2, 3, 4
NRES = 3  # cpu cores, gpus, mem_gb


class Statics(NamedTuple):
    """Per-node constants + telemetry bank; not carried through the ticks.

    The bank is single — ``cpu_trace``/``gpu_trace`` (J, Q), ``net_tx``
    (J,) — or banked (``data.stack_workloads``): (W, J, Q) and (W, J),
    shared by every replica, which reads the slice of its
    ``SimState.workload``. A fleet's ``scenario`` is batched (a leading
    replica axis on every leaf).
    """

    capacity: torch.Tensor     # (NRES, N)
    node_type: torch.Tensor    # (N,) int32
    idle_w: torch.Tensor       # (N,)
    cpu_dyn_w: torch.Tensor    # (N,)
    gpu_dyn_w: torch.Tensor    # (N,)
    node_max_w: torch.Tensor   # (N,)
    peak_gflops: torch.Tensor  # (N,)
    node_rack: torch.Tensor    # (N,) int32 in [0, R)
    rack_r_th: torch.Tensor    # (R,) degC per W of rack heat
    rack_cap_w: torch.Tensor   # (R,) sum of member node_max_w
    rack_ptr: torch.Tensor     # (R+1,) int32: rack r's nodes are
    rack_nodes: torch.Tensor   # (N,) int32  rack_nodes[rack_ptr[r]:rack_ptr[r+1]]
    cpu_trace: torch.Tensor    # (J, Q) or banked (W, J, Q), in [0,1]
    gpu_trace: torch.Tensor    # (J, Q) or (W, J, Q)
    net_tx: torch.Tensor       # (J,) or (W, J), GB/s per job
    scenario: Scenario


class SimState(NamedTuple):
    t: torch.Tensor               # 0-d f32 seconds
    key: torch.Tensor             # (2,) int64 raw key words; unread here
    # nodes
    free: torch.Tensor            # (NRES, N)
    node_up: torch.Tensor         # (N,) f32 {0,1}
    repair_t: torch.Tensor        # (N,) time at which a down node returns
    # job table
    jstate: torch.Tensor          # (J,) int32
    submit_t: torch.Tensor        # (J,)
    start_t: torch.Tensor         # (J,)
    end_t: torch.Tensor           # (J,)
    dur_est: torch.Tensor         # (J,) requested walltime [s]
    work_left: torch.Tensor       # (J,) remaining work [s]
    n_nodes: torch.Tensor         # (J,) int32
    req: torch.Tensor             # (NRES, J) per-node demand
    part: torch.Tensor            # (J,) int32 partition tag; -1 = any
    priority: torch.Tensor        # (J,)
    placement: torch.Tensor       # (J, K) int32 node ids; -1 = unused slot
    n_failures: torch.Tensor      # (J,) int32
    # accumulators
    energy_kwh: torch.Tensor      # facility-side
    it_energy_kwh: torch.Tensor
    loss_energy_kwh: torch.Tensor  # rectification+conversion losses
    cool_energy_kwh: torch.Tensor
    carbon_kg: torch.Tensor
    elec_cost_usd: torch.Tensor
    flops_integral: torch.Tensor
    n_completed: torch.Tensor
    n_killed: torch.Tensor
    sum_wait: torch.Tensor
    sum_slowdown: torch.Tensor
    sum_power_w: torch.Tensor
    n_steps: torch.Tensor
    # thermal carry (written only by the thermal slice)
    rack_outlet_c: torch.Tensor   # (R,)
    thermal_throttle_s: torch.Tensor
    peak_rack_c: torch.Tensor
    # resilience carry (written by the fault engine, core.faults)
    next_fail_t: torch.Tensor     # (N,)
    rack_fail_t: torch.Tensor     # (R,)
    ckpt_interval: torch.Tensor   # (J,)
    degrade_level: torch.Tensor   # 0-d int32
    lost_node_s: torch.Tensor
    n_failed: torch.Tensor
    # serving carry (written by the serving twin, core.serving)
    srv_queue: torch.Tensor       # (B+1,)
    srv_inflight: torch.Tensor
    srv_retry_q: torch.Tensor     # (B+1,)
    srv_retry_t: torch.Tensor     # (B+1,)
    srv_active: torch.Tensor
    srv_wake_n: torch.Tensor
    srv_wake_t: torch.Tensor
    srv_target: torch.Tensor
    srv_admit_thresh: torch.Tensor
    srv_arrived: torch.Tensor
    srv_completed: torch.Tensor
    srv_shed: torch.Tensor
    srv_dropped: torch.Tensor
    srv_retried: torch.Tensor
    srv_slo_viol: torch.Tensor
    srv_lat_sum: torch.Tensor
    srv_lat_hist: torch.Tensor    # (8,)
    # id into a banked trace (0 for a single one); 0-d int32, (E,) batched
    workload: torch.Tensor


def rack_csr(node_rack, n_racks: int):
    """The racks' node lists as a CSR, from each node's rack id in
    [0, ``n_racks``): (``rack_ptr`` (R+1,), ``rack_nodes`` (N,)), both
    int32, each rack's nodes ascending. Racks need not be contiguous."""
    node_rack = np.asarray(node_rack)
    if node_rack.ndim != 1 or np.any((node_rack < 0) | (node_rack >= n_racks)):
        raise ValueError(f"rack ids must be (N,) in [0, {n_racks})")
    counts = np.bincount(node_rack, minlength=n_racks)
    ptr = np.zeros(n_racks + 1, np.int32)
    ptr[1:] = np.cumsum(counts)
    return ptr, np.argsort(node_rack, kind="stable").astype(np.int32)


def build_statics(
    cfg: SimConfig,
    trace_bank: Dict[str, Any] | None = None,
    scenario: Scenario | None = None,
    *,
    device: str | torch.device | None = None,
) -> Statics:
    """Expand per-type node constants into per-node tensors on ``device``
    (the CUDA card when ``None``)."""
    dev = resolve_device(device)
    caps, types, idle, cdyn, gdyn, nmax, gflops = [], [], [], [], [], [], []
    for ti, t in enumerate(cfg.node_types):
        for _ in range(t.count):
            caps.append([t.cpu_cores, t.gpus, t.mem_gb])
            types.append(ti)
            idle.append(t.idle_w + t.gpus * t.gpu_idle_w)
            cdyn.append(t.cpu_dyn_w)
            gdyn.append(t.gpus * t.gpu_dyn_w)
            nmax.append(t.idle_w + t.gpus * t.gpu_idle_w + t.cpu_dyn_w
                        + t.gpus * t.gpu_dyn_w)
            gflops.append(t.peak_gflops)
    J = cfg.max_jobs
    if trace_bank is None:
        q = 8
        trace_bank = {
            "cpu": np.zeros((J, q), np.float32),
            "gpu": np.zeros((J, q), np.float32),
            "net_tx": np.zeros((J,), np.float32),
        }
    # rack topology: consecutive index blocks; R_th per rack from the
    # design delta-T at the rack's IT nameplate
    node_rack = np.arange(cfg.n_nodes, dtype=np.int32) // cfg.nodes_per_rack
    rack_cap = np.zeros((cfg.n_racks,), np.float32)
    np.add.at(rack_cap, node_rack, np.array(nmax, np.float32))
    rack_r_th = cfg.rack_dt_full_load_c / np.maximum(rack_cap, 1.0)
    rack_ptr, rack_nodes = rack_csr(node_rack, cfg.n_racks)

    def f32(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device=dev)

    def i32(a):
        return torch.tensor(np.array(a, np.int32, order="C"), device=dev)

    return Statics(
        capacity=f32(np.array(caps, np.float32).T),
        node_type=i32(types),
        idle_w=f32(idle),
        cpu_dyn_w=f32(cdyn),
        gpu_dyn_w=f32(gdyn),
        node_max_w=f32(nmax),
        peak_gflops=f32(gflops),
        node_rack=i32(node_rack),
        rack_r_th=f32(rack_r_th),
        rack_cap_w=f32(rack_cap),
        rack_ptr=i32(rack_ptr),
        rack_nodes=i32(rack_nodes),
        cpu_trace=f32(trace_bank["cpu"]),
        gpu_trace=f32(trace_bank["gpu"]),
        net_tx=f32(trace_bank["net_tx"]),
        scenario=tree_to(
            scenario if scenario is not None else default_scenario(cfg), dev),
    )


def broadcast_state(state: SimState, n: int) -> SimState:
    """``n`` replicas of one state: every field with a leading axis of
    ``n``, each in its own memory (the caller's state is not aliased)."""
    return type(state)(*(
        v.unsqueeze(0).expand((n,) + tuple(v.shape)).contiguous()
        for v in state))


def init_state(cfg: SimConfig, statics: Statics, seed=0) -> SimState:
    """Empty twin at t = 0 on the device of ``statics``. ``seed`` is an
    int (the words of ``jax.random.key(seed)``, ``prng.key_words``) or
    key words, numpy or int64 torch: (2,) for one state, (E, 2) for E
    replicas, which gives every field a leading replica axis E (the JAX
    package's ``vmap`` of ``init_state`` over keys).

    With node (rack) failures on, the fault clocks are drawn here as the
    JAX package draws them: the key splits into (key, k) and
    ``next_fail_t`` (``rack_fail_t``) is an exponential draw from k times
    the MTBF in seconds, each replica from its own key. The stored key
    words are the split's first half, as there; with both MTBFs 0 nothing
    is drawn and the key is stored as given."""
    from repro_torch.core.thermal import supply_temp
    from repro_torch.scenarios.signals import eval_signal

    dev = statics.capacity.device
    if isinstance(seed, (int, np.integer)):
        key = torch.tensor(key_words(seed), device=dev)
    elif isinstance(seed, torch.Tensor):
        key = seed.to(device=dev, dtype=torch.int64)
    else:
        key = torch.tensor(np.asarray(seed, np.int64), device=dev)
    if key.dim() not in (1, 2) or key.shape[-1] != 2:
        raise ValueError(f"key words must be (2,) or (E, 2); got "
                         f"{tuple(key.shape)}")
    N = cfg.n_nodes
    J = cfg.max_jobs
    K = cfg.max_nodes_per_job
    R = cfg.n_racks
    B = cfg.serving_max_retries + 1
    f = torch.float32
    inf = float("inf")

    def zf(*shape):
        return torch.zeros(shape, dtype=f, device=dev)

    def cf(v, *shape):
        return torch.full(shape, v, dtype=f, device=dev)

    # racks start at the cooling supply temperature
    supply0 = supply_temp(cfg, eval_signal(statics.scenario.wetbulb, zf()))
    # event-sampled fault clocks: absolute exponential first-failure
    # times, drawn only with the MTBF knobs on (so fault-free configs keep
    # the key they were given)
    lead = tuple(key.shape[:-1])
    clocks = {}
    for name, mtbf_h, n in (("node", cfg.node_mtbf_hours, N),
                            ("rack", cfg.rack_mtbf_hours, R)):
        if mtbf_h > 0:
            pair = split(key, 2)
            key, k = pair[..., 0, :], pair[..., 1, :]
            # the scale is an f32 value on the device, as in the JAX
            # package: the product of two f32 values, whatever the device
            scale = full(float(np.float32(mtbf_h * 3600.0)), f, dev)
            clocks[name] = exponential(k, (n,)) * scale
        else:
            clocks[name] = cf(inf, *lead, n)
    next_fail, rack_fail = clocks["node"], clocks["rack"]
    state = SimState(
        t=zf(),
        key=key if key.dim() == 1 else key[0],
        free=statics.capacity.clone(),
        node_up=cf(1.0, N),
        repair_t=zf(N),
        jstate=torch.zeros((J,), dtype=torch.int32, device=dev),
        submit_t=zf(J),
        start_t=zf(J),
        end_t=zf(J),
        dur_est=zf(J),
        work_left=zf(J),
        n_nodes=torch.zeros((J,), dtype=torch.int32, device=dev),
        req=zf(NRES, J),
        part=torch.full((J,), -1, dtype=torch.int32, device=dev),
        priority=zf(J),
        placement=torch.full((J, K), -1, dtype=torch.int32, device=dev),
        n_failures=torch.zeros((J,), dtype=torch.int32, device=dev),
        energy_kwh=zf(),
        it_energy_kwh=zf(),
        loss_energy_kwh=zf(),
        cool_energy_kwh=zf(),
        carbon_kg=zf(),
        elec_cost_usd=zf(),
        flops_integral=zf(),
        n_completed=zf(),
        n_killed=zf(),
        sum_wait=zf(),
        sum_slowdown=zf(),
        sum_power_w=zf(),
        n_steps=zf(),
        rack_outlet_c=supply0 * torch.ones((R,), dtype=f, device=dev),
        thermal_throttle_s=zf(),
        peak_rack_c=supply0,
        next_fail_t=next_fail if key.dim() == 1 else next_fail[0],
        rack_fail_t=rack_fail if key.dim() == 1 else rack_fail[0],
        ckpt_interval=cf(cfg.ckpt_interval_s, J),
        degrade_level=torch.zeros((), dtype=torch.int32, device=dev),
        lost_node_s=zf(),
        n_failed=zf(),
        srv_queue=zf(B),
        srv_inflight=zf(),
        srv_retry_q=zf(B),
        srv_retry_t=cf(inf, B),
        srv_active=cf(float(cfg.serving_nodes)),
        srv_wake_n=zf(),
        srv_wake_t=cf(inf),
        srv_target=cf(float(cfg.serving_nodes)),
        srv_admit_thresh=cf(cfg.serving_admit_thresh),
        srv_arrived=zf(),
        srv_completed=zf(),
        srv_shed=zf(),
        srv_dropped=zf(),
        srv_retried=zf(),
        srv_slo_viol=zf(),
        srv_lat_sum=zf(),
        srv_lat_hist=zf(8),
        workload=torch.zeros((), dtype=torch.int32, device=dev),
    )
    if key.dim() == 2:
        state = broadcast_state(state, key.shape[0])._replace(
            key=key, next_fail_t=next_fail, rack_fail_t=rack_fail)
    return state


def load_jobs(state: SimState, jobs: Dict[str, np.ndarray],
              *, validate: str = "strict") -> SimState:
    """Install a workload (from the trace loader or synthesizer) into the
    job table. ``jobs`` fields: submit_t, dur, n_nodes, req (NRES, J'),
    priority, optionally ``part`` (int32 node-type index per job; -1 = any)
    and ``ckpt_interval``; J' <= max_jobs. A batched state (a leading
    replica axis) gets the same jobs in every replica.

    The jobs dict is validated (``data.validate.validate_jobs``) before
    touching the table. ``validate`` is ``"strict"`` (default; raises
    ``TraceValidationError`` naming the offending job indices),
    ``"repair"`` (drops bad jobs) or ``"off"``.
    """
    if validate != "off":
        from repro_torch.data.validate import validate_jobs

        jobs, _ = validate_jobs(jobs, mode=validate)
    J = state.jstate.shape[-1]
    n = len(jobs["submit_t"])
    if n > J:
        raise ValueError(f"workload has {n} jobs > max_jobs {J}")
    dev = state.jstate.device

    def f32(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device=dev)

    def i32(a):
        return torch.tensor(np.array(a, np.int32, order="C"), device=dev)

    def set_head(field, values):
        out = field.clone()
        out[..., :n] = values
        return out

    if "ckpt_interval" in jobs:
        state = state._replace(ckpt_interval=set_head(
            state.ckpt_interval, f32(jobs["ckpt_interval"])))
    return state._replace(
        jstate=set_head(state.jstate, QUEUED),
        submit_t=set_head(state.submit_t, f32(jobs["submit_t"])),
        dur_est=set_head(state.dur_est, f32(jobs["dur"])),
        work_left=set_head(state.work_left, f32(jobs["dur"])),
        n_nodes=set_head(state.n_nodes, i32(jobs["n_nodes"])),
        req=set_head(state.req, f32(jobs["req"])),
        part=set_head(state.part, i32(jobs.get("part", -np.ones(n)))),
        priority=set_head(state.priority,
                          f32(jobs.get("priority", np.zeros(n)))),
    )
