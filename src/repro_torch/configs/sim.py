"""Datacenter (digital-twin) configuration.

``tx_gaia()`` models the MIT SuperCloud TX-GAIA system used by the paper:
448 GPU nodes (2x Xeon Gold 6248, 2x V100-32GB SXM2) plus Xeon-Platinum CPU
nodes, multi-tenant, with CPU telemetry at 10 s quanta and GPU telemetry at
100 ms (Samsi et al., HPEC'21).

Power-chain parameters follow RAPS: node IT power -> AC-DC rectification
efficiency curve eta(load) -> DC-DC voltage-conversion efficiency -> plus
cooling power (PUE model). All knobs are plain Python floats; the
simulator turns them into tensor constants on its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class NodeType:
    name: str
    count: int
    cpu_cores: int
    gpus: int
    mem_gb: float
    idle_w: float          # chassis idle (fans, board, DIMMs)
    cpu_dyn_w: float       # max additional W at 100% CPU util (whole node)
    gpu_idle_w: float      # per-GPU idle
    gpu_dyn_w: float       # per-GPU max additional W at 100% util
    peak_gflops: float     # per-node peak GFLOP/s (for GFLOPS/W stats)


@dataclass(frozen=True)
class SimConfig:
    name: str
    node_types: Tuple[NodeType, ...]
    # capacity limits for the fixed-shape job table
    max_jobs: int = 512            # max resident (queued+running) jobs
    max_nodes_per_job: int = 64
    # time discretization
    dt: float = 1.0                # simulator step [s]
    trace_quanta: float = 10.0     # telemetry averaging quantum [s]
    # power chain (RAPS-style)
    rect_eff_peak: float = 0.965   # peak rectifier efficiency
    rect_eff_load: float = 0.55    # load fraction at which peak occurs
    rect_eff_curv: float = 0.12    # curvature of the efficiency parabola
    conv_eff: float = 0.975        # DC-DC voltage conversion efficiency
    # cooling: P_cool = P_IT / COP(wetbulb); PUE emerges from the chain
    cop_base: float = 5.2
    cop_wetbulb_coef: float = -0.08   # COP drop per degC wetbulb above ref
    wetbulb_ref_c: float = 18.0
    wetbulb_mean_c: float = 16.0
    wetbulb_amp_c: float = 6.0        # diurnal amplitude
    # carbon intensity (diurnal, gCO2/kWh)
    carbon_mean: float = 380.0
    carbon_amp: float = 120.0
    day_seconds: float = 86_400.0
    # electricity price (diurnal, $/kWh; evening peak)
    price_mean_usd_kwh: float = 0.11
    price_amp_usd_kwh: float = 0.04
    # network (inter-job congestion; Lassen-style bytes in/out coupling)
    bisection_gbps: float = 2_400.0   # system bisection bandwidth
    congestion_exp: float = 1.5       # slowdown = (1 + load^exp) beyond knee
    congestion_knee: float = 0.7      # utilization where contention kicks in
    # failures (sustainability studies under faults; docs/resilience.md)
    node_mtbf_hours: float = 0.0      # 0 = node failures off
    node_repair_hours: float = 4.0
    # correlated failure domains: a rack fault (cooling loop / PDU) downs
    # every node in the rack at once. 0 = rack faults off.
    rack_mtbf_hours: float = 0.0
    rack_repair_hours: float = 2.0
    # job resilience semantics: killed jobs restart from their last
    # simulated checkpoint (0 = restart from zero work, the legacy rule);
    # each checkpoint write costs ckpt_overhead_s of runtime at full power.
    ckpt_interval_s: float = 0.0
    ckpt_overhead_s: float = 0.0
    # retry budget: a job killed more than max_job_retries times goes
    # terminal FAILED (0 = unbounded retries, the legacy rule). Requeued
    # jobs wait requeue_backoff_s * mult**(n_failures-1) before eligible.
    max_job_retries: int = 0
    requeue_backoff_s: float = 0.0
    requeue_backoff_mult: float = 2.0
    # scenario-driven grid outages / maintenance windows (Scenario.outages)
    outages_enabled: bool = False
    # graceful-degradation ladder (throttle -> gate -> drain -> evict) as
    # a schedulable action (SchedEnv) / forced by outage brownout levels
    degrade_enabled: bool = False
    degrade_throttle_frac: float = 0.7
    # demand response (DCFlex-style): cap facility power by DVFS-throttling
    # running jobs (linear power/progress model). 0 = uncapped.
    power_cap_w: float = 0.0
    throttle_floor: float = 0.3       # never clock below 30%
    # thermal twin (per-rack RC cooling loop; docs/thermal.md). Python bool
    # so thermal-off compiles the legacy static-COP chain bit-identically.
    thermal_enabled: bool = False
    nodes_per_rack: int = 32
    rack_tau_s: float = 600.0          # first-order outlet-temp lag [s]
    rack_dt_full_load_c: float = 20.0  # design outlet-supply delta at rack
    #                                    nameplate IT power (sets R_th)
    cooling_approach_c: float = 4.0    # supply-air approach over wetbulb
    cooling_supply_min_c: float = 14.0 # plant never supplies below this
    throttle_start_c: float = 55.0     # outlet temp where derating begins
    throttle_full_c: float = 75.0      # outlet temp where derating saturates
    thermal_throttle_floor: float = 0.4
    thermal_trip_c: float = 65.0       # racks above this accept no NEW jobs
    # COP(wetbulb, IT load): plants run closest to design efficiency near
    # their rated load — part-load COP drops (ISO chiller part-load curves)
    cop_load_coef: float = 1.2         # COP gain per unit IT-load fraction
    cop_load_ref: float = 0.5          # load fraction of the nominal COP
    cop_min: float = 1.5
    # online-inference serving twin (core/serving.py; docs/serving.md):
    # a pool of serving_nodes inference nodes — disjoint from the batch
    # fleet, power injected into the shared plant chain — serves a fluid
    # request mass driven by Scenario.traffic. Python-bool + pool-size
    # gate (``serving_on``) so serving-off compiles the legacy program
    # bit-identically.
    serving_enabled: bool = False
    serving_nodes: int = 0             # inference pool size (not in n_nodes)
    serving_concurrency: float = 8.0   # concurrent requests per awake node
    serving_service_s: float = 4.0     # per-request service time at clock 1.0
    serving_prefill_frac: float = 0.15  # fraction of service_s in prefill
    serving_prefill_util: float = 0.9   # accelerator util during prefill
    serving_decode_util: float = 0.45   # accelerator util during decode
    serving_node_idle_w: float = 300.0  # awake-but-idle node power
    serving_node_dyn_w: float = 700.0   # extra W at full util + occupancy
    serving_sleep_w: float = 30.0       # asleep node power (SPARS knob)
    serving_wake_s: float = 120.0       # sleep -> serving wake latency
    serving_queue_cap: float = 512.0    # hard admission-queue bound [req]
    serving_admit_thresh: float = 0.9   # initial admitted queue fraction
    serving_timeout_s: float = 30.0     # queue-reach timeout; 0 = off
    serving_slo_s: float = 10.0         # SLO latency target [s]
    serving_max_retries: int = 3        # retry budget (backoff tiers)
    serving_backoff_s: float = 4.0      # base retry backoff [s]
    serving_backoff_mult: float = 2.0
    serving_backoff_cap_s: float = 60.0
    serving_scale_step: float = 1.0     # autoscale action increment [nodes]
    # RL / scheduling
    sched_max_candidates: int = 8     # jobs visible to the RL agent per step
    backfill_reserve: int = 1         # EASY: #head jobs that get reservations
    seed: int = 0

    @property
    def n_nodes(self) -> int:
        return sum(t.count for t in self.node_types)

    @property
    def resilience_on(self) -> bool:
        """Python-bool gate for the fault engine: False compiles the
        legacy fault-free program bit-identically (no extra state reads,
        no PRNG consumption, no horizon terms)."""
        return (self.node_mtbf_hours > 0 or self.rack_mtbf_hours > 0
                or self.outages_enabled or self.degrade_enabled)

    @property
    def serving_on(self) -> bool:
        """Python-bool gate for the serving twin: False compiles the
        legacy batch-only program bit-identically (no serving state
        writes, no horizon terms, no extra obs/actions)."""
        return self.serving_enabled and self.serving_nodes > 0

    @property
    def n_types(self) -> int:
        return len(self.node_types)

    @property
    def n_racks(self) -> int:
        return -(-self.n_nodes // self.nodes_per_rack)

    @property
    def nameplate_it_w(self) -> float:
        """All-nodes-at-full-load IT power (sum of per-node node_max_w);
        the reference scale for sizing demand-response caps."""
        return sum(
            t.count * (t.idle_w + t.gpus * t.gpu_idle_w + t.cpu_dyn_w
                       + t.gpus * t.gpu_dyn_w)
            for t in self.node_types
        )


def partition_type_indices(cfg: SimConfig) -> Tuple[int, int]:
    """(first GPU-bearing type index, first CPU-only type index) — THE
    partition-tag fallback rule, shared by the workload loaders
    (``data.synth_trace`` / ``data.trace_io``). -1 = the config has no
    type of that kind, so jobs get tag -1 (any node)."""
    gpu_ti = next((i for i, t in enumerate(cfg.node_types) if t.gpus > 0),
                  -1)
    cpu_ti = next((i for i, t in enumerate(cfg.node_types) if t.gpus == 0),
                  -1)
    return gpu_ti, cpu_ti


def tx_gaia(**overrides) -> SimConfig:
    """MIT SuperCloud TX-GAIA twin (GPU partition + CPU partition)."""
    types = (
        NodeType(
            name="txg-v100",
            count=448,
            cpu_cores=40,            # 2x Xeon Gold 6248
            gpus=2,                  # 2x V100-32GB SXM2
            mem_gb=384.0,
            idle_w=240.0,
            cpu_dyn_w=260.0,         # 2x 125W TDP + DIMM activity
            gpu_idle_w=55.0,
            gpu_dyn_w=245.0,         # 300W SXM2 TDP - idle
            peak_gflops=2 * 7_800.0 + 2_300.0,  # 2x V100 fp64+tensor mix + CPUs
        ),
        NodeType(
            name="xeon-p8",
            count=224,
            cpu_cores=48,            # 2x Xeon Platinum 8260
            gpus=0,
            mem_gb=192.0,
            idle_w=160.0,
            cpu_dyn_w=330.0,
            gpu_idle_w=0.0,
            gpu_dyn_w=0.0,
            peak_gflops=3_300.0,
        ),
    )
    return SimConfig(name="tx-gaia", node_types=types, **overrides)


def tiny_cluster(**overrides) -> SimConfig:
    """Small heterogeneous cluster for tests/examples (fast to simulate)."""
    types = (
        NodeType("gpu", 8, 16, 2, 128.0, 100.0, 120.0, 30.0, 240.0, 16_000.0),
        NodeType("cpu", 8, 32, 0, 64.0, 80.0, 200.0, 0.0, 0.0, 2_000.0),
    )
    kw = dict(max_jobs=64, max_nodes_per_job=4, sched_max_candidates=4)
    kw.update(overrides)
    return SimConfig(name="tiny", node_types=types, **kw)
