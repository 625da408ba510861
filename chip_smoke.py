#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each; any failure ends the run with a non-zero exit
and no result line:

1. env       torch/CUDA versions, the card's name and power limit; TF32 off.
2. build     compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, all at once); the bf16 flash_attn
             kernels must hold ``HGMMA`` (wgmma) in their SASS and spill
             nothing (ptxas).
3. kernel    each kernel against its plain PyTorch version on the card, at
             the paths' shapes (E=1 and E=64 replicas of the TX-GAIA job
             table, nodes and racks; the fleet's tick over a banked trace
             of three workloads at E=72 and 1152; gemma3-1b's, qwen3-4b's and jamba's
             prefill attention; jamba's selective scan at its 8-layer
             prefill and at a ragged length, the signature entry in f32
             and the Mamba mixer's fused entry ``mamba_scan`` in bf16 and
             f32), and timed (CUDA events, median) beside its bound and,
             for attention, ``scaled_dot_product_attention``. The replay
             tick's fused
             entries (``power_tick`` with thermals off at E=1 and on at
             E=1 and 64, ``rack_tick`` at E=1 and 64; then each at E=1 and
             64 with rack 0 down and ~5% of the other nodes down, as the
             fault engine leaves them) also against the CPU plain
             version: per-node and per-rack values bitwise. An empty
             kernel's back-to-back time is the launch floor. The fault
             clocks' exponential transform on all 2**23 values the
             uniform can give, card against CPU: 0 differing bits.
4. main      ``replay_tx_gaia_1h`` through build_statics -> init_state ->
             load_jobs -> run_episode(summary_only) -> summary, the ticks
             under ``torch.cuda.set_sync_debug_mode("error")``; held to the
             JAX package's pinned values and to one kernel launch per tick.
5. thermal   the same for ``replay_tx_gaia_1h_thermal`` and
             ``replay_tx_gaia_1h_thermal_stress`` (the rack thermal twin):
             pinned values, and one power_scatter and one rack_thermal
             launch per tick.
6. fleet     the fleet case (``acceptance.fleet_grid``: 8 policies x 9
             grid scenarios, 72 replicas of ``replay_tx_gaia_1h``) for the
             hour in one ``run_fleet`` under sync-debug "error": every
             replica at ``PINNED_FLEET`` (the JAX package's vmapped
             ``run_fleet``), replica 0 at ``replay_tx_gaia_1h``'s pins, one
             power_scatter launch a tick for all replicas; five replicas
             rerun alone through ``run_episode`` (integers equal, floats
             within 1e-5); the thermal hour's config for 600 ticks at E =
             72 (one rack_thermal launch a tick), two replicas rerun
             alone; ms per tick, us per replica-tick, CUDA kernels per
             tick and the device's busy share at E = 1, 72 and 1152
             (FLEET_TIMING ticks each, FLEET_PROFILE under the profiler).
7. rl        the paper's experiment at full width (``acceptance.RL_CASES``:
             TX-GAIA, 672 nodes, the 256 x 16 job table, four 40-job
             workloads, 15 ticks a decision, ``macro=False``): 8
             environments of ``SchedEnv`` as the replicas of one batched
             state, driven by a fixed action script for 32 decisions
             (``rl_tx_gaia``) and 8 on the thermal stress config, under
             sync-debug "error", held to ``PINNED_RL`` (the JAX package's
             ``SchedEnv``), one power_scatter (and, with thermals, one
             rack_thermal) launch per batched tick; ``ppo_train(seed=0)``
             for 2 iterations: iteration 0's sampled actions equal to the
             pins, its rollout stats within 1e-5, the loss stats within
             1e-3, one host sync per chunk and none inside it, a rerun
             bitwise equal; then env decisions and replica-ticks per
             second at 8, 64 and 512 environments (twice each), ms per
             PPO iteration (rollout and update), and over RL_PROFILE_STEPS
             decisions of the rollout CUDA kernels per env step and the
             device's busy share (``profile_tick.profile_rl``).
8. macro     macro-stepping (quiet ticks fast-forwarded): the three replay
             hours through ``run_episode(macro=True)`` at ``PINNED_MACRO``
             (the JAX package's macro path; the event-tick count exactly
             with thermals off), integers equal to the per-tick hours of
             phases 4-5 and the largest float difference reported; one
             power_scatter (and rack_thermal) launch per tick issued;
             every host read through ``utils.device.host_read``, at most
             1 + ceil(segment / 16) a macro step, and no other sync; ms
             per simulated tick beside the per-tick hour's (kernels per
             event and per fast tick: ``profile_tick --macro``). The
             fleet hour at ``macro=True`` (72 replicas in
             lockstep) at ``PINNED_FLEET_MACRO``, two replicas rerun
             alone; ``SchedEnv(macro=True)``: ``rl_tx_gaia``'s script and
             one PPO iteration at ``PINNED_RL_MACRO``, decisions/s at 8 and
             512 environments, host reads and kernels per env step.
9. faults    the resilience twin (``acceptance.FAULT_CASES``) under
             sync-debug "error": ``replay_tx_gaia_1h_faults`` (random node
             and rack faults, checkpoints, retries) and
             ``replay_tx_gaia_1h_drill`` (a rack's maintenance window and
             an evicting brownout, thermals on) for the hour at
             ``PINNED_FAULTS`` (the JAX package's per-tick values), one
             power_scatter (and on the drill one rack_thermal) launch per
             tick, ms per tick beside phase 4's; both macro-stepped:
             bitwise equal to per tick, at the pinned event ticks, within
             the read gate, one launch per tick issued; the fault fleet
             (``FLEET_FAULTS_E`` replicas with their own keys and clocks,
             default grid and drill, ``FLEET_FAULTS_TICKS`` ticks of fcfs)
             at ``PINNED_FLEET_FAULTS``, two replicas rerun alone;
             ``rl_tx_gaia_faults`` (the ladder's actions, the lost-work
             reward) per tick and macro at ``PINNED_RL_FAULTS``; CUDA
             kernels a tick of the faults hour with the fault engine's
             share (``profile_tick.profile_replay``); the phase's seconds.
10. determinism  the first 300 ticks of the main path and the first 450 of
             the thermal stress hour, each twice: every field bitwise equal.
11. serve    gemma3-1b at full width and depth (``serve_gemma3_1b``,
             weights from ``seeded_numpy_params``): the f32 and the bf16
             model held to the JAX package's pins (``check_lm``), 26
             flash_attn launches per prefill and none per decode step, the
             bf16 prefill/decode invariant, and ``generate`` at B = 4,
             prompt 1024, 32 new tokens under sync-debug "error" (prefill
             ms, decode ms per token, tokens/s: median of SERVE_RUNS).
12. serve_hybrid  the jamba hybrid without experts at full width:
             ``serve_jamba_1l`` (one Mamba layer, f32) held to
             ``PINNED_JAMBA``; ``serve_jamba_8l`` (one whole 7:1 period,
             random weights from ``init_params`` on the card) in f32 and in
             bf16: the prefill/decode invariant (f32 within 1e-4; in bf16
             the decode step within twice the bf16 prefill's distance from
             the f32 model's answer), 7 selective_scan (the Mamba mixer's
             fused ``mamba_scan``) and 1 flash_attn launches per prefill
             and none per decode step; then ``generate`` in bf16 as in
             ``serve``.
13. serving  the serving twin (run after ``faults``): the replay hour with
             a pool of 32 inference nodes under diurnal traffic and a
             flash crowd (``replay_tx_gaia_1h_serving``) per tick under
             sync-debug "error" at ``PINNED_SERVING`` (the JAX package's
             per-tick values), one power_scatter launch a tick, ms a tick
             beside phase 4's; macro-stepped: bitwise equal to per tick,
             its event and fast ticks, within the read gate, one launch a
             tick issued; the serving fleet (``FLEET_SERVING_E`` replicas
             at rising peak traffic, ``FLEET_SERVING_TICKS`` ticks) at
             ``PINNED_FLEET_SERVING``, two replicas rerun alone (in
             workers, while the parent runs the fleet and
             ``rl_tx_gaia_serving`` per tick and macro at
             ``PINNED_RL_SERVING``); CUDA kernels a
             serving tick and the plain hour's in the same run; the
             phase's seconds.

14. durable  the durable layer (run after ``serving``) under sync-debug
             "error", each snapshot and fingerprint one counted read
             (``utils.device.drain``): ``replay_tx_gaia_1h`` snapshotted
             every 600 s, bitwise equal to phase 4's hour with 1 + 6
             reads, ms and bytes a snapshot, its ms a tick beside phase
             4's and a plain 300-tick window's timed just after it, in the
             same conditions; its snapshots after tick
             1,800 deleted and the run resumed: bitwise, 1 + 3 reads;
             ``replay_tx_gaia_1h_faults`` macro-stepped for 1,200 ticks
             with a snapshot every 120 s, uninterrupted and killed after
             its 4th snapshot, bitwise (key words included), within the
             read gate plus one read a snapshot; ``chaos_smoke`` of the
             same on the card (2 SIGKILLs, each after the launch's first
             snapshot, ``REPRO_CHAOS_SLOW_SAVE=0.2``), the killed
             workers' digests equal to the uninterrupted worker's and the
             final launch resumed from a snapshot (in worker processes
             beside the rest, after the snapshotted hour, which runs
             alone so its ms a tick compares with phase 4's); the
             fault fleet (``FLEET_FAULTS_E`` replicas, 600 ticks, a
             snapshot every 150 s) snapshotted in a worker, killed after
             its 2nd snapshot and resumed in the parent, bitwise;
             ``ppo_train`` on ``rl_tx_gaia`` with a checkpoint every
             iteration bitwise equal to phase ``rl``'s run, iteration 1's
             checkpoint deleted and resumed to 2, bitwise; with
             ``REPRO_CHECKIFY=1`` 300 ticks of the faults hour pass with
             one extra read and a state with ``free + 100`` raises
             ``InvariantError`` naming resource conservation at tick 0;
             with the gate off the plain and serving ticks keep their 463
             and 674 launch calls (phase ``serving``'s profiles), and
             inside ``run_episode`` a tick launches what a bare
             ``make_step`` + telemetry loop does, its step 463 / 674
             (``profile_tick.episode_launch_calls``); the phase's
             seconds.

Replicas rerun alone (phases ``fleet``, ``macro``, ``faults``,
``serving``, and the fleet of ``durable``) each run in a worker process of
their own on the card
(``run_alone``: this script with ``--alone``, ALONE_WORKERS at once), so
the checks of a phase run together; the parent waits for all of them and
stops any that fails.

The launch counts are set to 0 just before each path and read just after.
Then the ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. It needs no network, and exits non-zero
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
KERNEL_RTOL = 1e-5
TIMING_REPS = 50               # timed batches (median over these)
TIMING_BATCH = 20              # back-to-back calls per timed batch
DETERMINISM = (("replay_tx_gaia_1h", 300),
               ("replay_tx_gaia_1h_thermal_stress", 450))
THERMAL_CASES = ("replay_tx_gaia_1h_thermal",
                 "replay_tx_gaia_1h_thermal_stress")
INF_CLOCKS = {"next_fail_t", "rack_fail_t", "srv_retry_t", "srv_wake_t"}
# flash_attn at gemma3-1b's prefill (B 4, S 1024, H 4, Kv 1, hd 256) and
# qwen3-4b's GQA (H 32, Kv 8, hd 128): (name, dtype, b, s, h, kv, hd,
# causal, window, tolerance (atol = rtol))
ATTN_CASES = (
    ("gemma3-1b causal", "bfloat16", 4, 1024, 4, 1, 256, True, 0, 2e-2),
    ("gemma3-1b window 512", "bfloat16", 4, 1024, 4, 1, 256, True, 512, 2e-2),
    ("gemma3-1b causal f32", "float32", 4, 1024, 4, 1, 256, True, 0, 2e-5),
    ("qwen3-4b causal", "bfloat16", 4, 1024, 32, 8, 128, True, 0, 2e-2),
    ("jamba causal", "bfloat16", 4, 1024, 64, 8, 128, True, 0, 2e-2),
)
ATTN_REPORTED = "gemma3-1b window 512"   # 22 of gemma3-1b's 26 layers
ATTN_TIMING = (10, 5)                    # timed batches, calls per batch
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_RUNS = 4, 1024, 32, 3
SERVE_TOL = 2e-2     # bf16 prefill/decode invariant (tests/test_prefill_decode.py)
# selective_scan at jamba's 8-layer prefill (Ba 4, S 1024, di 16384, ds 16)
# and at a length no 256-step chunk divides: (name, ba, s, di, ds)
SCAN_CASES = (("jamba prefill", 4, 1024, 16384, 16),
              ("ragged", 2, 1025, 16384, 16))
SCAN_TOL = 1e-5      # atol = rtol: the signature entry, the fused f32 output
#                      and the fused final state (f32) in both dtypes
MAMBA_BF16_TOL = 1.6e-2   # atol = rtol: two bf16 ulps at order 1
MAMBA_DT_RANK = 512       # jamba's x_proj output: dt_rank + 2 ds columns
SCAN_TIMING = (10, 5)        # kernel: timed batches, calls per batch
SCAN_PLAIN_TIMING = (3, 1)   # plain version: ~20 small kernels per step
# H100 SXM special-function units: 16 exponentials a clock on each of the
# 132 SMs at the 1.98 GHz boost clock (CUDA programming guide, throughput
# of arithmetic instructions, compute capability 9.0)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
SCAN_F32_OPS = 6     # f32 operations per (step, channel, state) besides exp
# the fused entry's transcendentals per (step, channel) besides the decays:
# softplus's exp and log1p, silu's exp
MAMBA_SFU_PER_ELEM = 3
# serve_jamba_8l's prefill/decode invariant: f32 within 1e-4 (atol =
# rtol). In bf16 its logits are of order 1 (gemma3-1b's of order 0.05),
# and bf16's rounding, carried through 8 random-weight layers, moves them
# by several hundredths (the JAX package's own bf16 decode step parts from
# its prefill by 0.13 at the reduced widths), past SERVE_TOL, which is
# reported. So the bf16 decode step's logits are held to the f32 model's
# longer prefill: within BF16_DECODE_FACTOR times the bf16 prefill's own
# distance from it. At the reduced widths on the CPU, zeroing one layer's
# conv cache moves the decode step 37x that distance off, its ssm state
# 3.5x; subtler faults are the f32 invariant's to find.
HYBRID_TOL = 1e-4
BF16_DECODE_FACTOR = 2.0
# the fleet phase: replicas timed (1, the grid, the grid tiled 16x), ticks
# timed at each, and (start tick, ticks) of each profile
FLEET_SIZES = (1, 72, 1152)
FLEET_TIMING = 150
FLEET_PROFILE = (100, 5)
# the rl phase: environments timed, decisions per timed rollout
RL_SCALE_ENVS = (8, 64, 512)
RL_SCALE_STEPS = 4
RL_PROFILE_STEPS = 1   # decisions of the rollout under the profiler
# the macro phase: the engine's chunk of fast ticks a host read (its
# default), the fleet replicas rerun alone, and the environments timed
MACRO_CHUNK = 16
MACRO_FLEET_ALONE = (8, 71)
MACRO_RL_ENVS = (8, 512)
# phase faults: the faults hour profiled from this tick, for this many
# ticks (the profiler's processing of a tick of ~1,250 kernels is slow)
FAULTS_PROFILE = (100, 5)
# the serving phase's profiles of the serving tick and the plain tick:
# (start tick, ticks)
SERVING_PROFILE = (100, 5)
# replicas rerun alone run in worker processes on the card, this many at
# once (the machine has 8 cores; each run is host-bound)
ALONE_WORKERS = 7
ALONE_TIMEOUT_S = 600
# the durable phase: the main hour snapshotted every 600 s and killed
# after tick 1,800; the faults hour macro-stepped for 1,200 ticks with a
# snapshot every 120 s, killed after its 4th; the chaos kill loop on the
# same; the fault fleet for 600 ticks, a snapshot every 150 s, killed
# after its 2nd; the invariant harness over 300 ticks; the launch calls of
# a plain and a serving tick with the gate off (phase serving's
# profile_tick), also inside ``run_episode`` (DURABLE_EPISODE_CALLS: start
# tick, ticks)
DURABLE_HOUR_SNAP_S = 600.0
# a plain window of the hour's first ticks, timed right after the
# snapshotted hour in the same conditions (phase 4 ran before any profile)
DURABLE_PLAIN_TICKS = 300
DURABLE_KILL_TICK = 1800
DURABLE_FAULTS = "replay_tx_gaia_1h_faults"
DURABLE_FAULTS_TICKS = 1200
DURABLE_FAULTS_SNAP_S = 120.0
DURABLE_FAULTS_KILL_AFTER = 4
# the chaos loop: each kill comes a seeded delay after the launch's first
# snapshot (``chaos.KILL_DELAY_S``), so the final launch resumes from one
DURABLE_CHAOS = dict(kills=2, slow_save_s=0.2)
DURABLE_CHAOS_TIMEOUT_S = 600
DURABLE_FLEET_TICKS = 600
DURABLE_FLEET_SNAP_S = 150.0
DURABLE_FLEET_KILL_AFTER = 2
DURABLE_CHECK_TICKS = 300
DURABLE_GATE_OFF_CALLS = {"replay_tx_gaia_1h_serving": 674.0,
                          "replay_tx_gaia_1h": 463.0}
DURABLE_EPISODE_CALLS = (100, 2)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = TIMING_REPS,
            batch: int = TIMING_BATCH) -> float:
    """Median per-call milliseconds of ``fn`` over ``reps`` batches of
    ``batch`` back-to-back calls, timed with CUDA events after warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    times.sort()
    return times[len(times) // 2]


def power_scatter_inputs(torch, np, statics, n_rep: int, jk: int, seed: int):
    """Seeded job tables at the main path's shapes: the TX-GAIA node
    vectors, ids in [-1, N) (about a third of the slots unused, as in a
    replay), per-slot amounts zero on unused slots, and ~5% nodes down."""
    rng = np.random.default_rng(seed)
    n = statics.idle_w.shape[0]
    place = rng.integers(-1, n, (n_rep, jk))
    place[rng.random((n_rep, jk)) < 0.33] = -1
    valid = place >= 0
    cabs = rng.uniform(0.0, 24.0, (n_rep, jk)) * valid
    gabs = rng.uniform(0.0, 2.0, (n_rep, jk)) * valid
    up = (rng.random((n_rep, n)) > 0.05).astype(np.float32)
    dev = statics.idle_w.device

    def t(a, dt):
        return torch.tensor(np.array(a, dt, order="C"), device=dev)

    return (t(place, np.int32), t(cabs, np.float32), t(gabs, np.float32),
            statics.capacity[0].contiguous(), statics.capacity[1].contiguous(),
            statics.idle_w, statics.cpu_dyn_w, statics.gpu_dyn_w,
            t(up, np.float32), statics.node_max_w)


def power_scatter_bound(args) -> tuple[float, str]:
    """The f32 operations this data needs: 2 adds per used slot, ~25 per
    node of the chain."""
    place = args[0]
    n_rep, n = args[8].shape
    ops = 2 * int((place >= 0).sum()) + 25 * n_rep * n
    return bound(nbytes(args), 4 * n_rep * n * 4, ops)


def bound(in_bytes: int, out_bytes: int, ops: int) -> tuple[float, str]:
    """Least milliseconds the card could take: each input read once and
    each output written once at the HBM rate, against ``ops`` f32
    operations at the f32 peak."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rack_thermal_inputs(torch, np, statics, n_rep: int, seed: int):
    """Seeded rack-thermal inputs at the thermal path's shapes: per-node
    input power of a loaded TX-GAIA node, outlet temperatures around the
    stress case's thresholds, the TX-GAIA racks."""
    rng = np.random.default_rng(seed)
    n = statics.node_rack.shape[0]
    r = statics.rack_r_th.shape[0]
    dev = statics.idle_w.device

    def t(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device=dev)

    return (t(rng.uniform(150.0, 1400.0, (n_rep, n))), statics.node_rack,
            t(rng.uniform(18.0, 34.0, (n_rep, r))),
            t(rng.uniform(14.0, 24.0, n_rep)), statics.rack_r_th)


def down_nodes(np, cfg, rng, n_rep: int):
    """(n_rep, N) node_up as the fault engine leaves it: rack 0 down (a
    maintenance window or a rack fault) and ~5% of the others down."""
    up = rng.random((n_rep, cfg.n_nodes)) > 0.05
    up[:, :cfg.nodes_per_rack] = False
    return up


def tick_state(torch, np, cfg, n_rep: int, seed: int, rack_down=False):
    """Seeded per-tick state of ``n_rep`` replicas at the main path's
    shapes, as ``power_tick`` takes it: ~70% of the jobs running at ages
    across the trace quanta, a third of the slots -1, ~5% nodes down (and
    with ``rack_down`` rack 0 too), outlet temperatures across the
    throttle ramp, a wetbulb."""
    rng = np.random.default_rng(seed)
    J, K, N, R = cfg.max_jobs, cfg.max_nodes_per_job, cfg.n_nodes, cfg.n_racks
    place = rng.integers(0, N, (n_rep, J, K))
    place[rng.random((n_rep, J, K)) < 0.33] = -1
    lo, hi = cfg.throttle_start_c - 10.0, cfg.throttle_full_c + 5.0
    up = (down_nodes(np, cfg, rng, n_rep) if rack_down
          else rng.random((n_rep, N)) > 0.05)
    arrays = ((rng.choice([1, 2, 2, 2, 3], (n_rep, J)), np.int32),
              (rng.uniform(600, 3600, n_rep), np.float32),
              (rng.uniform(0, 3000, (n_rep, J)), np.float32),
              (place, np.int32),
              (rng.uniform(1, 24, (n_rep, 3, J)), np.float32),
              (up, np.float32),
              (rng.uniform(lo, hi, (n_rep, R)), np.float32),
              (rng.uniform(8, 26, n_rep), np.float32))
    return [torch.tensor(np.array(a, dt, order="C"), device="cuda")
            for a, dt in arrays]


def power_tick_bound(ts, st) -> tuple[float, str]:
    """What ``power_tick`` must move and do on these inputs: each per-tick
    input once (two rows of ``req``; the workload ids when given), one
    trace entry per job and bank,
    the node vectors (and racks, with thermals) once; the outputs. About 6
    f32 operations per used slot, 10 per job, 40 per node."""
    jstate, t, start_t, place, req, up, outlet, wb = st[:8]
    E, J = jstate.shape
    N = ts.idle_w.shape[0]
    thermal = ts.consts.thermal
    in_bytes = 4 * (E * (2 * J + 1 + 2 * J + N + 1 + 2 * J + len(st[8:]))
                    + place.numel() + 7 * N
                    + (E * outlet.shape[1] + N if thermal else 0))
    out_bytes = 4 * E * (2 * N + 8 + (J if thermal else 0))
    ops = 6 * int((place >= 0).sum()) + E * (10 * J + 40 * N)
    return bound(in_bytes, out_bytes, ops)


def rack_tick_inputs(torch, np, cfg, n_rep: int, seed: int,
                     rack_down=False):
    """Seeded inputs of the thermal tail: post-throttle node input power
    (with ``rack_down``, 0 W on rack 0 and ~5% of the other nodes, which
    are down), the cap's scale, a wetbulb, outlet temperatures across the
    throttle ramp and a running peak."""
    rng = np.random.default_rng(seed)
    N, R = cfg.n_nodes, cfg.n_racks

    def t(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device="cuda")

    heat = rng.uniform(150.0, 1400.0, (n_rep, N))
    if rack_down:
        heat = heat * down_nodes(np, cfg, rng, n_rep)
    return [t(heat),
            t(rng.uniform(0.6, 1.0, n_rep)), t(rng.uniform(8, 26, n_rep)),
            t(rng.uniform(cfg.throttle_start_c - 10, cfg.throttle_full_c + 5,
                          (n_rep, R))),
            t(rng.uniform(20, 40, n_rep))]


def check_tick_kernel(torch, name, launch, plain, cpu_statics, gpu_statics,
                      args, bound_ms, bound_by, bitwise,
                      plain_timing=(TIMING_REPS, TIMING_BATCH),
                      **shape) -> dict:
    """A fused tick entry against its plain version on the card (rtol) and
    on the CPU: the outputs at positions ``bitwise`` (the per-node and
    per-rack values) must have the CPU's bits; timed beside the plain
    version (``plain_timing``: timed batches, calls per batch) and the
    bound."""
    got = [g for g in launch(gpu_statics, *args)]
    again = [g for g in launch(gpu_statics, *args)]
    cpu = plain(cpu_statics, *(a.cpu() for a in args))
    torch.cuda.synchronize()
    if not all(g is None or torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name}: two calls differ")
    same_bits = all(torch.equal(got[i].cpu(), cpu[i]) for i in bitwise
                    if got[i] is not None)
    keep = [i for i, g in enumerate(got) if g is not None]
    rec = check_kernel(
        torch, name, [got[i] for i in keep],
        [w for w in plain(gpu_statics, *args) if w is not None],
        lambda: launch(gpu_statics, *args), lambda: plain(gpu_statics, *args),
        bound_ms, bound_by, plain_timing=plain_timing, **shape,
        bitwise_vs_cpu=same_bits)
    if not same_bits:
        raise AssertionError(f"{name}: per-node or per-rack values differ "
                             "from the CPU plain version's bits")
    return rec


def node_power_inputs(torch, np, statics, n_rep: int, seed: int):
    """Seeded (E, N) load fractions and ~5% nodes down, with the TX-GAIA
    node constants."""
    rng = np.random.default_rng(seed)
    n = statics.idle_w.shape[0]
    dev = statics.idle_w.device

    def t(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device=dev)

    return (t(rng.random((n_rep, n))), t(rng.random((n_rep, n))),
            statics.idle_w, statics.cpu_dyn_w, statics.gpu_dyn_w,
            t(rng.random((n_rep, n)) > 0.05), statics.node_max_w)


def check_kernel(torch, name, got, want, fn, plain, bound_ms, bound_by,
                 plain_timing=(TIMING_REPS, TIMING_BATCH), **shape):
    """Hold a kernel's outputs to its plain version's (rtol), time both
    (the plain version over ``plain_timing``: timed batches, calls per
    batch), emit the phase line and return the record."""
    torch.cuda.synchronize()
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                  for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=KERNEL_RTOL, atol=0.0,
                                   msg=lambda m, i=i: f"{name}[{i}]: {m}")
    rec = dict(max_abs_err=abs_err, ms=time_ms(torch, fn),
               plain_ms=time_ms(torch, plain, *plain_timing),
               bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel", name=name, **shape, max_rel_err=rel_err,
         rtol=KERNEL_RTOL, **rec)
    return rec


def attention_pairs(np, sq: int, sk: int, causal: bool, window: int) -> int:
    """Query-key pairs the masks leave live (queries end where the keys
    end), per (batch, head)."""
    q_pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(q_pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_attention(torch, np, name, dtype, b, s, h, kv, hd, causal, window,
                    tol) -> dict:
    """flash_attn against ``attention_torch`` on the card at one shape:
    within ``tol`` (atol = rtol), two calls bitwise equal; timed beside
    the plain version, the bound and ``scaled_dot_product_attention``."""
    from repro_torch.kernels import flash_attn as pfa

    rng = np.random.default_rng(hd + h)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device="cuda").to(dt)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    got = pfa.flash_attention(q, k, v, causal=causal, window=window)
    again = pfa.flash_attention(q, k, v, causal=causal, window=window)
    want = pfa.attention_torch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attn {name}: two calls differ")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"flash_attn {name}: {m}")
    abs_err = float((got.float() - want.float()).abs().max())

    # yardstick: one PyTorch call of the same function (never used by the
    # port), on (B, H, S, hd) views of the same tensors
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window > 0:
        pos = torch.arange(s, device="cuda")
        dist = pos[:, None] - pos[None, :]
        mask = (dist >= 0) & (dist < window)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None and causal,
            enable_gqa=True)

    try:
        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        library_ms = time_ms(torch, library, *ATTN_TIMING)
    except RuntimeError as exc:   # no backend for this shape
        lib_err, library_ms = repr(exc), None

    elem = q.element_size()
    in_out = elem * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    flops = 4 * b * h * hd * attention_pairs(np, s, s, causal, window)
    peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = in_out / HBM_BYTES_PER_S, flops / peak
    rec = dict(max_abs_err=abs_err,
               ms=time_ms(torch, lambda: pfa.flash_attention(
                   q, k, v, causal=causal, window=window), *ATTN_TIMING),
               plain_ms=time_ms(torch, lambda: pfa.attention_torch(
                   q, k, v, causal=causal, window=window), *ATTN_TIMING),
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=library_ms)
    emit("kernel", name="flash_attn", case=name, dtype=dtype, batch=b, seq=s,
         heads=h, kv_heads=kv, head_dim=hd, causal=causal, window=window,
         tol=tol, gflop=flops / 1e9, library_max_abs_err=lib_err, **rec)
    return rec


def check_scan(torch, np, name, ba, s, di, ds) -> dict:
    """selective_scan (the TPU kernel's signature) against
    ``selective_scan_torch`` on the card at one shape: within ``SCAN_TOL``
    (atol = rtol), two calls bitwise equal; timed beside the plain version
    and the bound. No single PyTorch call computes a selective scan, so
    there is no library time."""
    from repro_torch.kernels import selective_scan as pss

    rng = np.random.default_rng(s + ds)
    arrays = (rng.normal(size=(ba, s, di)).astype(np.float32),
              rng.uniform(1e-3, 0.1, (ba, s, di)).astype(np.float32),
              -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                               (di, ds)).copy(),
              rng.normal(size=(ba, s, ds)).astype(np.float32),
              rng.normal(size=(ba, s, ds)).astype(np.float32))
    a = tuple(torch.tensor(x, device="cuda") for x in arrays)
    got = pss.selective_scan(*a)
    again = pss.selective_scan(*a)
    want = pss.selective_scan_torch(*a)
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, again)):
        raise AssertionError(f"selective_scan {name}: two calls differ")
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                  for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(
            g, w, rtol=SCAN_TOL, atol=SCAN_TOL,
            msg=lambda m, i=i: f"selective_scan {name}[{i}]: {m}")
    steps = ba * s * di * ds
    t_bytes = (nbytes(a) + nbytes(got)) / HBM_BYTES_PER_S
    t_ops = max(steps / SFU_EXP_PER_S, SCAN_F32_OPS * steps / F32_FLOPS)
    rec = dict(max_abs_err=abs_err,
               ms=time_ms(torch, lambda: pss.selective_scan(*a),
                          *SCAN_TIMING),
               plain_ms=time_ms(torch, lambda: pss.selective_scan_torch(*a),
                                *SCAN_PLAIN_TIMING),
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None)
    emit("kernel", name="selective_scan", case=name, batch=ba, seq=s,
         d_inner=di, d_state=ds, tol=SCAN_TOL, max_rel_err=rel_err,
         bytes_ms=1e3 * t_bytes, exp_ms=1e3 * steps / SFU_EXP_PER_S,
         **rec)
    return rec


def check_mamba_scan(torch, np, name, dtype, ba, s, di, ds) -> dict:
    """The fused entry ``mamba_scan`` against ``mamba_scan_torch`` on the
    card at one shape, its inputs laid out as the mixer passes them (z the
    second half of in_proj's output, Bc and Cc slices of x_proj's): the
    output in f32 within ``SCAN_TOL``, in bf16 within ``MAMBA_BF16_TOL``
    (atol = rtol), the share of outputs that differ at all reported; the
    final state, f32 in both, within ``SCAN_TOL``; two calls bitwise equal;
    timed beside the plain version and the bound (each tensor read or
    written once; the decays and the prologue's transcendentals at the
    SFUs' rate, the other f32 operations at the f32 peak)."""
    from repro_torch.kernels import selective_scan as pss

    rng = np.random.default_rng(s + ds + 1)
    dt = getattr(torch, dtype)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device="cuda").to(dt)

    dt_proj = rng.normal(0.0, 0.5, (ba, s, di)).astype(np.float32)
    xz = t(rng.standard_normal((ba, s, 2 * di), np.float32))
    proj = t(rng.standard_normal((ba, s, MAMBA_DT_RANK + 2 * ds), np.float32))
    A = torch.tensor(-np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                                      (di, ds)).copy(), device="cuda")
    a = (t(rng.standard_normal((ba, s, di), np.float32)), t(dt_proj),
         t(rng.uniform(-6.9, -2.3, di)), A,
         proj[..., MAMBA_DT_RANK:MAMBA_DT_RANK + ds],
         proj[..., MAMBA_DT_RANK + ds:], xz[..., di:],
         t(rng.standard_normal(di, np.float32)))
    del dt_proj
    got = pss.mamba_scan(*a)
    again = pss.mamba_scan(*a)
    want = pss.mamba_scan_torch(*a)
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, again)):
        raise AssertionError(f"mamba_scan {name} ({dtype}): two calls differ")
    tol = SCAN_TOL if dtype == "float32" else MAMBA_BF16_TOL
    out_err, state_err = (float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
    differ = float((got[0] != want[0]).float().mean())
    for i, (g, w, tl) in enumerate(zip(got, want, (tol, SCAN_TOL))):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=tl, atol=tl,
            msg=lambda m, i=i: f"mamba_scan {name} ({dtype})[{i}]: {m}")
    steps = ba * s * di * ds
    elems = ba * s * di
    t_bytes = (nbytes(a) + nbytes(got)) / HBM_BYTES_PER_S
    t_sfu = (steps + MAMBA_SFU_PER_ELEM * elems) / SFU_EXP_PER_S
    t_ops = max(t_sfu, SCAN_F32_OPS * steps / F32_FLOPS)
    rec = dict(max_abs_err=max(out_err, state_err),
               ms=time_ms(torch, lambda: pss.mamba_scan(*a), *SCAN_TIMING),
               plain_ms=time_ms(torch, lambda: pss.mamba_scan_torch(*a),
                                *SCAN_PLAIN_TIMING),
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None)
    emit("kernel", name="selective_scan", entry="mamba_scan", case=name,
         dtype=dtype, batch=ba, seq=s, d_inner=di, d_state=ds, tol=tol,
         state_tol=SCAN_TOL, out_err=out_err, state_err=state_err,
         differing_share=differ, bytes_ms=1e3 * t_bytes,
         sfu_ms=1e3 * t_sfu, **rec)
    return rec


def _counted(torch, fn):
    """``fn()``, synchronised, and the kernel launches it made."""
    from repro_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


def serve_hybrid(torch, np) -> int:
    """The jamba hybrid without experts at full width on the card:
    ``serve_jamba_1l`` in f32 against ``PINNED_JAMBA``; ``serve_jamba_8l``
    in f32 and bf16 (the prefill/decode invariant and the launch counts),
    then timed ``generate`` runs in bf16 under sync-debug "error". Returns
    the selective_scan launches of one 8-layer prefill."""
    from repro_torch.configs import acceptance as A
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import DecoderLM, init_params, seeded_numpy_params
    from repro_torch.models.model import decode_step, prefill

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1. serve_jamba_1l: one Mamba layer in f32 against the JAX package
    t0 = time.perf_counter()
    cfg = A.jamba_config(1, "float32")
    tree = seeded_numpy_params(cfg, A.JAMBA_SEED)
    weights_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = lm_params_from_numpy(tree, cfg, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del tree
    S, N = A.JAMBA_PROMPT, A.JAMBA_DECODE
    toks = torch.tensor(A.lm_tokens(cfg, A.JAMBA_BATCH, S, N), device="cuda")
    (logits, cache), per_prefill = _counted(
        torch, lambda: prefill(model, toks[:, :S], cache_seq_len=S + N))
    out = [logits]

    def decode_all(cache):
        for i in range(N):
            logits, cache = decode_step(model, cache,
                                        toks[:, S + i:S + i + 1], S + i)
            out.append(logits)

    _, per_decode = _counted(torch, lambda: decode_all(cache))
    report = A.check_lm(A.lm_summary([x.cpu().numpy() for x in out]),
                        "float32", pins=A.PINNED_JAMBA, case=A.JAMBA_CASE)
    emit("serve_hybrid", step="pins", case=A.JAMBA_CASE,
         params=cfg.param_count(), weights_s=weights_s, load_s=load_s,
         launches_per_prefill=per_prefill, launches_in_decode=per_decode,
         **report)
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise AssertionError(f"{A.JAMBA_CASE}: non-finite logits")
    if (per_prefill["selective_scan"], per_prefill["flash_attn"]) != (1, 0) \
            or per_decode["selective_scan"] or per_decode["flash_attn"]:
        raise AssertionError(f"{A.JAMBA_CASE}: launches {per_prefill} per "
                             f"prefill, {per_decode} in {N} decode steps")
    del model, cache, out, logits
    torch.cuda.empty_cache()

    # 2. serve_jamba_8l: one whole 7:1 period, f32 masters made on the card
    n_layers = A.JAMBA_PATH_LAYERS
    cfg = A.jamba_config(n_layers, "float32")
    n_mamba = sum(k == "mamba" for k in cfg.layer_kinds())
    t0 = time.perf_counter()
    tree = init_params(cfg, torch.Generator("cuda").manual_seed(A.JAMBA_SEED))
    torch.cuda.synchronize()
    emit("serve_hybrid", step="weights", case=A.JAMBA_PATH_CASE,
         params=cfg.param_count(), seconds=time.perf_counter() - t0)
    prompt = torch.tensor(
        np.random.default_rng(2).integers(0, cfg.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT + 1),
                                          dtype=np.int32), device="cuda")
    per_prefill = None
    truth = None     # the f32 model's logits of the longer prefill
    for dtype in ("float32", "bfloat16"):
        model = DecoderLM.from_tree(A.jamba_config(n_layers, dtype), tree)
        S = SERVE_PROMPT
        t0 = time.perf_counter()
        want, _ = prefill(model, prompt, cache_seq_len=S + 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        (_, cache), per_prefill = _counted(
            torch, lambda: prefill(model, prompt[:, :S], cache_seq_len=S + 1))
        (got, _), per_decode = _counted(
            torch, lambda: decode_step(model, cache, prompt[:, S:S + 1], S))
        err = float((got - want).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if dtype == "float32":
            truth = want
            limit = dict(tol=HYBRID_TOL)
        else:
            # the bf16 decode step against the f32 answer, beside the bf16
            # prefill's own distance from it
            prefill_off = float((want - truth).abs().max())
            limit = dict(
                decode_vs_f32_max_abs=float((got - truth).abs().max()),
                prefill_vs_f32_max_abs=prefill_off,
                limit=BF16_DECODE_FACTOR * prefill_off,
                below_serve_tol=err <= SERVE_TOL, serve_tol=SERVE_TOL)
        emit("serve_hybrid", step="prefill_decode_invariant",
             case=A.JAMBA_PATH_CASE, dtype=dtype, batch=SERVE_BATCH,
             prompt=S, max_abs_err=err, **limit, argmax_agree_share=agree,
             prefill_s=prefill_s, launches_per_prefill=per_prefill,
             launches_per_decode_step=per_decode)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{A.JAMBA_PATH_CASE} ({dtype}): "
                                 "non-finite logits")
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=HYBRID_TOL,
                                       rtol=HYBRID_TOL)
        elif not limit["decode_vs_f32_max_abs"] <= limit["limit"]:
            raise AssertionError(
                f"{A.JAMBA_PATH_CASE} (bf16): the decode step is "
                f"{limit['decode_vs_f32_max_abs']} off the f32 answer, over "
                f"{BF16_DECODE_FACTOR} x the bf16 prefill's {prefill_off}")
        if (per_prefill["selective_scan"], per_prefill["flash_attn"]) != (
                n_mamba, n_layers - n_mamba) \
                or per_decode["selective_scan"] or per_decode["flash_attn"]:
            raise AssertionError(
                f"{A.JAMBA_PATH_CASE} ({dtype}): launches {per_prefill} per "
                f"prefill and {per_decode} per decode step (expected "
                f"{n_mamba} selective_scan, {n_layers - n_mamba} flash_attn "
                "and none)")
        if dtype == "float32":
            del model, cache, got
            torch.cuda.empty_cache()
    del tree

    # generate in bf16 at B = 4, prompt 1024, 32 new tokens, no host sync
    time_generate(torch, np, model, prompt[:, :SERVE_PROMPT].contiguous(),
                  "serve_hybrid", case=A.JAMBA_PATH_CASE)
    del model
    torch.cuda.empty_cache()
    return per_prefill["selective_scan"]


def serve(torch, np) -> int:
    """gemma3-1b at full width and depth on the card: the f32 and bf16
    models held to the pins, the launch counts, the bf16 prefill/decode
    invariant, and timed ``generate`` runs under sync-debug "error".
    Returns the flash_attn launches of one prefill."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import seeded_numpy_params
    from repro_torch.models.model import decode_step, prefill

    t0 = time.perf_counter()
    cfg = A.lm_config("float32")
    tree = seeded_numpy_params(cfg, A.LM_SEED)
    toks = torch.tensor(A.lm_tokens(cfg), device="cuda")
    emit("serve", step="weights", params=cfg.param_count(),
         seconds=time.perf_counter() - t0)
    S, N = A.LM_PROMPT, A.LM_DECODE
    per_prefill = None
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        model = lm_params_from_numpy(tree, A.lm_config(dtype), "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        kernels.reset_launches()
        logits, cache = prefill(model, toks[:, :S], cache_seq_len=S + N)
        torch.cuda.synchronize()
        prefill_launches = kernels.LAUNCHES["flash_attn"]
        out = [logits]
        kernels.reset_launches()
        for i in range(N):
            logits, cache = decode_step(model, cache,
                                        toks[:, S + i:S + i + 1], S + i)
            out.append(logits)
        torch.cuda.synchronize()
        decode_launches = kernels.LAUNCHES["flash_attn"]
        finite = all(bool(torch.isfinite(x).all()) for x in out)
        report = A.check_lm(A.lm_summary([x.cpu().numpy() for x in out]),
                            dtype)
        emit("serve", step="pins", case=A.LM_CASE, load_s=load_s, flash_attn_per_prefill=prefill_launches,
             flash_attn_per_decode_step=decode_launches / N, **report)
        if not finite:
            raise AssertionError(f"{A.LM_CASE} ({dtype}): non-finite logits")
        if prefill_launches != cfg.n_layers or decode_launches != 0:
            raise AssertionError(
                f"{A.LM_CASE} ({dtype}): flash_attn launched "
                f"{prefill_launches} times in a prefill and {decode_launches} "
                f"in {N} decode steps (expected {cfg.n_layers} and 0)")
        per_prefill = prefill_launches
        if dtype == "float32":
            del model, cache, out
            torch.cuda.empty_cache()
    del tree

    # bf16: prefill S then decode token S against a prefill of S + 1
    want, _ = prefill(model, toks[:, :S + 1], cache_seq_len=S + 1)
    _, cache = prefill(model, toks[:, :S], cache_seq_len=S + 1)
    got, _ = decode_step(model, cache, toks[:, S:S + 1], S)
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    emit("serve", step="prefill_decode_invariant", dtype="bfloat16",
         max_abs_err=err, tol=SERVE_TOL, argmax_agree_share=agree)
    torch.testing.assert_close(got, want, atol=SERVE_TOL, rtol=SERVE_TOL)

    # generate at B = 4, prompt 1024, 32 new tokens, no host sync
    prompt = torch.tensor(
        np.random.default_rng(2).integers(0, cfg.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT),
                                          dtype=np.int32), device="cuda")
    time_generate(torch, np, model, prompt, "serve")
    return per_prefill


def time_generate(torch, np, model, prompt, phase: str, **labels) -> None:
    """``generate`` of SERVE_GEN tokens after ``prompt`` (bf16), SERVE_RUNS
    timed runs after a warm-up, each under sync-debug "error": prefill ms
    and decode ms per token (CUDA events inside ``generate``), tokens/s
    (host clock around a synchronised run), median and p10-p90."""
    from repro_torch.train.serve_step import generate

    walls, prefill_ms, decode_ms = [], [], []
    for run in range(SERVE_RUNS + 1):     # the first run warms up
        events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        toks_out = generate(model, prompt, SERVE_GEN, events=events)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if run == 0:
            continue
        walls.append(time.perf_counter() - t0)
        prefill_ms.append(events[0].elapsed_time(events[1]))
        decode_ms.append(events[1].elapsed_time(events[2]) / (SERVE_GEN - 1))
    batch = prompt.shape[0]
    if toks_out.shape != (batch, SERVE_GEN) or not bool(
            ((toks_out >= 0) & (toks_out < model.cfg.vocab)).all()):
        raise AssertionError(f"generate gave {tuple(toks_out.shape)} tokens "
                             "out of range")
    tok_s = batch * SERVE_GEN / np.asarray(walls)
    q = lambda a: [float(v) for v in np.percentile(np.asarray(a),
                                                   [50, 10, 90])]
    emit(phase, step="generate", **labels, dtype="bfloat16", batch=batch,
         prompt=prompt.shape[1], new_tokens=SERVE_GEN, runs=SERVE_RUNS,
         prefill_ms_median_p10_p90=q(prefill_ms),
         decode_ms_per_token_median_p10_p90=q(decode_ms),
         tokens_per_s_median_p10_p90=q(tok_s),
         wall_s_median=float(np.median(walls)),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         sample=toks_out[0, :8].tolist())


def flash_attn_bf16_build(build) -> dict:
    """The bf16 flash_attn kernels run on the tensor cores: ``HGMMA`` (the
    SASS of wgmma) in the library's code, and ptxas reports no spill for
    any of the bf16 instantiations (one per head dim)."""
    from repro_torch.kernels.flash_attn import HEAD_DIMS

    spills, head_dim = {}, None
    for ln in build.build_log("flash_attn").splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"flash_attn_bf16_kernelILi(\d+)E", ln)
            head_dim = int(found.group(1)) if found else None
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
        if found and head_dim is not None:
            spills[head_dim] = int(found.group(1)) + int(found.group(2))
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("flash_attn"))],
        check=True, capture_output=True, text=True, timeout=300).stdout
    hgmma = sass.count("HGMMA")
    if sorted(spills) != sorted(HEAD_DIMS) or any(spills.values()):
        raise AssertionError(f"flash_attn bf16: ptxas spill bytes by head "
                             f"dim {spills} (expected 0 for {HEAD_DIMS})")
    if hgmma == 0:
        raise AssertionError("flash_attn bf16: no HGMMA in the library's SASS")
    return {"hgmma_in_sass": hgmma, "spill_bytes_by_head_dim": spills}


def drive(torch, case: str, cfg, statics, jobs, phase: str):
    """One hour of ``case`` on the card, the ticks under sync-debug
    "error": held to the pinned values, one power_scatter launch per tick
    and, with the thermal twin on, one rack_thermal launch per tick.
    Returns (launches, final state, telemetry, wall seconds)."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance
    from repro_torch.core import init_state, load_jobs, run_episode, summary

    t0 = time.perf_counter()
    state = load_jobs(init_state(cfg, statics, seed=acceptance.SEED), jobs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    final, telem = run_episode(cfg, statics, state, acceptance.N_STEPS,
                               acceptance.SCHEDULER, summary_only=True)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got = summary(final, telem)
    pins = (acceptance.PINNED_FAULTS if case in acceptance.PINNED_FAULTS
            else acceptance.PINNED)[case]
    emit(phase, case=case, ticks=acceptance.N_STEPS, setup_s=setup_s,
         wall_s=wall_s, ms_per_tick=1e3 * wall_s / acceptance.N_STEPS,
         launches=launches, **{k: got[k] for k in pins}, pinned=pins)
    acceptance.check(case, got)
    want = {"power_scatter": acceptance.N_STEPS, "node_power": 0,
            "rack_thermal": acceptance.N_STEPS if cfg.thermal_enabled else 0,
            "flash_attn": 0, "selective_scan": 0}
    if launches != want:
        raise AssertionError(f"{case}: launches {launches}, expected {want}")
    for name, v in final._asdict().items():
        # the fault and serving clocks stay at +inf while those models are off
        ok = (~torch.isnan(v) if name in INF_CLOCKS else torch.isfinite(v))
        if v.is_floating_point() and not bool(ok.all()):
            raise AssertionError(f"{case}: final state field {name}: "
                                 "bad values")
    return launches, final, telem, wall_s


def _alone_vs_fleet(torch, name, alone, fleet_state, e, telem=None,
                    fleet_telem=None) -> dict:
    """Replica ``e`` of a fleet's final state against the same replica run
    alone: integer fields (and the key words) equal, floats within
    KERNEL_RTOL (job progress as work done, ``dur_est - work_left``; the
    fault and serving clocks may be +inf on both sides). Raises on a
    miss, naming the jobs whose state or end time differ and their end
    times (the ticks they completed) and work left on both sides."""
    pairs = [(f, getattr(alone, f), getattr(fleet_state, f)[e])
             for f in alone._fields]
    if telem is not None:
        pairs += [(f"telemetry.{f}", getattr(telem, f),
                   getattr(fleet_telem, f)[e]) for f in telem._fields]
    worst, bitwise = 0.0, True
    for f, a, b in pairs:
        bitwise = bitwise and torch.equal(a, b)
        if f == "work_left":
            a, b = alone.dur_est - a, fleet_state.dur_est[e] - b
        if not a.is_floating_point():
            if not torch.equal(a, b):
                jobs = torch.nonzero(
                    (alone.jstate != fleet_state.jstate[e])
                    | (alone.end_t != fleet_state.end_t[e])).flatten()
                raise AssertionError(
                    f"{name}: replica {e} alone differs from the fleet's in "
                    f"{f}; jobs {jobs.tolist()}: end_t alone "
                    f"{alone.end_t[jobs].tolist()} / fleet "
                    f"{fleet_state.end_t[e][jobs].tolist()}, work_left "
                    f"{alone.work_left[jobs].tolist()} / "
                    f"{fleet_state.work_left[e][jobs].tolist()}")
            continue
        fin = torch.isfinite(a)
        if not torch.equal(fin, torch.isfinite(b)) or not torch.equal(
                a[~fin], b[~fin]):
            raise AssertionError(f"{name}: replica {e}: {f} non-finite apart")
        rel = ((a - b).abs() / b.abs().clamp(min=1e-30))[fin]
        err = float(rel.max()) if rel.numel() else 0.0
        worst = max(worst, err)
        if err > KERNEL_RTOL:
            raise AssertionError(f"{name}: replica {e}: {f} off by rel "
                                 f"{err} (> {KERNEL_RTOL})")
    return {"replica": e, "max_rel_err": worst, "bitwise": bitwise}


def run_alone(torch, runs: list, during=None):
    """Each of ``runs`` (``run_episode``'s arguments: a dict of ``cfg``,
    ``statics``, ``state``, ``n_steps``, ``scheduler`` and ``kw``, and
    optionally ``entry="run_fleet"`` to call that instead) in a
    worker process of its own on the card (``chip_smoke.py --alone``),
    ALONE_WORKERS at a time: a replica rerun alone shares nothing with the
    fleet it is compared with, not even the process. Returns each run's
    (final state, telemetry) on the card; a worker that fails or outlives
    ALONE_TIMEOUT_S fails the phase, and every worker is stopped first.
    With ``during``, the parent calls it once the first workers have
    started and returns (the runs' results, what it returned)."""
    import subprocess

    work = ROOT / "build" / "alone"
    work.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, run in enumerate(runs):
        src, out, log = (work / f"run{i}.pt", work / f"out{i}.pt",
                         work / f"log{i}.txt")
        out.unlink(missing_ok=True)
        torch.save(run, src)
        paths.append((src, out, log))
    pending = list(range(len(runs)))
    live = {}
    given, meanwhile = during is not None, None
    try:
        while pending or live:
            while pending and len(live) < ALONE_WORKERS:
                i = pending.pop(0)
                src, out, log = paths[i]
                with open(log, "w") as f:
                    live[i] = (subprocess.Popen(
                        [sys.executable, str(ROOT / "chip_smoke.py"),
                         "--alone", str(src), str(out)],
                        stdout=f, stderr=subprocess.STDOUT),
                        time.perf_counter())
            if during is not None:
                meanwhile, during = during(), None
            for i, (proc, t0) in list(live.items()):
                if proc.poll() is None:
                    if time.perf_counter() - t0 > ALONE_TIMEOUT_S:
                        raise AssertionError(f"alone run {i}: over "
                                             f"{ALONE_TIMEOUT_S} s")
                    continue
                del live[i]
                if proc.returncode != 0:
                    raise AssertionError(f"alone run {i} failed:\n"
                                         f"{paths[i][2].read_text()}")
            time.sleep(0.2)
    finally:
        for proc, _ in live.values():
            proc.kill()
            proc.wait()
    results = [torch.load(out, map_location="cuda", weights_only=False)
               for _, out, _ in paths]
    return (results, meanwhile) if given else results


def alone_main(src: str, out: str) -> int:
    """Worker of ``run_alone``: one ``run_episode`` on the card (or the
    run's ``entry``: ``run_fleet``)."""
    import torch

    from repro_torch.core import run_episode, run_fleet
    from repro_torch.utils.device import exact_matmul

    exact_matmul()
    run = torch.load(src, map_location="cuda", weights_only=False)
    entry = {"run_episode": run_episode,
             "run_fleet": run_fleet}[run.get("entry", "run_episode")]
    final, telem = entry(run["cfg"], run["statics"], run["state"],
                         run["n_steps"], run["scheduler"], **run["kw"])
    torch.cuda.synchronize()
    torch.save((final, telem), out)
    return 0


def _run_fleet_timed(torch, run_fleet, cfg, statics, state, ticks, pol, scn):
    """``run_fleet`` (summary_only) under sync-debug "error", timed on the
    host clock around a synchronised run; the port's launches counted
    from 0. Returns (final, telemetry, wall seconds, launches)."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    final, telem = run_fleet(cfg, statics, state, ticks, policies=pol,
                             scenarios=scn, summary_only=True)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return final, telem, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def _profile_fleet(torch, replicas: int) -> dict:
    """CUDA kernels, device us and the device's busy share per tick of
    ``replay_tx_gaia_1h`` as a fleet of ``replicas`` (the grid tiled;
    ``profile_tick.setup_case``), over FLEET_PROFILE ticks after tick
    FLEET_PROFILE_START."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.tools.profile_tick import (
        _advance,
        device_summary,
        setup_case,
    )

    start, ticks = FLEET_PROFILE
    step, state, action = setup_case("replay_tx_gaia_1h", start,
                                     replicas=replicas)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _advance(step, state, action, ticks)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    summ = device_summary(prof, wall_us, ticks, top=6)
    return {k: summ[k] for k in ("cuda_kernels", "device_us",
                                 "device_busy_share", "port_kernel_us",
                                 "top_kernels_us")}


def fleet(torch, np, jobs, bank) -> dict:
    """The fleet case (``acceptance.fleet_grid``: 8 policies x 9 scenarios,
    72 replicas of ``replay_tx_gaia_1h``) for the hour in one batched run
    under sync-debug "error": every replica at ``PINNED_FLEET``, replica 0
    at ``replay_tx_gaia_1h``'s pins, one power_scatter launch a tick;
    FLEET_ALONE rerun alone through ``run_episode`` (in worker processes,
    ``run_alone``); the thermal hour's
    config for FLEET_THERMAL_TICKS at E = 72 (one rack_thermal launch a
    tick) with FLEET_THERMAL_ALONE rerun alone; then ms per tick, us per
    replica-tick, CUDA kernels per tick and the device's busy share at
    E = 1, 72 and 1152 (the grid tiled 16x). Returns the hour's launches
    and wall seconds."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import (
        build_statics,
        init_state,
        load_jobs,
        summary,
        summary_columns,
    )
    from repro_torch.core.fleet import _scenario_list, run_fleet
    from repro_torch.utils.device import tree_to

    runs = {}
    alone, checks = [], []
    for case, ticks, alone_ids in (
            ("replay_tx_gaia_1h", A.N_STEPS, A.FLEET_ALONE),
            ("replay_tx_gaia_1h_thermal", A.FLEET_THERMAL_TICKS,
             A.FLEET_THERMAL_ALONE)):
        cfg = A.config(case)
        statics = build_statics(cfg, bank)
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        names, pol, scn = A.fleet_grid(cfg)
        n_rep = len(names)
        final, telem, wall, launches = _run_fleet_timed(
            torch, run_fleet, cfg, statics, state, ticks, pol, scn)
        cols = summary_columns(final, telem)
        want = no_launches(power_scatter=ticks, rack_thermal=(
            ticks if cfg.thermal_enabled else 0))
        rec = dict(case=case, replicas=n_rep, ticks=ticks, wall_s=wall,
                   ms_per_tick=1e3 * wall / ticks,
                   us_per_replica_tick=1e6 * wall / ticks / n_rep,
                   launches=launches,
                   completed=cols["completed"].tolist())
        for name, v in final._asdict().items():
            ok = (~torch.isnan(v) if name in INF_CLOCKS
                  else torch.isfinite(v))
            if v.is_floating_point() and not bool(ok.all()):
                raise AssertionError(f"fleet {case}: {name}: bad values")
        if ticks == A.N_STEPS:
            rec["pins"] = A.check_fleet(cols)
            A.check("replay_tx_gaia_1h", summary(
                type(final)(*(v[0] for v in final)),
                type(telem)(*(v[0] for v in telem))))
            rec["replica0_pinned"] = True
            rec["demand_response_mean_throttle"] = telem.mean_throttle[
                8::9].tolist()
        emit("fleet", step="grid", **rec)
        if launches != want:
            raise AssertionError(f"fleet {case}: launches {launches}, "
                                 f"expected {want}")
        scns = _scenario_list(scn)
        n_scn = n_rep // (len(A.FLEET_SELECTS) * len(A.FLEET_PLACES))
        for e in alone_ids:
            sel, place = names[e].split("+")
            st = statics._replace(scenario=tree_to(scns[e], statics.idle_w.device))
            alone.append(dict(cfg=cfg, statics=st, state=state._replace(
                key=final.key[e]), n_steps=ticks, scheduler=sel,
                kw=dict(placement=place, summary_only=True)))
            checks.append((case, names[e], e % n_scn, e, final, telem))
        runs[case] = launches, wall
    t0 = time.perf_counter()
    for (f1, t1), (case, name, scn_id, e, final, telem) in zip(
            run_alone(torch, alone), checks):
        emit("fleet", step="alone", case=case, policy=name,
             scenario=scn_id, **_alone_vs_fleet(
                 torch, f"fleet {case}", f1, final, e, t1, telem))
    emit("fleet", step="alone runs", runs=len(alone),
         workers=ALONE_WORKERS, wall_s=time.perf_counter() - t0)

    # ms per tick and us per replica-tick at E = 1, 72 and 1152, each
    # FLEET_TIMING ticks of the hour's grid (tiled), then the profile
    cfg = A.config()
    statics = build_statics(cfg, bank)
    state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
    for n_rep in FLEET_SIZES:
        _, pol, scn = A.fleet_grid(cfg, n_rep)
        _, _, wall, launches = _run_fleet_timed(
            torch, run_fleet, cfg, statics, state, FLEET_TIMING, pol, scn)
        emit("fleet", step="scale", replicas=n_rep, ticks=FLEET_TIMING,
             ms_per_tick=1e3 * wall / FLEET_TIMING,
             us_per_replica_tick=1e6 * wall / FLEET_TIMING / n_rep,
             replica_ticks_per_s=n_rep * FLEET_TIMING / wall,
             launches=launches, profile=_profile_fleet(torch, n_rep),
             profile_ticks=FLEET_PROFILE)
        if launches != no_launches(power_scatter=FLEET_TIMING):
            raise AssertionError(f"fleet at E = {n_rep}: launches {launches}")
    return runs["replay_tx_gaia_1h"]


def no_launches(**kw) -> dict:
    return {"power_scatter": 0, "rack_thermal": 0, "node_power": 0,
            "flash_attn": 0, "selective_scan": 0, **kw}


def no_sync(torch):
    """Context manager: a synchronised start, then sync-debug "error"
    (any host sync raises) until it closes."""
    import contextlib

    @contextlib.contextmanager
    def guard():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return guard


def _rl_rollout_timed(torch, env, n_envs: int, steps: int) -> dict:
    """``steps`` decisions of a PPO rollout over ``n_envs`` environments
    (a fresh policy, keys as ``ppo_train``'s) under sync-debug "error",
    timed on the host clock around a synchronised run, after one untimed
    decision at the same width (the allocator's first blocks of that
    size are not the rollout's cost)."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.rl import ActorCritic, PPOConfig
    from repro_torch.rl.ppo import make_rollout
    from repro_torch.utils import prng
    from repro_torch.utils.device import to_device

    cfg = PPOConfig(n_envs=n_envs, rollout_len=steps)
    policy = ActorCritic(env.obs_dim, env.n_actions, device=env.device)
    key = to_device(torch.from_numpy(prng.key_words(A.RL_SEED)), env.device)
    key, kp, ke = prng.split(key, 3)
    params = policy.init(kp)
    states, _ = env.reset(prng.split(ke, n_envs))
    make_rollout(env, policy, PPOConfig(n_envs=n_envs, rollout_len=1))(
        params, states, key)
    rollout = make_rollout(env, policy, cfg)
    from repro_torch.core import sim
    from repro_torch.utils import device as D

    kernels.reset_launches()
    sim.reset_macro_ticks()
    D.reset_host_reads()
    with no_sync(torch)():
        t0 = time.perf_counter()
        _, batch, _, _ = rollout(params, states, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not bool(torch.isfinite(batch.reward).all()):
        raise AssertionError(f"rl at E = {n_envs}: rewards not finite")
    launches = dict(kernels.LAUNCHES)
    ticks = steps * A.RL_SIM_STEPS
    # a macro env issues one "rl" tick a decision, then its event and
    # fast ticks; each tick is one power_tick for all environments
    issued = (steps + sim.MACRO_TICKS["event"] + sim.MACRO_TICKS["fast"]
              if env.macro else ticks)
    if launches != no_launches(power_scatter=issued):
        raise AssertionError(f"rl at E = {n_envs}: launches {launches}, "
                             f"{issued} ticks issued")
    return {"envs": n_envs, "env_steps": steps, "macro": env.macro,
            "wall_s": wall, "ms_per_env_step": 1e3 * wall / steps,
            "decisions_per_s": n_envs * steps / wall,
            "replica_ticks_per_s": n_envs * ticks / wall,
            "ticks_issued": issued,
            "host_reads_per_env_step": D.HOST_READS["count"] / steps,
            "launches": launches}


def counted_drains(torch, drains: list):
    """Context manager: ``ppo_train``'s chunk drain (its one host sync)
    runs with sync-debug "error" lifted, and appends each chunk's length
    to ``drains``."""
    import contextlib

    from repro_torch.rl import ppo as P

    @contextlib.contextmanager
    def patched():
        drain = P._drain

        def counted_drain(stats):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return drain(stats)
            finally:
                drains.append(len(stats))
                torch.cuda.set_sync_debug_mode("error")

        P._drain = counted_drain
        try:
            yield
        finally:
            P._drain = drain
    return patched()


def rl(torch, np):
    """The RL phase (see the module docstring, phase 7). Returns the
    ``rl_tx_gaia`` env and its PPO run (``run_ppo``'s record and params)."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.envs import SchedEnv
    from repro_torch.rl import ppo as P
    from repro_torch.tools.profile_tick import profile_rl, setup_rl

    start = time.perf_counter()
    guard = no_sync(torch)
    envs = {}
    # (a), (b): the scripted rollouts against PINNED_RL
    for case, steps in A.RL_SCRIPT_STEPS.items():
        cfg = A.rl_config(case)
        t0 = time.perf_counter()
        env = envs[case] = SchedEnv(cfg, A.rl_workloads(cfg),
                                    **A.rl_env_kwargs())
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = A.run_rl_script(env, case, guard=guard)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        ticks = steps * A.RL_SIM_STEPS
        report = A.check_rl(case, got)
        emit("rl", step="script", case=case, envs=A.RL_ENVS,
             env_steps=steps, ticks=ticks, setup_s=setup_s, wall_s=wall,
             launches=launches, past_queued=got["past_queued"],
             obs_dim=env.obs_dim, n_actions=env.n_actions,
             completed=got["n_completed"], at_s=time.perf_counter() - start,
             **report)
        want = no_launches(power_scatter=ticks, rack_thermal=(
            ticks if cfg.thermal_enabled else 0))
        if launches != want:
            raise AssertionError(f"{case}: launches {launches}, expected "
                                 f"{want}")

    # (c) PPO: pins, one host sync per chunk (the drain), a bitwise rerun
    env = envs["rl_tx_gaia"]
    drains = []
    runs = []
    with counted_drains(torch, drains):
        for _ in range(2):
            kernels.reset_launches()
            t0 = time.perf_counter()
            got, params = A.run_ppo(env, guard=guard)
            runs.append((got, params, time.perf_counter() - t0,
                         dict(kernels.LAUNCHES)))
    (got, params, wall, launches), (got2, params2, _, _) = runs
    report = A.check_ppo(got)
    same = (got == got2 and all(torch.equal(params[k], params2[k])
                                for k in params))
    ticks = (1 + A.RL_ITERATIONS) * A.RL_ROLLOUT * A.RL_SIM_STEPS
    emit("rl", step="ppo", iterations=A.RL_ITERATIONS, wall_s=wall,
         launches=launches, drains=drains, rerun_bitwise=same,
         history=got["history"], at_s=time.perf_counter() - start,
         **report)
    if drains != [A.RL_ITERATIONS] * 2:
        raise AssertionError(f"ppo: host drains {drains}, expected one "
                             "per chunk")
    if not same:
        raise AssertionError("ppo: the rerun differs")
    if launches != no_launches(power_scatter=ticks):
        raise AssertionError(f"ppo: launches {launches}")

    # (d) timing: the rollout at 8, 64 and 512 environments, one PPO
    # iteration split into rollout and update, and the profile
    for n_envs in RL_SCALE_ENVS:
        for repeat in range(2):      # the host clock's spread, in one call
            emit("rl", step="scale", repeat=repeat,
                 at_s=time.perf_counter() - start,
                 **_rl_rollout_timed(torch, env, n_envs, RL_SCALE_STEPS))
    env2, policy2, iteration, carry = setup_rl("rl_tx_gaia", A.RL_ENVS)
    cfg = P.PPOConfig(n_envs=A.RL_ENVS, rollout_len=A.RL_ROLLOUT)
    rollout = P.make_rollout(env2, policy2, cfg)
    update = P.make_update(policy2, cfg, P.AdamW(lr=cfg.lr, b2=0.999,
                                                 weight_decay=0.0))
    step0 = torch.zeros((), dtype=torch.int32, device="cuda")
    params, opt_state, states, ep, key = iteration(*carry, step0)[:5]
    times = []
    for _ in range(2):               # the first is a warm-up
        with guard():
            t0 = time.perf_counter()
            states, batch, last_val, ep = rollout(params, states, key, ep)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt_state, _ = update(params, opt_state, batch,
                                          last_val, key, step0)
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t1))
    rollout_s, update_s = times[-1]
    emit("rl", step="iteration", envs=A.RL_ENVS, env_steps=A.RL_ROLLOUT,
         ms_per_iteration=1e3 * (rollout_s + update_s),
         rollout_ms=1e3 * rollout_s, update_ms=1e3 * update_s,
         at_s=time.perf_counter() - start)
    emit("rl", step="profile", at_s=time.perf_counter() - start,
         **profile_rl("rl_tx_gaia", A.RL_ENVS, decisions=RL_PROFILE_STEPS))
    return env, runs[0][0], runs[0][1]

def _recorded_reads(torch, reads: list):
    """Context manager: every host read of the macro engine
    (``core.sim``'s ``host_read``) is appended to ``reads`` as (event
    ticks issued, fast ticks issued, the read's first value: after an
    event tick, the largest budget)."""
    import contextlib

    from repro_torch.core import sim

    @contextlib.contextmanager
    def patched():
        real = sim.host_read

        def recorded(x):
            out = real(x)
            reads.append((sim.MACRO_TICKS["event"], sim.MACRO_TICKS["fast"],
                          int(out[0])))
            return out

        sim.host_read = recorded
        try:
            yield
        finally:
            sim.host_read = real
    return patched()


def _read_gate(reads: list, name: str) -> dict:
    """The reads of a macro run against their bound: per macro step one
    after the event tick and one per chunk of fast ticks, so at most
    1 + ceil(segment / MACRO_CHUNK), the segment being the largest budget
    read after the event tick. Returns the counts."""
    steps = {}
    for event, _, first in reads:
        n, budget = steps.get(event, (0, first))
        steps[event] = (n + 1, budget)
    worst = max((n - 1 - math.ceil(b / MACRO_CHUNK)
                 for n, b in steps.values()), default=0)
    if worst > 0:
        raise AssertionError(f"{name}: a macro step made {worst} host "
                             "reads over 1 + ceil(segment / chunk)")
    return {"host_reads": len(reads), "macro_steps_read": len(steps),
            "host_reads_per_macro_step": len(reads) / max(len(steps), 1),
            "reads_over_bound": worst}


def _macro_counts(torch, fn, guard: bool = True, extra_reads: int = 0):
    """``fn()`` with the launches, the macro ticks and the host reads
    counted from 0, under sync-debug "error" (the engine's own reads
    excepted, and ``extra_reads`` more: a snapshotted run's drains;
    ``guard=False``: ``fn`` guards itself) and timed on the host clock
    around a synchronised run. Returns (fn's result, wall seconds,
    launches, (event, fast) ticks issued, the recorded reads)."""
    import contextlib

    from repro_torch import kernels
    from repro_torch.core import sim
    from repro_torch.utils import device as D

    reads = []
    kernels.reset_launches()
    sim.reset_macro_ticks()
    D.reset_host_reads()
    with _recorded_reads(torch, reads), (
            no_sync(torch) if guard else contextlib.nullcontext)():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if D.HOST_READS["count"] != len(reads) + extra_reads:
        raise AssertionError(f"{D.HOST_READS['count']} counted host reads, "
                             f"{len(reads)} of them the macro engine's, "
                             f"{extra_reads} more expected")
    return (out, wall, dict(kernels.LAUNCHES),
            (sim.MACRO_TICKS["event"], sim.MACRO_TICKS["fast"]), reads)


def _against_per_tick(torch, name, macro_run, per_tick_run) -> dict:
    """A macro run's final state and telemetry against the per-tick
    run's: integer fields equal (raises on a miss), the largest float
    difference of the state and of the telemetry (``macro_steps`` aside)
    reported."""
    (fm, tm), (fp, tp) = macro_run, per_tick_run
    worst = {"state": 0.0, "telemetry": 0.0}
    for part, a, b, skip in (("state", fm, fp, ()),
                             ("telemetry", tm, tp, ("macro_steps",))):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if f in skip or x is None:
                continue
            if not x.is_floating_point():
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: {part}.{f} differs from "
                                         "the per-tick run")
                continue
            fin = torch.isfinite(y)
            if not torch.equal(fin, torch.isfinite(x)) or not torch.equal(
                    x[~fin], y[~fin]):
                raise AssertionError(f"{name}: {part}.{f} non-finite apart")
            if fin.any():
                worst[part] = max(worst[part],
                                  float((x - y)[fin].abs().max()))
    return {"max_abs_diff_vs_per_tick_state": worst["state"],
            "max_abs_diff_vs_per_tick_telemetry": worst["telemetry"]}


def macro(torch, np, jobs, bank, per_tick: dict, fleet_hour) -> None:
    """The macro phase (see the module docstring, phase 8)."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import (
        build_statics,
        init_state,
        load_jobs,
        run_episode,
        summary,
        summary_columns,
    )
    from repro_torch.core.fleet import _scenario_list, run_fleet
    from repro_torch.envs import SchedEnv
    from repro_torch.tools.profile_tick import profile_rl
    from repro_torch.utils.device import tree_to

    start = time.perf_counter()
    # (a) the three replay hours
    for case in A.MACRO_CASES:
        base = A.base_case(case)
        cfg = A.config(case)
        statics = build_statics(cfg, bank)
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        (final, telem), wall, launches, (events, fast), reads = \
            _macro_counts(torch, lambda: run_episode(
                cfg, statics, state, A.N_STEPS, A.SCHEDULER, macro=True))
        got = summary(final, telem)
        _, pt_final, pt_telem, pt_wall = per_tick[base]
        committed = int(got["ticks_simulated"] - got["macro_steps_taken"])
        pins = A.PINNED_MACRO[case]
        rec = dict(
            case=case, ticks_simulated=got["ticks_simulated"],
            event_ticks=events, fast_ticks_issued=fast,
            fast_ticks_masked=fast - committed,
            ms_per_simulated_tick=1e3 * wall / A.N_STEPS,
            per_tick_ms_per_tick=1e3 * pt_wall / A.N_STEPS,
            wall_s=wall, launches=launches,
            **_read_gate(reads, case),
            **{k: got[k] for k in pins},
            reference_macro_steps_taken=pins["macro_steps_taken"],
            **_against_per_tick(torch, case, (final, telem),
                                (pt_final, pt_telem)),
            at_s=time.perf_counter() - start)
        emit("macro", step="hour", **rec)
        A.check(case, got)
        if events != got["macro_steps_taken"]:
            raise AssertionError(f"{case}: {events} event ticks issued, "
                                 f"{got['macro_steps_taken']} counted")
        want = no_launches(power_scatter=events + fast, rack_thermal=(
            events + fast if cfg.thermal_enabled else 0))
        if launches != want:
            raise AssertionError(f"{case}: launches {launches}, expected "
                                 f"{want} (one a tick issued)")

    # (b) the fleet hour: 72 replicas in lockstep
    cfg = A.config()
    statics = build_statics(cfg, bank)
    state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
    names, pol, scn = A.fleet_grid(cfg)
    (final, telem), wall, launches, (events, fast), reads = _macro_counts(
        torch, lambda: run_fleet(cfg, statics, state, A.N_STEPS,
                                 policies=pol, scenarios=scn,
                                 summary_only=True, macro=True))
    cols = summary_columns(final, telem)
    committed = int((cols["ticks_simulated"]
                     - cols["macro_steps_taken"]).sum())
    rec = dict(replicas=len(names), ticks=A.N_STEPS, wall_s=wall,
               ms_per_simulated_tick=1e3 * wall / A.N_STEPS,
               per_tick_ms_per_tick=1e3 * fleet_hour[1] / A.N_STEPS,
               outer_iterations=events, fast_ticks_issued=fast,
               fast_replica_ticks_committed=committed,
               fast_replica_ticks_masked=fast * len(names) - committed,
               launches=launches, **_read_gate(reads, A.FLEET_CASE),
               macro_steps_taken=cols["macro_steps_taken"].tolist())
    rec["pins"] = A.check_fleet(cols, pins=A.PINNED_FLEET_MACRO)
    emit("macro", step="fleet", **rec, at_s=time.perf_counter() - start)
    if launches != no_launches(power_scatter=events + fast):
        raise AssertionError(f"macro fleet: launches {launches}")
    scns = _scenario_list(scn)
    alone = [dict(cfg=cfg, statics=statics._replace(scenario=tree_to(
        scns[e], statics.idle_w.device)), state=state._replace(
        key=final.key[e]), n_steps=A.N_STEPS,
        scheduler=names[e].split("+")[0],
        kw=dict(placement=names[e].split("+")[1], macro=True))
        for e in MACRO_FLEET_ALONE]

    # (c) the RL env at macro=True: the script and one PPO iteration at
    # the pins (while the replicas above rerun alone), then timings
    def rl_pins():
        cfg = A.rl_config("rl_tx_gaia")
        env = SchedEnv(cfg, A.rl_workloads(cfg),
                       **A.rl_env_kwargs(macro=True))
        guard = no_sync(torch)
        steps = A.RL_SCRIPT_STEPS["rl_tx_gaia"]
        got, wall, launches, (events, fast), reads = _macro_counts(
            torch, lambda: A.run_rl_script(env, "rl_tx_gaia", guard=guard),
            guard=False)
        report = A.check_rl("rl_tx_gaia", got, pins=A.PINNED_RL_MACRO[
            "rl_tx_gaia"])
        emit("macro", step="rl_script", envs=A.RL_ENVS, env_steps=steps,
             event_ticks=events, fast_ticks_issued=fast, wall_s=wall,
             launches=launches, host_reads_per_env_step=len(reads) / steps,
             **_read_gate(reads, "rl_tx_gaia macro"), **report,
             at_s=time.perf_counter() - start)
        if launches != no_launches(power_scatter=steps + events + fast):
            raise AssertionError(f"rl_tx_gaia macro: launches {launches}")
        drains = []
        with counted_drains(torch, drains):
            (got, _), wall, launches, (events, fast), reads = _macro_counts(
                torch, lambda: A.run_ppo(env, guard=guard, n_iterations=1),
                guard=False)
        report = A.check_ppo(got, pins=A.PINNED_RL_MACRO["ppo"])
        emit("macro", step="ppo", iterations=1, wall_s=wall,
             launches=launches, drains=drains, history=got["history"],
             **_read_gate(reads, "ppo macro"), **report,
             at_s=time.perf_counter() - start)
        if drains != [1]:
            raise AssertionError(f"ppo macro: host drains {drains}")
        return env

    runs, env = run_alone(torch, alone, during=rl_pins)
    for e, (f1, t1) in zip(MACRO_FLEET_ALONE, runs):
        emit("macro", step="alone", policy=names[e], **_alone_vs_fleet(
            torch, "macro fleet", f1, final, e, t1, telem))
    for n_envs in MACRO_RL_ENVS:
        emit("macro", step="rl_scale", at_s=time.perf_counter() - start,
             **_rl_rollout_timed(torch, env, n_envs, RL_SCALE_STEPS))
    emit("macro", step="rl_profile", at_s=time.perf_counter() - start,
         **profile_rl("rl_tx_gaia", A.RL_ENVS, decisions=RL_PROFILE_STEPS,
                      macro=True))


def exponential_on_card(torch, np) -> dict:
    """The fault clocks' draw on the card against the CPU: ``-log1p(-u)``
    (``prng.log1p_f32``) on all 2**23 values ``uniform`` can give, whole
    ``prng.exponential`` draws, and ``prng.fma_f32`` on random f32
    triples, each with 0 differing bits (``tests/test_torch_faults.py``
    holds the CPU to XLA's bits)."""
    from repro_torch.utils import prng

    u = (np.arange(2 ** 23, dtype=np.float64) * 2.0 ** -23).astype(np.float32)
    cpu = (-prng.log1p_f32(-torch.from_numpy(u))).numpy().view(np.int32)
    t0 = time.perf_counter()
    card = (-prng.log1p_f32(-torch.from_numpy(u).cuda())).cpu().numpy()
    secs = time.perf_counter() - t0
    differ = int(np.count_nonzero(card.view(np.int32) != cpu))
    keys = torch.from_numpy(np.stack([prng.key_words(s) for s in range(8)]))
    draw_cpu = prng.exponential(keys, (672,)).numpy().view(np.int32)
    draw_card = prng.exponential(keys.cuda(), (672,)).cpu().numpy()
    draws_differ = int(np.count_nonzero(draw_card.view(np.int32)
                                        != draw_cpu))
    rng = np.random.default_rng(0)
    abc = [torch.from_numpy((rng.standard_normal(1 << 20)
                             * 10.0 ** rng.uniform(-3, 5, 1 << 20))
                            .astype(np.float32)) for _ in range(3)]
    fma_cpu = prng.fma_f32(*abc).numpy().view(np.int32)
    fma_card = prng.fma_f32(*(x.cuda() for x in abc)).cpu().numpy()
    fma_differ = int(np.count_nonzero(fma_card.view(np.int32) != fma_cpu))
    rec = dict(inputs=int(u.size), bits_differing=differ,
               draws_differing=draws_differ, fma_inputs=1 << 20,
               fma_bits_differing=fma_differ, card_seconds=secs)
    emit("kernel", name="exponential", **rec)
    if differ or draws_differ or fma_differ:
        raise AssertionError(f"exponential: card and CPU differ: {rec}")
    return rec


def faults(torch, np, jobs, bank, per_tick: dict) -> None:
    """The faults phase (see the module docstring, phase 9)."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.core import (
        build_statics,
        init_state,
        load_jobs,
        run_episode,
        summary,
        summary_columns,
    )
    from repro_torch.core.fleet import prepare_fleet
    from repro_torch.envs import SchedEnv
    from repro_torch.tools.profile_tick import profile_replay
    from repro_torch.utils import prng
    from repro_torch.utils.device import tree_to

    start = time.perf_counter()
    main_ms = 1e3 * per_tick["replay_tx_gaia_1h"][3] / A.N_STEPS
    hours = {}
    # (a) both hours per tick, at the JAX package's per-tick values
    for case in A.FAULT_CASES:
        cfg = A.config(case)
        statics = build_statics(cfg, bank, A.fault_scenario(case, cfg))
        hours[case] = drive(torch, case, cfg, statics, jobs, "faults")
        emit("faults", step="hour", case=case,
             ms_per_tick=1e3 * hours[case][3] / A.N_STEPS,
             replay_tx_gaia_1h_ms_per_tick=main_ms,
             at_s=time.perf_counter() - start)

    # (b) both hours macro-stepped: bitwise equal to per tick, the pinned
    # event ticks, the read gate, one power_tick launch a tick issued
    for case in A.FAULT_MACRO_CASES:
        base = A.base_case(case)
        cfg = A.config(case)
        statics = build_statics(cfg, bank, A.fault_scenario(case, cfg))
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        (final, telem), wall, launches, (events, fast), reads = \
            _macro_counts(torch, lambda: run_episode(
                cfg, statics, state, A.N_STEPS, A.SCHEDULER, macro=True))
        got = summary(final, telem)
        _, pt_final, pt_telem, pt_wall = hours[base]
        pins = A.PINNED_FAULTS[case]
        diffs = _against_per_tick(torch, case, (final, telem),
                                  (pt_final, pt_telem))
        emit("faults", step="macro hour", case=case, event_ticks=events,
             fast_ticks_issued=fast,
             ms_per_simulated_tick=1e3 * wall / A.N_STEPS,
             per_tick_ms_per_tick=1e3 * pt_wall / A.N_STEPS,
             replay_tx_gaia_1h_ms_per_tick=main_ms, wall_s=wall,
             launches=launches, **_read_gate(reads, case),
             **{k: got[k] for k in pins if k in got},
             reference_macro_steps_taken=pins["reference_macro_steps_taken"],
             **diffs, at_s=time.perf_counter() - start)
        A.check(case, got)
        if any(diffs.values()):
            raise AssertionError(f"{case}: not bitwise with per tick: "
                                 f"{diffs}")
        if events != got["macro_steps_taken"]:
            raise AssertionError(f"{case}: {events} event ticks issued, "
                                 f"{got['macro_steps_taken']} counted")
        want = no_launches(power_scatter=events + fast, rack_thermal=(
            events + fast if cfg.thermal_enabled else 0))
        if launches != want:
            raise AssertionError(f"{case}: launches {launches}, expected "
                                 f"{want} (one a tick issued)")

    # (c) the fault fleet: own keys and clocks, default grid and drill
    cfg = A.fleet_faults_config()
    statics = build_statics(cfg, bank)
    keys = torch.from_numpy(np.stack([prng.key_words(e)
                                      for e in range(A.FLEET_FAULTS_E)]))
    state = load_jobs(init_state(cfg, statics, keys), jobs)
    scns = A.fleet_faults_scenarios(cfg)
    fstatics, fstate, who = prepare_fleet(
        cfg, statics, state, A.FLEET_FAULTS_SCHEDULER, scenarios=scns)
    alone = [dict(cfg=cfg, statics=statics._replace(scenario=tree_to(
        scns[e], statics.idle_w.device)), state=type(fstate)(*(
            v[e] for v in fstate)), n_steps=A.FLEET_FAULTS_TICKS,
        scheduler=A.FLEET_FAULTS_SCHEDULER, kw=dict(summary_only=True))
        for e in A.FLEET_FAULTS_ALONE]

    # the fleet and then (d), while its replicas rerun alone in workers
    def fleet_and_rl():
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        final, telem = run_episode(cfg, fstatics, fstate,
                                   A.FLEET_FAULTS_TICKS, who,
                                   summary_only=True)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        cols = summary_columns(final, telem)
        report = A.check_fleet_faults(cols)
        emit("faults", step="fleet", ticks=A.FLEET_FAULTS_TICKS,
             wall_s=wall, ms_per_tick=1e3 * wall / A.FLEET_FAULTS_TICKS,
             launches=launches, alone_workers_meanwhile=len(alone),
             killed=cols["killed_by_failures"].tolist(), **report,
             at_s=time.perf_counter() - start)
        if launches != no_launches(power_scatter=A.FLEET_FAULTS_TICKS):
            raise AssertionError(f"fault fleet: launches {launches}")
        rl_checks()
        return final, telem

    # (d) the RL env with the ladder's actions, per tick and macro
    def rl_checks():
        cfg = A.rl_config(A.RL_FAULTS_CASE)
        guard = no_sync(torch)
        steps = A.RL_FAULTS_STEPS
        for macro in (False, True):
            env = SchedEnv(cfg, A.rl_workloads(cfg), **A.rl_env_kwargs(
                macro=macro, case=A.RL_FAULTS_CASE))
            got, wall, launches, (events, fast), reads = _macro_counts(
                torch, lambda: A.run_rl_script(env, A.RL_FAULTS_CASE,
                                               guard=guard), guard=False)
            report = A.check_rl(A.RL_FAULTS_CASE, got,
                                pins=A.PINNED_RL_FAULTS[
                                    "macro" if macro else "per_tick"])
            ticks = (steps + events + fast if macro
                     else steps * A.RL_SIM_STEPS)
            emit("faults", step="rl_script", macro=macro, envs=A.RL_ENVS,
                 env_steps=steps, n_actions=env.n_actions,
                 obs_dim=env.obs_dim, ticks_issued=ticks, wall_s=wall,
                 launches=launches,
                 **(_read_gate(reads, "rl faults macro") if macro
                    else {}),
                 **report, at_s=time.perf_counter() - start)
            if launches != no_launches(power_scatter=ticks):
                raise AssertionError(f"rl faults (macro={macro}): "
                                     f"launches {launches}")

    runs, (final, telem) = run_alone(torch, alone, during=fleet_and_rl)
    for e, (f1, t1) in zip(A.FLEET_FAULTS_ALONE, runs):
        emit("faults", step="alone", **_alone_vs_fleet(
            torch, "fault fleet", f1, final, e, t1, telem),
            at_s=time.perf_counter() - start)

    # (e) where the faults hour's tick goes: CUDA kernels, the fault
    # engine's share
    emit("faults", step="profile", **profile_replay(
        "replay_tx_gaia_1h_faults", *FAULTS_PROFILE, top=6),
        at_s=time.perf_counter() - start)


def serving(torch, np, jobs, bank, per_tick: dict) -> dict:
    """The serving phase (see the module docstring, phase 13). Returns
    the profiles of the serving tick and the plain tick, by case."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.core import (
        build_statics,
        init_state,
        load_jobs,
        run_episode,
        summary_columns,
    )
    from repro_torch.core.fleet import prepare_fleet
    from repro_torch.envs import SchedEnv
    from repro_torch.tools.profile_tick import profile_replay
    from repro_torch.utils.device import tree_to

    start = time.perf_counter()
    main_ms = 1e3 * per_tick["replay_tx_gaia_1h"][3] / A.N_STEPS
    cfg = A.config(A.SERVING_CASE)
    statics = build_statics(cfg, bank, A.serving_scenario(cfg))
    state = A.half_asleep(load_jobs(init_state(cfg, statics, seed=A.SEED),
                                    jobs))

    # (a) the hour per tick, at the JAX package's per-tick values
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    final, telem = run_episode(cfg, statics, state, A.N_STEPS, A.SCHEDULER,
                               summary_only=True)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got = A.serving_summary(final, telem)
    emit("serving", step="hour", case=A.SERVING_CASE, ticks=A.N_STEPS,
         wall_s=wall, ms_per_tick=1e3 * wall / A.N_STEPS,
         replay_tx_gaia_1h_ms_per_tick=main_ms, launches=launches,
         **{k: got[k] for k in A.SERVING_KEYS},
         **A.check_serving(A.SERVING_CASE, got),
         at_s=time.perf_counter() - start)
    if launches != no_launches(power_scatter=A.N_STEPS):
        raise AssertionError(f"{A.SERVING_CASE}: launches {launches}")
    for name, v in final._asdict().items():
        ok = (~torch.isnan(v) if name in INF_CLOCKS else torch.isfinite(v))
        if v.is_floating_point() and not bool(ok.all()):
            raise AssertionError(f"{A.SERVING_CASE}: final state field "
                                 f"{name}: bad values")

    # (b) macro-stepped: bitwise equal to per tick, the read gate, one
    # power_tick launch a tick issued
    case = A.SERVING_MACRO_CASE
    (mf, mt), mwall, launches, (events, fast), reads = _macro_counts(
        torch, lambda: run_episode(cfg, statics, state, A.N_STEPS,
                                   A.SCHEDULER, macro=True))
    gm = A.serving_summary(mf, mt)
    diffs = _against_per_tick(torch, case, (mf, mt), (final, telem))
    pins = A.PINNED_SERVING[case]
    emit("serving", step="macro hour", case=case, event_ticks=events,
         fast_ticks_issued=fast,
         fast_ticks_masked=fast - int(gm["ticks_simulated"]
                                      - gm["macro_steps_taken"]),
         macro_skip_ratio=gm["macro_skip_ratio"],
         ms_per_simulated_tick=1e3 * mwall / A.N_STEPS,
         per_tick_ms_per_tick=1e3 * wall / A.N_STEPS,
         replay_tx_gaia_1h_ms_per_tick=main_ms, wall_s=mwall,
         launches=launches, **_read_gate(reads, case),
         reference_macro_steps_taken=pins["reference_macro_steps_taken"],
         **A.check_serving(case, gm), **diffs,
         at_s=time.perf_counter() - start)
    if any(diffs.values()):
        raise AssertionError(f"{case}: not bitwise with per tick: {diffs}")
    if events != gm["macro_steps_taken"]:
        raise AssertionError(f"{case}: {events} event ticks issued, "
                             f"{gm['macro_steps_taken']} counted")
    if launches != no_launches(power_scatter=events + fast):
        raise AssertionError(f"{case}: launches {launches}, expected one "
                             "a tick issued")

    # (c) the fleet: replica i at a peak of 12 (i + 1) req/s, at the
    # vmapped reference's values; replicas rerun alone in workers while
    # the parent runs the fleet and (d)
    scns = [A.serving_scenario(cfg, A.fleet_serving_traffic(e))
            for e in range(A.FLEET_SERVING_E)]
    fstatics, fstate, who = prepare_fleet(cfg, statics, state, A.SCHEDULER,
                                          scenarios=scns)
    alone = [dict(cfg=cfg, statics=statics._replace(scenario=tree_to(
        scns[e], statics.idle_w.device)), state=type(fstate)(*(
            v[e] for v in fstate)), n_steps=A.FLEET_SERVING_TICKS,
        scheduler=A.SCHEDULER, kw=dict(summary_only=True))
        for e in A.FLEET_SERVING_ALONE]

    def fleet_and_rl():
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        ffinal, ftelem = run_episode(cfg, fstatics, fstate,
                                     A.FLEET_SERVING_TICKS, who,
                                     summary_only=True)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        cols = summary_columns(ffinal, ftelem)
        emit("serving", step="fleet", ticks=A.FLEET_SERVING_TICKS,
             wall_s=fwall, ms_per_tick=1e3 * fwall / A.FLEET_SERVING_TICKS,
             launches=launches, alone_workers_meanwhile=len(alone),
             srv_shed=cols["srv_shed"].tolist(),
             **A.check_fleet_serving(cols), at_s=time.perf_counter() - start)
        if launches != no_launches(power_scatter=A.FLEET_SERVING_TICKS):
            raise AssertionError(f"serving fleet: launches {launches}")
        rl_checks()
        return ffinal, ftelem

    # (d) rl_tx_gaia_serving per tick and macro, at the pins
    def rl_checks():
        rcfg = A.rl_config(A.RL_SERVING_CASE)
        guard = no_sync(torch)
        steps = A.RL_SERVING_STEPS
        for macro in (False, True):
            env = SchedEnv(rcfg, A.rl_workloads(rcfg),
                           scenario=A.rl_scenario(A.RL_SERVING_CASE, rcfg),
                           **A.rl_env_kwargs(macro, A.RL_SERVING_CASE))
            got, rwall, launches, (events, fast), reads = _macro_counts(
                torch, lambda: A.run_rl_script(env, A.RL_SERVING_CASE,
                                               guard=guard), guard=False)
            report = A.check_rl(A.RL_SERVING_CASE, got,
                                pins=A.PINNED_RL_SERVING[
                                    "macro" if macro else "per_tick"])
            ticks = (steps + events + fast if macro
                     else steps * A.RL_SIM_STEPS)
            emit("serving", step="rl_script", macro=macro, envs=A.RL_ENVS,
                 env_steps=steps, n_actions=env.n_actions,
                 obs_dim=env.obs_dim, ticks_issued=ticks, wall_s=rwall,
                 launches=launches,
                 **(_read_gate(reads, "rl serving macro") if macro
                    else {}),
                 **report, at_s=time.perf_counter() - start)
            if launches != no_launches(power_scatter=ticks):
                raise AssertionError(f"rl serving (macro={macro}): "
                                     f"launches {launches}")

    runs, (ffinal, ftelem) = run_alone(torch, alone, during=fleet_and_rl)
    for e, (f1, t1) in zip(A.FLEET_SERVING_ALONE, runs):
        emit("serving", step="alone", **_alone_vs_fleet(
            torch, "serving fleet", f1, ffinal, e, t1, ftelem),
            at_s=time.perf_counter() - start)

    # (e) where the serving tick goes, beside the plain hour's in the same
    # run: CUDA kernels a tick
    profiles = {}
    for name in (A.SERVING_CASE, "replay_tx_gaia_1h"):
        profiles[name] = profile_replay(name, *SERVING_PROFILE, top=6)
        emit("serving", step="profile", **profiles[name],
             at_s=time.perf_counter() - start)
    return profiles


def _bitwise(torch, a, b) -> list:
    """The fields in which two (state, telemetry) pairs differ at all
    (``None`` fields of a switched-off block on both sides are equal)."""
    from repro_torch.utils.tree import tree_leaves_with_names

    la, lb = tree_leaves_with_names(a), tree_leaves_with_names(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        return ["<structure>"]
    return [n for (n, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]


def _timed_saves(saves: list):
    """Context manager: every ``checkpoint.ckpt.save`` (a snapshot: the
    drain, then the writes) appends (host seconds, of which the drain's,
    bytes written)."""
    import contextlib

    from repro_torch.checkpoint import ckpt

    @contextlib.contextmanager
    def patched():
        real, real_drain = ckpt.save, ckpt.drain
        drained = []

        def timed_drain(tree):
            t0 = time.perf_counter()
            out = real_drain(tree)
            drained.append(time.perf_counter() - t0)
            return out

        def timed(*a, **kw):
            t0 = time.perf_counter()
            path = real(*a, **kw)
            saves.append((time.perf_counter() - t0, drained.pop(), sum(
                f.stat().st_size for f in Path(path).iterdir())))
            return path

        ckpt.save, ckpt.drain = timed, timed_drain
        try:
            yield
        finally:
            ckpt.save, ckpt.drain = real, real_drain
    return patched()


def _drop_after(directory: Path, tick: int) -> list:
    """Delete the snapshots after ``tick`` (a run killed there); returns
    the snapshots left."""
    import shutil

    for d in directory.iterdir():
        if int(d.name.split("_")[1].split(".")[0]) > tick:
            shutil.rmtree(d)
    return sorted(d.name for d in directory.iterdir())


def durable(torch, np, jobs, bank, per_tick: dict, ppo_run,
            profiles: dict) -> None:
    """The durable phase (see the module docstring, phase 14)."""
    import shutil
    import threading

    from repro_torch.utils.chaos import chaos_smoke

    start = time.perf_counter()
    work = ROOT / "build" / "durable"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # (4) the chaos kill loop on the card, in worker processes beside the
    # parent's checks after (1): the reference worker, then the killed ones
    chaos = {}

    def chaos_loop():
        try:
            chaos["out"] = chaos_smoke(
                "replay", str(work / "chaos"), seed=0, case=DURABLE_FAULTS,
                n_steps=DURABLE_FAULTS_TICKS,
                snapshot_every_s=DURABLE_FAULTS_SNAP_S, **DURABLE_CHAOS)
        except Exception as e:      # re-raised in the parent below
            chaos["error"] = e
    chaos_thread = threading.Thread(target=chaos_loop, daemon=True)
    try:
        _durable_checks(torch, np, jobs, bank, per_tick, ppo_run, profiles,
                        work, start, after_hour=chaos_thread.start)
    finally:
        # the kill loop's processes end before the phase does, also when a
        # check above failed (its final launch has its own time limit)
        if chaos_thread.ident is not None:
            chaos_thread.join(timeout=DURABLE_CHAOS_TIMEOUT_S)
    # (4) the chaos loop's verdict
    if chaos_thread.is_alive():
        raise AssertionError("chaos loop: over "
                             f"{DURABLE_CHAOS_TIMEOUT_S} s")
    if "error" in chaos:
        raise chaos["error"]
    out = chaos["out"]
    emit("durable", step="chaos", case=DURABLE_FAULTS,
         ticks=DURABLE_FAULTS_TICKS, **out,
         at_s=time.perf_counter() - start)
    if out["n_kills"] != DURABLE_CHAOS["kills"] or not out["resumed_from"]:
        raise AssertionError(f"chaos loop: {out['n_kills']} kills, the "
                             f"final launch resumed from "
                             f"{out['resumed_from']}")


def _durable_checks(torch, np, jobs, bank, per_tick: dict, ppo_run,
                    profiles: dict, work: Path, start: float,
                    after_hour) -> None:
    """Steps (1)-(3) and (5)-(7) of the durable phase: (1) alone on the
    card, then ``after_hour()`` starts the chaos loop beside the rest."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.core import (
        build_statics,
        init_state,
        load_jobs,
        run_episode,
        run_fleet,
        summary,
    )
    from repro_torch.rl import PPOConfig, ppo_train
    from repro_torch.tools.profile_tick import episode_launch_calls
    from repro_torch.utils import device as D
    from repro_torch.utils import prng
    from repro_torch.utils.errors import InvariantError

    guard = no_sync(torch)

    # (1) the main hour snapshotted every 600 s, alone on the card (its ms
    # a tick beside phase 4's and a plain window's timed just after it):
    # bitwise phase 4's hour
    cfg = A.config()
    statics = build_statics(cfg, bank)
    state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
    _, p_final, p_telem, p_wall = per_tick["replay_tx_gaia_1h"]
    hour_dir = work / "hour"
    n_snaps = A.N_STEPS // round(DURABLE_HOUR_SNAP_S / cfg.dt)

    saves = []
    kernels.reset_launches()
    D.reset_host_reads()
    with _timed_saves(saves), guard():
        t0 = time.perf_counter()
        final, telem = run_episode(
            cfg, statics, state, A.N_STEPS, A.SCHEDULER, summary_only=True,
            snapshot_every_s=DURABLE_HOUR_SNAP_S, snapshot_dir=str(hour_dir),
            snapshot_keep=n_snaps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, reads = dict(kernels.LAUNCHES), D.HOST_READS["count"]
    differ = _bitwise(torch, (final, telem), (p_final, p_telem))
    same_summary = summary(final, telem) == summary(p_final, p_telem)
    with guard():
        t0 = time.perf_counter()
        run_episode(cfg, statics, state, DURABLE_PLAIN_TICKS, A.SCHEDULER,
                    summary_only=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0) / DURABLE_PLAIN_TICKS
    emit("durable", step="snapshotted hour", case="replay_tx_gaia_1h",
         ticks=A.N_STEPS, snapshot_every_s=DURABLE_HOUR_SNAP_S,
         snapshots=len(saves), host_reads=reads,
         ms_per_snapshot=1e3 * sum(t for t, _, _ in saves) / len(saves),
         snapshot_ms=[1e3 * t for t, _, _ in saves],
         drain_ms=[1e3 * d for _, d, _ in saves],
         bytes_per_snapshot=saves[0][2],
         files_per_snapshot=len(list((hour_dir / sorted(
             os.listdir(hour_dir))[0]).iterdir())),
         wall_s=wall, ms_per_tick=1e3 * wall / A.N_STEPS,
         main_ms_per_tick=1e3 * p_wall / A.N_STEPS,
         ms_per_tick_over_main=wall / p_wall,
         plain_window_ticks=DURABLE_PLAIN_TICKS,
         plain_window_ms_per_tick=plain_ms,
         ms_per_tick_over_plain_window=1e3 * wall / A.N_STEPS / plain_ms,
         snapshot_share=sum(t for t, _, _ in saves) / wall,
         launches=launches,
         fields_differing_from_main=differ, summary_equal=same_summary,
         at_s=time.perf_counter() - start)
    if differ or not same_summary:
        raise AssertionError(f"snapshotted hour differs from phase 4's in "
                             f"{differ}")
    if launches != no_launches(power_scatter=A.N_STEPS):
        raise AssertionError(f"snapshotted hour: launches {launches}")
    if reads != 1 + n_snaps or len(saves) != n_snaps:
        raise AssertionError(f"snapshotted hour: {reads} host reads, "
                             f"{len(saves)} snapshots; expected 1 + "
                             f"{n_snaps}")
    after_hour()

    # (5) the fault fleet's uninterrupted snapshotted run in a worker,
    # while the parent runs (2), (3), (6) and (7)
    fcfg = A.fleet_faults_config()
    fstatics = build_statics(fcfg, bank)
    keys = torch.from_numpy(np.stack([prng.key_words(e)
                                      for e in range(A.FLEET_FAULTS_E)]))
    fstate = load_jobs(init_state(fcfg, fstatics, keys), jobs)
    scns = A.fleet_faults_scenarios(fcfg)
    fleet_dir = work / "fleet"
    fleet_kw = dict(scenarios=scns, summary_only=True,
                    snapshot_every_s=DURABLE_FLEET_SNAP_S)
    fleet_run = dict(entry="run_fleet", cfg=fcfg, statics=fstatics,
                     state=fstate, n_steps=DURABLE_FLEET_TICKS,
                     scheduler=A.FLEET_FAULTS_SCHEDULER,
                     kw=dict(fleet_kw, snapshot_dir=str(fleet_dir),
                             snapshot_keep=99))

    def meanwhile():
        # (2) killed after tick 1,800, resumed: bitwise (1), 1 + 3 reads
        left = _drop_after(hour_dir, DURABLE_KILL_TICK)
        kernels.reset_launches()
        D.reset_host_reads()
        with guard():
            t0 = time.perf_counter()
            rf, rt = run_episode(
                cfg, statics, state, A.N_STEPS, A.SCHEDULER,
                summary_only=True, snapshot_every_s=DURABLE_HOUR_SNAP_S,
                resume_from=str(hour_dir))
            torch.cuda.synchronize()
            rwall = time.perf_counter() - t0
        rdiff = _bitwise(torch, (rf, rt), (final, telem))
        rlaunches, rreads = dict(kernels.LAUNCHES), D.HOST_READS["count"]
        emit("durable", step="killed and resumed hour", resumed_from=left,
             ticks_run=A.N_STEPS - DURABLE_KILL_TICK, host_reads=rreads,
             wall_s=rwall, launches=rlaunches, fields_differing=rdiff,
             at_s=time.perf_counter() - start)
        want = 1 + (A.N_STEPS - DURABLE_KILL_TICK) // round(
            DURABLE_HOUR_SNAP_S / cfg.dt)
        if rdiff or rreads != want:
            raise AssertionError(f"resumed hour: differs in {rdiff}, "
                                 f"{rreads} reads (expected {want})")
        if rlaunches != no_launches(
                power_scatter=A.N_STEPS - DURABLE_KILL_TICK):
            raise AssertionError(f"resumed hour: launches {rlaunches}")

        # (3) faults, macro-stepped, keys and clocks: uninterrupted, then
        # killed after its 4th snapshot and resumed
        qcfg = A.config(DURABLE_FAULTS)
        qstatics = build_statics(qcfg, bank,
                                 A.fault_scenario(DURABLE_FAULTS, qcfg))
        qstate = load_jobs(init_state(qcfg, qstatics, seed=A.SEED), jobs)
        qdir = work / "faults"
        per = round(DURABLE_FAULTS_SNAP_S / qcfg.dt)
        runs = []
        for resume in (False, True):
            snaps = (DURABLE_FAULTS_TICKS // per
                     - (DURABLE_FAULTS_KILL_AFTER if resume else 0))
            kw = (dict(resume_from=str(qdir)) if resume
                  else dict(snapshot_dir=str(qdir), snapshot_keep=99))
            if resume:
                qleft = _drop_after(qdir, DURABLE_FAULTS_KILL_AFTER * per)
            out, qwall, qlaunches, (events, fast), qreads = _macro_counts(
                torch, lambda: run_episode(
                    qcfg, qstatics, qstate, DURABLE_FAULTS_TICKS,
                    A.SCHEDULER, macro=True,
                    snapshot_every_s=DURABLE_FAULTS_SNAP_S, **kw),
                extra_reads=1 + snaps)
            runs.append(out)
            emit("durable", step="faults macro", case=DURABLE_FAULTS,
                 resumed=resume, resumed_from=qleft if resume else None,
                 ticks=DURABLE_FAULTS_TICKS, snapshots=snaps,
                 event_ticks=events, fast_ticks_issued=fast, wall_s=qwall,
                 launches=qlaunches, drains=1 + snaps,
                 **_read_gate(qreads, DURABLE_FAULTS),
                 at_s=time.perf_counter() - start)
            if qlaunches != no_launches(power_scatter=events + fast):
                raise AssertionError(f"faults macro: launches {qlaunches}")
        qdiff = _bitwise(torch, runs[0], runs[1])
        emit("durable", step="faults macro resumed", fields_differing=qdiff,
             key_equal=torch.equal(runs[0][0].key, runs[1][0].key),
             killed=float(runs[1][0].n_killed),
             at_s=time.perf_counter() - start)
        if qdiff:
            raise AssertionError(f"faults macro: resumed run differs in "
                                 f"{qdiff}")

        # (6) PPO with a checkpoint every iteration: bitwise phase rl's
        # run; iteration 1's checkpoint deleted, resumed to 2
        env, ppo_got, ppo_params = ppo_run
        pcfg = PPOConfig(n_envs=A.RL_ENVS, rollout_len=A.RL_ROLLOUT)
        ppo_dir = work / "ppo"
        outs = []
        for resume in (False, True):
            drains = []
            D.reset_host_reads()
            with counted_drains(torch, drains), guard():
                t0 = time.perf_counter()
                outs.append(ppo_train(
                    env, cfg=pcfg, n_iterations=A.RL_ITERATIONS,
                    seed=A.RL_SEED, checkpoint_dir=str(ppo_dir),
                    checkpoint_every=1, resume=resume))
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t0
            emit("durable", step="ppo", resumed=resume,
                 iterations=len(outs[-1][1]), wall_s=pwall, drains=drains,
                 checkpoint_reads=D.HOST_READS["count"],
                 checkpoints=sorted(os.listdir(ppo_dir)),
                 at_s=time.perf_counter() - start)
            if D.HOST_READS["count"] != len(drains):
                raise AssertionError(f"ppo: {D.HOST_READS['count']} "
                                     "checkpoint reads, one a chunk "
                                     f"expected ({drains})")
            if not resume:
                _drop_after(ppo_dir, A.RL_ITERATIONS - 2)
        (p_full, h_full), (p_res, h_res) = outs
        same = (h_full == ppo_got["history"]
                and all(torch.equal(p_full[k], ppo_params[k])
                        for k in ppo_params))
        resumed = (h_res == h_full[1:]
                   and all(torch.equal(p_res[k], p_full[k])
                           for k in p_full))
        emit("durable", step="ppo resumed", bitwise_with_rl_phase=same,
             resumed_bitwise=resumed, at_s=time.perf_counter() - start)
        if not (same and resumed):
            raise AssertionError(f"ppo checkpoints: bitwise with phase rl "
                                 f"{same}, resumed {resumed}")

        # (7) the invariant harness on the faults hour's state
        os.environ["REPRO_CHECKIFY"] = "1"
        try:
            kernels.reset_launches()
            D.reset_host_reads()
            with guard():
                t0 = time.perf_counter()
                run_episode(qcfg, qstatics, qstate, DURABLE_CHECK_TICKS,
                            A.SCHEDULER, summary_only=True)
                torch.cuda.synchronize()
                cwall = time.perf_counter() - t0
            creads, claunches = D.HOST_READS["count"], dict(kernels.LAUNCHES)
            bad = qstate._replace(free=qstate.free + 100.0)
            caught = None
            try:
                with guard():
                    run_episode(qcfg, qstatics, bad, 10, A.SCHEDULER,
                                summary_only=True)
            except InvariantError as e:
                caught = e
        finally:
            del os.environ["REPRO_CHECKIFY"]
        gate_off = {name: profiles[name]["launch_calls_per_tick"]
                    for name in DURABLE_GATE_OFF_CALLS}
        # with the gate off, a tick inside run_episode launches what a
        # bare make_step + telemetry loop does, its step 463 / 674 calls
        in_episode = {name: episode_launch_calls(name,
                                                 *DURABLE_EPISODE_CALLS)
                      for name in DURABLE_GATE_OFF_CALLS}
        emit("durable", step="invariants", case=DURABLE_FAULTS,
             ticks=DURABLE_CHECK_TICKS, wall_s=cwall,
             ms_per_tick=1e3 * cwall / DURABLE_CHECK_TICKS,
             host_reads=creads, launches=claunches,
             corrupt_state_error=str(caught) if caught else None,
             corrupt_state_tick=caught.tick if caught else None,
             gate_off_launch_calls_per_tick=gate_off,
             gate_off_in_episode=in_episode,
             at_s=time.perf_counter() - start)
        if creads != 1 or claunches != no_launches(
                power_scatter=DURABLE_CHECK_TICKS):
            raise AssertionError(f"invariants: {creads} reads, launches "
                                 f"{claunches}")
        if caught is None or caught.tick != 0 \
                or "resource conservation" not in caught.check:
            raise AssertionError(f"invariants: the corrupt state gave "
                                 f"{caught!r}")
        if gate_off != DURABLE_GATE_OFF_CALLS:
            raise AssertionError(f"gate off: launch calls a tick "
                                 f"{gate_off}, expected "
                                 f"{DURABLE_GATE_OFF_CALLS}")
        for name, got in in_episode.items():
            if not (got["episode_launch_calls_per_tick"]
                    == got["bare_launch_calls_per_tick"]
                    and got["step_launch_calls_per_tick"]
                    == DURABLE_GATE_OFF_CALLS[name]):
                raise AssertionError(f"gate off: run_episode's tick "
                                     f"{got}, expected a bare loop's with "
                                     f"{DURABLE_GATE_OFF_CALLS[name]} in "
                                     "its step")

    [(ff, ft)], _ = run_alone(torch, [fleet_run], during=meanwhile)

    # (5) the fleet killed after its 2nd snapshot, resumed in the parent
    fper = round(DURABLE_FLEET_SNAP_S / fcfg.dt)
    left = _drop_after(fleet_dir, DURABLE_FLEET_KILL_AFTER * fper)
    D.reset_host_reads()
    kernels.reset_launches()
    with guard():
        t0 = time.perf_counter()
        rf, rt = run_fleet(fcfg, fstatics, fstate, DURABLE_FLEET_TICKS,
                           A.FLEET_FAULTS_SCHEDULER, resume_from=str(
                               fleet_dir), **fleet_kw)
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
    fdiff = _bitwise(torch, (rf, rt), (ff, ft))
    ticks = DURABLE_FLEET_TICKS - DURABLE_FLEET_KILL_AFTER * fper
    emit("durable", step="fleet resumed", replicas=A.FLEET_FAULTS_E,
         resumed_from=left, ticks_run=ticks, wall_s=fwall,
         host_reads=D.HOST_READS["count"], launches=dict(kernels.LAUNCHES),
         killed=rf.n_killed.tolist(), fields_differing=fdiff,
         at_s=time.perf_counter() - start)
    if fdiff:
        raise AssertionError(f"fault fleet: resumed run differs in {fdiff}")
    if D.HOST_READS["count"] != 1 + ticks // fper:
        raise AssertionError(f"fault fleet: {D.HOST_READS['count']} reads")
    if dict(kernels.LAUNCHES) != no_launches(power_scatter=ticks):
        raise AssertionError(f"fault fleet: launches {kernels.LAUNCHES}")



def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core import run_episode
    from repro_torch.core.thermal import thermal_alpha
    from repro_torch.kernels import build
    from repro_torch.kernels import node_power as npw
    from repro_torch.kernels import rack_thermal as prt

    # 1. env
    from repro_torch.utils.device import exact_matmul

    exact_matmul()   # no TF32, f32 accumulation inside bf16 products
    card = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         nvidia_smi=card)

    # 2. build
    kernel_names = ["power_scatter", "rack_thermal", "node_power",
                    "flash_attn", "selective_scan"]
    secs = build.build(kernel_names)
    tensor_cores = flash_attn_bf16_build(build)
    emit("build", seconds=secs,
         ptxas=[ln for name in kernel_names
                for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln],
         flash_attn_bf16=tensor_cores)

    # 3. kernels against their plain versions, at the paths' shapes
    cfg = acceptance.config()
    jobs, bank = acceptance.workload(cfg)
    statics = build_statics(cfg, bank)
    chain = dict(rect_peak=cfg.rect_eff_peak, rect_load=cfg.rect_eff_load,
                 rect_curv=cfg.rect_eff_curv, conv_eff=cfg.conv_eff)
    jk = cfg.max_jobs * cfg.max_nodes_per_job
    n_nodes, n_racks = cfg.n_nodes, cfg.n_racks
    alpha = thermal_alpha(acceptance.config("replay_tx_gaia_1h_thermal"))
    record = {}
    for n_rep in (1, 64):
        a = power_scatter_inputs(torch, np, statics, n_rep, jk, seed=n_rep)
        record["power_scatter", n_rep] = check_kernel(
            torch, "power_scatter", npw.power_scatter(*a, **chain),
            npw.power_scatter_torch(*a, **chain),
            lambda: npw.power_scatter(*a, **chain),
            lambda: npw.power_scatter_torch(*a, **chain),
            *power_scatter_bound(a), replicas=n_rep, slots=jk, nodes=n_nodes)

        a = rack_thermal_inputs(torch, np, statics, n_rep, seed=n_rep)
        # one add per node, ~5 operations per rack of the RC step
        rt_bound = bound(nbytes(a), 2 * 4 * n_rep * n_racks,
                         n_rep * (n_nodes + 5 * n_racks))
        record["rack_thermal", n_rep] = check_kernel(
            torch, "rack_thermal", prt.rack_thermal(*a, alpha=alpha),
            prt.rack_thermal_torch(*a, alpha=alpha),
            lambda: prt.rack_thermal(*a, alpha=alpha),
            lambda: prt.rack_thermal_torch(*a, alpha=alpha),
            *rt_bound, replicas=n_rep, nodes=n_nodes, racks=n_racks)

        a = node_power_inputs(torch, np, statics, n_rep, seed=n_rep)
        # ~15 f32 operations per node of the chain
        np_bound = bound(nbytes(a), 2 * 4 * n_rep * n_nodes,
                         15 * n_rep * n_nodes)
        record["node_power", n_rep] = check_kernel(
            torch, "node_power", npw.node_power(*a, **chain),
            npw.node_chain(*a, **chain),
            lambda: npw.node_power(*a, **chain),
            lambda: npw.node_chain(*a, **chain),
            *np_bound, replicas=n_rep, nodes=n_nodes)

    # the replay tick's fused entries: the main path's (thermals off) at
    # E = 1, and the thermal hours' at E = 1 and 64
    from repro_torch.core import power as cpower
    from repro_torch.core import thermal as cthermal

    tcfg = acceptance.config("replay_tx_gaia_1h_thermal")
    tstatics = build_statics(tcfg, bank)
    cpu_bank = build_statics(tcfg, bank, device="cpu")
    for n_rep, hcfg, hstatics, cpu_st in (
            (1, cfg, statics, build_statics(cfg, bank, device="cpu")),
            (1, tcfg, tstatics, cpu_bank), (64, tcfg, tstatics, cpu_bank)):
        ts = cpower.tick_statics(hcfg, hstatics)
        st = tick_state(torch, np, hcfg, n_rep, seed=n_rep)
        record["power_tick", n_rep, hcfg.thermal_enabled] = check_tick_kernel(
            torch, "power_tick", npw.power_tick, npw.power_tick_torch,
            cpower.tick_statics(hcfg, cpu_st), ts, st,
            *power_tick_bound(ts, st), bitwise=(0, 1, 3), replicas=n_rep,
            thermal=hcfg.thermal_enabled, jobs=hcfg.max_jobs, slots=jk,
            nodes=n_nodes)
    # a fleet's tick over a banked trace of three workloads, each replica
    # reading its own slice inside the kernel: the fleet's E = 72 and the
    # grid tiled 16x
    from repro_torch.data import stack_workloads, synth_workload

    wls = [(jobs, bank)] + [synth_workload(cfg, 200, 3600.0, seed=seed)
                            for seed in (1, 2)]
    banked = stack_workloads(cfg, wls)[1]
    ts_banked = cpower.tick_statics(cfg, build_statics(cfg, banked))
    ts_banked_cpu = cpower.tick_statics(
        cfg, build_statics(cfg, banked, device="cpu"))
    for n_rep in (72, 1152):
        st = tick_state(torch, np, cfg, n_rep, seed=n_rep)
        st.append(torch.arange(n_rep, dtype=torch.int32, device="cuda") % 3)
        record["power_tick", n_rep, "banked"] = check_tick_kernel(
            torch, "power_tick", npw.power_tick, npw.power_tick_torch,
            ts_banked_cpu, ts_banked, st, *power_tick_bound(ts_banked, st),
            bitwise=(0, 1, 3), plain_timing=(5, 2) if n_rep > 100 else (
                TIMING_REPS, TIMING_BATCH), replicas=n_rep,
            banked_workloads=len(wls), thermal=False, jobs=cfg.max_jobs,
            slots=jk, nodes=n_nodes)
    # with the fault engine's down nodes: rack 0 and ~5% of the others
    for n_rep, hcfg, hstatics, cpu_st in (
            (1, cfg, statics, build_statics(cfg, bank, device="cpu")),
            (64, cfg, statics, build_statics(cfg, bank, device="cpu")),
            (1, tcfg, tstatics, cpu_bank), (64, tcfg, tstatics, cpu_bank)):
        ts = cpower.tick_statics(hcfg, hstatics)
        st = tick_state(torch, np, hcfg, n_rep, seed=100 + n_rep,
                        rack_down=True)
        record["power_tick", n_rep, hcfg.thermal_enabled, "down"] = \
            check_tick_kernel(
                torch, "power_tick", npw.power_tick, npw.power_tick_torch,
                cpower.tick_statics(hcfg, cpu_st), ts, st,
                *power_tick_bound(ts, st), bitwise=(0, 1, 3),
                replicas=n_rep, thermal=hcfg.thermal_enabled,
                rack_down=True, jobs=hcfg.max_jobs, slots=jk, nodes=n_nodes)
    for n_rep, rack_down in ((1, False), (64, False), (1, True),
                             (64, True)):
        rs = cthermal.rack_tick_statics(tcfg, tstatics)
        a = rack_tick_inputs(torch, np, tcfg, n_rep, seed=n_rep,
                             rack_down=rack_down)
        # a multiply and an add per node, ~12 operations per rack
        rt_bound = bound(nbytes(a) + nbytes((rs.rack_ptr, rs.rack_nodes,
                                             rs.r_th)),
                         4 * n_rep * (n_racks + 3),
                         n_rep * (2 * n_nodes + 12 * n_racks))
        record[("rack_tick", n_rep) + (("down",) if rack_down else ())] = \
            check_tick_kernel(
                torch, "rack_tick", prt.rack_tick, prt.rack_tick_torch,
                cthermal.rack_tick_statics(tcfg, cpu_bank), rs, a, *rt_bound,
                bitwise=(0, 1, 2, 3), replicas=n_rep, nodes=n_nodes,
                racks=n_racks, rack_down=rack_down)
    exponential_on_card(torch, np)
    # the floor under every launch's back-to-back time: one empty kernel
    floor_launch = build.function("power_scatter", pointers=0, ints=0,
                                  floats=0, entry="launch_floor")
    launch_floor_ms = time_ms(torch, lambda: floor_launch(
        torch.cuda.current_stream().cuda_stream))
    emit("kernel", name="launch_floor", launch_floor_ms=launch_floor_ms)

    for case in ATTN_CASES:
        record["flash_attn", case[0]] = check_attention(torch, np, *case)
    for case in SCAN_CASES:
        record["selective_scan", case[0]] = check_scan(torch, np, *case)
        for dtype in ("bfloat16", "float32"):
            record["mamba_scan", dtype, case[0]] = check_mamba_scan(
                torch, np, case[0], dtype, *case[1:])

    # 4. main path: replay_tx_gaia_1h on the card
    per_tick = {"replay_tx_gaia_1h": drive(torch, "replay_tx_gaia_1h", cfg,
                                           statics, jobs, "main")}
    launches = per_tick["replay_tx_gaia_1h"][0]

    # 5. the thermal twin: both hours; the kernels line reports the first
    # hour's rack_thermal launches
    for case in THERMAL_CASES:
        tcfg = acceptance.config(case)
        per_tick[case] = drive(torch, case, tcfg, build_statics(tcfg, bank),
                               jobs, "thermal")
    launches["rack_thermal"] = per_tick[THERMAL_CASES[0]][0]["rack_thermal"]

    # 6. fleet: the replay tick batched over a replica axis
    t0 = time.perf_counter()
    fleet_hour = fleet(torch, np, jobs, bank)
    emit("fleet", step="done", seconds=time.perf_counter() - t0)

    # 7. rl: SchedEnv batched over the replica axis, PPO end to end
    t0 = time.perf_counter()
    ppo_run = rl(torch, np)
    emit("rl", step="done", seconds=time.perf_counter() - t0)

    # 8. macro: the replay hours, the fleet hour and the RL env with quiet
    # ticks fast-forwarded, against the pins and the per-tick runs above
    t0 = time.perf_counter()
    macro(torch, np, jobs, bank, per_tick, fleet_hour)
    emit("macro", step="done", seconds=time.perf_counter() - t0)

    # 9. faults: the resilience twin's hours, fleet and env
    t0 = time.perf_counter()
    faults(torch, np, jobs, bank, per_tick)
    emit("faults", step="done", seconds=time.perf_counter() - t0)

    # 13. serving: the serving twin's hour per tick and macro, its fleet
    # and env (run here, before the LM phases, beside the replay phases)
    t0 = time.perf_counter()
    profiles = serving(torch, np, jobs, bank, per_tick)
    emit("serving", step="done", seconds=time.perf_counter() - t0)

    # 14. durable: snapshots, kill and resume, the chaos loop, PPO
    # checkpoints and the invariant harness, against the runs above
    t0 = time.perf_counter()
    durable(torch, np, jobs, bank, per_tick, ppo_run, profiles)
    emit("durable", step="done", seconds=time.perf_counter() - t0)

    # 10. determinism: the same ticks twice, bitwise
    for case, ticks in DETERMINISM:
        dcfg = acceptance.config(case)
        dstatics = build_statics(dcfg, bank)
        state = load_jobs(init_state(dcfg, dstatics, seed=acceptance.SEED),
                          jobs)
        (sa, ta), (sb, tb) = [
            run_episode(dcfg, dstatics, state, ticks, acceptance.SCHEDULER,
                        summary_only=True) for _ in range(2)]
        differ = [f for f in sa._fields
                  if not torch.equal(getattr(sa, f), getattr(sb, f))]
        differ += [f"telemetry.{f}" for f in ta._fields
                   if not torch.equal(getattr(ta, f), getattr(tb, f))]
        emit("determinism", case=case, ticks=ticks, fields_differing=differ)
        if differ:
            raise AssertionError(f"{case}: runs differ in {differ}")

    # 11. serve: gemma3-1b at full width; the kernels line reports the
    # flash_attn launches of one prefill
    launches["flash_attn"] = serve(torch, np)

    # 12. serve_hybrid: the jamba hybrid at full width; the kernels line
    # reports the selective_scan launches of one 8-layer prefill
    t0 = time.perf_counter()
    launches["selective_scan"] = serve_hybrid(torch, np)
    emit("serve_hybrid", step="done", seconds=time.perf_counter() - t0)

    # each TPU kernel's row reports the entry its path launches: the fused
    # tick entries for the replay kernels (power_tick at the main path's
    # E = 1, rack_tick at the thermal hour's) and the Mamba mixer's fused
    # scan in bf16 at jamba's prefill, and beside them the TPU kernel's own
    # signature (E = 1; the scan in f32)
    sources = {
        "power_scatter": ("src/repro/kernels/node_power.py:145",
                          ("power_tick", 1, False), ("power_scatter", 1)),
        "rack_thermal": ("src/repro/kernels/rack_thermal.py:47",
                         ("rack_tick", 1), ("rack_thermal", 1)),
        "node_power": ("src/repro/kernels/node_power.py:45",
                       ("node_power", 1), None),
        "flash_attn": ("src/repro/kernels/flash_attn.py:105",
                       ("flash_attn", ATTN_REPORTED), None),
        "selective_scan": ("src/repro/kernels/mamba_scan.py:61",
                           ("mamba_scan", "bfloat16", SCAN_CASES[0][0]),
                           ("selective_scan", SCAN_CASES[0][0])),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        **{k: record[main][k] for k in keys},
        "library_ms": record[main].get("library_ms"),
        **({"signature_entry": {k: record[sig][k] for k in keys}}
           if sig else {}),
    } for name, (replaces, main, sig) in sources.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--alone"]:
        sys.exit(alone_main(*sys.argv[2:4]))
    sys.exit(main())
