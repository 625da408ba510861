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
             of three workloads at E=72 and 1152; gemma3-1b's, qwen3-4b's,
             jamba's and mixtral-8x22b's prefill attention (mixtral's
             window of 4096 wider than the sequence), and unmasked: the
             VLM's cross-attention of 2048 queries onto 1601 vision tokens
             (Sq > Sk; bf16 and f32), whisper's encoder over 1500 frames
             and its cross-attention of 448 queries onto them; jamba's
             selective scan at its 8-layer prefill and at a ragged length, the
             signature entry in f32
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
             uniform can give, card against CPU: 0 differing bits. The
             gradient rows: q, k and v's gradients through
             ``flash_attention`` (its ``autograd.Function``: the kernel
             forward, the plain version's vjp) against plain autograd at
             gemma3-1b's causal and window-512 shapes and whisper's cross
             shape, and all eight inputs' through ``mamba_scan`` at
             jamba's (f32), within GRAD_TOL, one launch (the forward)
             each. Both backwards are the same plain ops, so the rows
             check the Functions' wiring, not a kernel; forward +
             backward is timed once, at gemma3-1b's causal shape, the
             baseline of a later backward kernel.
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
             alone (both hours beside phase ``mesh``'s worlds and phase
             ``virtual_cloud``'s what-ifs, which start first); ms per
             tick, us per replica-tick, CUDA kernels per tick and the
             device's busy share at E = 1, 72 and 1152 (FLEET_TIMING ticks
             each, FLEET_PROFILE under the profiler), alone.
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
             hours through ``run_episode(macro=True)`` (each in a worker
             started beside phase ``rl`` and this phase's RL env,
             ``early_runs``) at ``PINNED_MACRO``
             (the JAX package's macro path; the event-tick count exactly
             with thermals off), integers equal to the per-tick hours of
             phases 4-5 and the largest float difference reported; one
             power_scatter (and rack_thermal) launch per tick issued;
             every host read through ``utils.device.host_read``, at most
             1 + ceil(segment / 16) a macro step, and no other sync; ms
             per simulated tick beside the per-tick hour's (kernels per
             event and per fast tick: ``profile_tick --macro``). The
             fleet hour at ``macro=True`` (72 replicas in lockstep, in a
             worker as the hours) at ``PINNED_FLEET_MACRO``, two replicas
             rerun alone (beside phases ``faults`` and ``serving``);
             ``SchedEnv(macro=True)``: ``rl_tx_gaia``'s script and one PPO
             iteration at ``PINNED_RL_MACRO``, decisions/s at 8 and
             512 environments, host reads and kernels per env step.
9. faults    the resilience twin (``acceptance.FAULT_CASES``) under
             sync-debug "error": ``replay_tx_gaia_1h_faults`` (random node
             and rack faults, checkpoints, retries) and
             ``replay_tx_gaia_1h_drill`` (a rack's maintenance window and
             an evicting brownout, thermals on) for the hour (each in a
             worker started beside phases rl and macro, ``early_runs``) at
             ``PINNED_FAULTS`` (the JAX package's per-tick values), one
             power_scatter (and on the drill one rack_thermal) launch per
             tick, ms per tick beside phase 4's; both macro-stepped (in
             workers, as the hours): bitwise equal to per tick, at the
             pinned event ticks, within the read gate, one launch per tick
             issued; the fault fleet
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
             ``serve_jamba_1l`` (one Mamba layer, f32, its numpy weights
             drawn in a worker started beside phases ``durable`` and
             ``determinism``, ``lm_pins_runs``) held to ``PINNED_JAMBA``;
             ``serve_jamba_8l`` (one whole 7:1 period, random weights from
             ``init_params`` on the card) in f32 and in bf16: the
             prefill/decode invariant (f32 within 1e-4; in bf16 the decode
             step within twice the bf16 prefill's distance from the f32
             model's answer), 7 selective_scan (the Mamba mixer's
             fused ``mamba_scan``) and 1 flash_attn launches per prefill
             and none per decode step; then ``generate`` in bf16 as in
             ``serve``.
13. serving  the serving twin (run after ``faults``): the replay hour with
             a pool of 32 inference nodes under diurnal traffic and a
             flash crowd (``replay_tx_gaia_1h_serving``) per tick (in a
             worker beside phases rl and macro) under
             sync-debug "error" at ``PINNED_SERVING`` (the JAX package's
             per-tick values), one power_scatter launch a tick, ms a tick
             beside phase 4's; macro-stepped (in a worker, as the hour):
             bitwise equal to per tick, its event and fast ticks, within
             the read gate, one launch a tick issued; the serving fleet
             (``FLEET_SERVING_E`` replicas at rising peak traffic,
             ``FLEET_SERVING_TICKS`` ticks) at
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

15. mesh     the device-sharded twin, correctness only, in worker
             processes started beside phase ``fleet``'s replicas rerun
             alone (``launch.mesh.spawn_world``; every world's ranks share
             cuda:0; three chains of worlds at once) and joined before its
             timings: (a) the fleet hour (72 replicas, 36 a rank) through
             ``run_fleet(mesh=)`` on a gloo world of 2 with a snapshot
             (``checkpoint.ckpt.save_sharded``) every 1,800 s, (b) an
             nccl world of 1 resuming the 1,800 s snapshot to the end, (c)
             the thermal fleet (600 ticks) on a gloo world of 2: every
             state and telemetry field bitwise equal to phase ``fleet``'s
             runs on every rank, one power_scatter (and rack_thermal)
             launch a tick per rank, the ticks under sync-debug "error",
             the counted host reads a rank at MESH_READS; (d)
             ``distributed_ppo_train`` on ``rl_tx_gaia`` (8
             environments, ``compress=True``, 2 iterations) on an nccl
             world of 1 and a gloo world of 2: each rank's iteration-0
             actions (kept from the training run) at ``PINNED_RL_DIST``,
             its rollout stats within 1e-5, loss stats and the second
             iteration's stats within 1e-3, a rerun bitwise, one host sync
             a chunk, and on gloo one counted read a collective (none on
             nccl); the phase's seconds, and at the end the script's.

16. virtual_cloud  the perf model's LM jobs through the twin (the
             example ``repro_torch.examples.virtual_cloud``): the workload
             (``acceptance.virtual_cloud_workload``: 32 LM jobs of four
             archs from ``perfmodel.lm_jobs_workload``, built on this host's
             numpy) at its pinned digest, then its ``baseline`` and
             ``demand response 300kW`` what-ifs (``tx_gaia(max_jobs=64,
             max_nodes_per_job=16)``) through build_statics -> init_state
             -> load_jobs -> run_episode(5400 ticks of "easy",
             summary_only) -> summary, each in a worker process started
             with phase ``fleet``'s replicas rerun alone (joined before its
             timings), the ticks under sync-debug "error": ``completed``
             exactly and the rest within 1e-5 of ``PINNED_VIRTUAL_CLOUD``,
             one power_scatter launch a tick; the ms a tick beside phase
             4's (the workers share the card and the host with phase
             ``fleet``'s, so theirs is not an alone time).

17. serve_moe  mixtral-8x22b's experts at full width (8 of d_ff 16384,
             top-2): (a) ``serve_mixtral_1l`` (one layer, f32, its 11.6 GB
             of ``seeded_numpy_params`` drawn in a worker started beside
             phases durable and determinism) held to ``PINNED_MIXTRAL``
             with the slots it dropped, 1 flash_attn launch per prefill and
             none per decode step; (b) a zero router on (4, 1024) tokens: every
             slot picks experts (0, 1), ranks in token order, exactly the
             slots past rank 1,279 drop, the routing bitwise with the
             CPU's, the dropped rows exactly 0 (after (c), through the
             first layer's f32 experts); (c) ``serve_mixtral_4l``
             (``init_params`` on the card) at capacity factor E / K
             (nothing drops) in f32 and bf16: decode against the longer
             prefill (f32 within 1e-4; bf16 reported with the routing
             choices that differ at the decoded token and their
             top-2/top-3 gaps and against SERVE_TOL, and, where none
             differ, held as ``serve_hybrid`` holds its bf16 decode: within
             twice the bf16 prefill's distance from the f32 answer), 4
             flash_attn launches per prefill and none per decode step; (d)
             ``generate`` in bf16 at the published capacity factor 1.25 as
             in ``serve``, with the slots each layer drops.

18-20. serve_xlstm, serve_whisper, serve_vlm  the last three LM families
             (``acceptance.LAST_CASES``), each: its pins in f32 (drawn and
             run in a worker beside phases durable and determinism:
             xlstm-125m whole, B 2, prompt 600; whisper-small whole, B 2,
             1500 audio frames, prompt 64; llama-3.2-vision-11b cut to 5
             layers with ``xgate`` opened, B 1, prompt 1632 over 1601
             vision tokens) held to ``PINNED_CASES``, argmax equal, the
             flash_attn launches per prefill (0, 36, 6) and none per decode
             step; xlstm-125m's bf16 prefill on the pinned weights, its
             distance from the f32 one reported; the path model (the VLM cut to 10 layers;
             ``init_params`` on the card) in f32 and bf16: the
             prefill/decode invariant (f32 within 1e-4; bf16 within
             SERVE_TOL, or else as ``serve_hybrid`` holds it), the
             launches per prefill and decode step; CUDA kernels, device ms
             and busy share of a profiled bf16 prefill and decode step;
             ``generate`` in bf16 at B 4, prompt 1024 (the VLM's 2048), 32
             tokens, with the memory, as in ``serve``.

21. train    gemma3-1b at full width trained on the card: three pinned
             f32 steps (``acceptance.PINNED_TRAIN``: B 2, 1024 tokens,
             AdamW on ``cosine_warmup``, remat "block"; drawn and run in a
             worker beside phases durable and determinism) with 26 + 24
             flash_attn launches a step (the forward's, then remat's
             recompute of the body; the kernels' backward launches none);
             then in bf16 with f32 masters (``init_params`` on the card,
             B 4): the launches of a forward and its backward with remat
             on and off; the loss, the gradients' global norm and four
             leaves' gradients within TRAIN_BF16_*_TOL of the f32
             model's on the same masters and batch (the first step's loss
             and norm too), and two faults planted in the attention
             failing that gate; TRAIN_BF16_STEPS steps timed (ms a step,
             tokens/s, peak memory) and one profiled (CUDA kernels, the
             device's busy share).

22. train_mesh  the training case of phase train cut to its first 8
             layers (``PINNED_TRAIN_MESH``: gemma3-1b at full width, f32,
             B 2, 1024 tokens, 3 AdamW steps) through ``launch.train``'s
             mesh path in ``spawn_world`` ranks on cuda:0: gloo (1, 2)
             (tensor parallel: 2 local q heads, the one KV head whole),
             gloo (2, 1) (FSDP), nccl (1, 1); each world within
             ``TRAIN_TOLS`` on every rank, 8 + 6 flash_attn launches a
             step on every rank; the (1, 2) world's state saved and
             restored onto (2, 1) and (1, 1), each bit for bit; on (1, 1)
             the bf16 step timed at full depth beside phase train's (ms,
             CUDA kernels, busy share, peak memory, collectives and their
             bytes). One worker (``train_mesh_run``) started after phase
             thermal and joined before phase durable; checked after
             phase train.

23. train_mesh_families  the other families trained at full width on a
             gloo world of 2 ranks sharing cuda:0, mesh (1, 2), Adafactor,
             f32, B 2, 1024 tokens, 3 steps (``acceptance.
             TRAIN_FAMILY_LEAVES``): mixtral-8x22b cut to 1 layer (expert
             parallelism: 4 experts a rank; 24 local q heads), jamba cut
             to its first layer, a Mamba mixer with the dense MLP (the
             scan on 8,192 local channels), whisper-small whole (the
             encoder and the cross-attentions on 6 local heads); each
             within ``TRAIN_TOLS`` of ``PINNED_TRAIN_FAMILIES`` on both
             ranks, ``train_launches`` flash_attn and selective_scan
             launches a step on each rank (weights, wall seconds, staged
             all-gathers and their bytes, peak memory by rank); a DTensor
             handed to either kernel's wrapper raises. One worker
             (``train_families_draw``) started with phase train_mesh's
             draws the weights on the host; the cases run in phase
             train_mesh's gloo world after its meshes
             (``train_families_cases``); checked after phase
             train_mesh.
24. serve_mesh  gemma3-1b at full width served on a gloo world of 2 ranks
             sharing cuda:0, mesh (1, 2), f32, the ``PINNED_LM`` case (B 2,
             prompt 1024, 8 decode steps) under ``decode_kv_shard="seq"``:
             the weights laid out by ``param_pspecs`` (the model axis
             splits the 4 q heads; Kv 1 whole), the cache's sequence split
             over the model axis, so every decode step is the distributed
             flash-decode (``layers.decode_attention_mesh``). Both ranks'
             logits at ``PINNED_LM`` by ``check_lm`` within LM_F32_TOL, 26
             flash_attn launches in each rank's prefill (its 2 local heads)
             and none in a decode step, the cache's layout kept after every
             step; the bf16 decode ms a token on (1, 2) after a prefill at
             B SERVE_BATCH, prompt SERVE_PROMPT, reported beside phase
             serve's one-card figure (not a gate), with the seconds and
             peak GB a rank. One worker (``serve_mesh_run``) started with
             phase train_mesh's, joined after phase serve.
25. dryrun   ``launch/dryrun.py`` on the card's host (its torch), no device
             work: gemma3-1b on the four shapes on ``single`` (256 fake
             ranks) with the layer-delta probes, mixtral-8x22b
             ``train_4k`` on ``single`` (experts parallel over 16) and
             gemma3-1b ``train_4k`` on ``multi`` (512 ranks); every cell
             ``OK``, its analytic fields at
             ``acceptance.PINNED_DRYRUN_FIELDS`` and, where the JAX
             dry-run's record is pinned, its argument bytes; one line a
             cell (FLOPs, collective bytes a device, argument GiB, the
             trace's seconds). One host-only worker (``dryrun_run``)
             started with phase serve_mesh's, joined after phase serve.

Replicas rerun alone (phases ``fleet``, ``macro``, ``faults``,
``serving``, and the fleet of ``durable``) and phase ``virtual_cloud``'s
what-ifs each run in a worker process of their own on the card
(``run_alone``: this script with ``--alone``, ALONE_WORKERS at once), so
the checks of a phase run together; the parent waits for all of them and
stops any that fails. The per-tick hours of phases ``faults`` and
``serving`` and the macro-stepped hours of phases ``macro``, ``faults`` and
``serving`` run in workers started after phase ``virtual_cloud``
(``early_runs``, ``start_alone``), beside phase ``rl`` and phase
``macro``'s RL env, and are joined before the macro phase's hours are
checked. The pins of phases ``serve_hybrid``, ``serve_moe``, ``serve_xlstm``,
``serve_whisper`` and ``serve_vlm`` and phase ``train``'s pinned steps run
in workers started after phase ``durable``'s alone hour (``lm_pins_runs``)
and are joined before phase ``serve``. Each line carries ``script_s``, the
seconds since the script started.

The launch counts are set to 0 just before each path and read just after.
Then the ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. It needs no network, and exits non-zero
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import atexit
import dataclasses
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
TIMING_REPS = 25               # timed batches (median over these)
TIMING_BATCH = 20              # back-to-back calls per timed batch
DETERMINISM = (("replay_tx_gaia_1h", 300),
               ("replay_tx_gaia_1h_thermal_stress", 450))
THERMAL_CASES = ("replay_tx_gaia_1h_thermal",
                 "replay_tx_gaia_1h_thermal_stress")
INF_CLOCKS = {"next_fail_t", "rack_fail_t", "srv_retry_t", "srv_wake_t"}
# flash_attn at gemma3-1b's prefill (B 4, S 1024, H 4, Kv 1, hd 256),
# qwen3-4b's GQA (H 32, Kv 8, hd 128), jamba's (H 64) and mixtral's (H 48,
# its window of 4096 wider than the sequence); then without a mask: the
# VLM's cross-attention of a 2048-token prompt onto its 1601 vision tokens
# (Sq > Sk, in bf16 and f32), whisper's encoder over its 1500 frames and
# its decoder's cross-attention of a 448-token prompt onto them: (name,
# dtype, b, sq, sk, h, kv, hd, causal, window, tolerance (atol = rtol))
ATTN_CASES = (
    ("gemma3-1b causal", "bfloat16", 4, 1024, 1024, 4, 1, 256, True, 0,
     2e-2),
    ("gemma3-1b window 512", "bfloat16", 4, 1024, 1024, 4, 1, 256, True, 512,
     2e-2),
    ("gemma3-1b causal f32", "float32", 4, 1024, 1024, 4, 1, 256, True, 0,
     2e-5),
    ("qwen3-4b causal", "bfloat16", 4, 1024, 1024, 32, 8, 128, True, 0, 2e-2),
    ("jamba causal", "bfloat16", 4, 1024, 1024, 64, 8, 128, True, 0, 2e-2),
    ("mixtral window 4096", "bfloat16", 4, 1024, 1024, 48, 8, 128, True,
     4096, 2e-2),
    ("VLM cross", "bfloat16", 4, 2048, 1601, 32, 8, 128, False, 0, 2e-2),
    ("VLM cross f32", "float32", 4, 2048, 1601, 32, 8, 128, False, 0, 2e-5),
    ("whisper encoder", "bfloat16", 4, 1500, 1500, 12, 12, 64, False, 0,
     2e-2),
    ("whisper cross", "bfloat16", 4, 448, 1500, 12, 12, 64, False, 0, 2e-2),
    ("ragged 67", "bfloat16", 4, 2048, 67, 32, 8, 128, False, 0, 2e-2),
)
# The unmasked bf16 rows are also held to the norm-relative error
# ||got - want|| / ||want|| (over the whole output) within ATTN_NORM_TOL.
# Their outputs average hundreds of N(0, 1) values (std ~0.04 at Sk 1601),
# so atol 2e-2 alone would pass a kernel that let the zero keys TMA puts
# past Sk into the softmax: at Sk 1601 (63 such keys in the last 128-key
# stage) they shrink every output by ~2.3%, a max error near 5e-3.
# "ragged 67" (61 of the stage's 128 keys past Sk) would shrink it by a
# third.
ATTN_NORM_TOL = 5e-3
ATTN_REPORTED = "gemma3-1b window 512"   # 22 of gemma3-1b's 26 layers
MIXTRAL_ATTN = "mixtral window 4096"     # every serve_mixtral_4l layer
# the unmasked cases: the last three families' paths, and a last tile
# mostly past Sk
NEW_ATTN = ("VLM cross", "VLM cross f32", "whisper encoder", "whisper cross",
            "ragged 67")
ATTN_TIMING = (10, 5)                    # timed batches, calls per batch
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_RUNS = 4, 1024, 32, 3
SERVE_TOL = 2e-2     # bf16 prefill/decode invariant (tests/test_prefill_decode.py)
# phases serve_xlstm, serve_whisper, serve_vlm: the prompt of the path
# model's invariant and of ``generate`` (the VLM's longer than its 1601
# vision tokens), the prompt of the profiled prefill where shorter (the
# xLSTM prefill's sLSTM loop launches ~20 kernels a step and layer, and the
# profiler's processing grows with the kernels) and the decode steps
# profiled
LAST_PROMPT = {"serve_xlstm": 1024, "serve_whisper": 1024, "serve_vlm": 2048}
LAST_PROFILE_PROMPT = {"serve_xlstm": 256}
LAST_PROFILE_STEPS = 4
# the pinned cases whose worker also runs a bf16 prefill on the pinned
# weights: its distance from the f32 one stands beside the JAX package's
# on the same weights (``tests/torch_bf16_distance.py``, on the CPU)
BF16_PIN_CASES = ("serve_xlstm",)
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
# 3.5x; subtler faults are the f32 invariant's to find. serve_mixtral_4l's
# bf16 decode step is held the same way where its routing agrees with the
# longer prefill's (on the card its logits, of order 1-4, parted from the
# longer bf16 prefill by 0.039 with no routing choice differing); at the
# reduced widths on the CPU a zeroed k or v cache in its first layer moves
# it 88x and 75x the bf16 prefill's distance off (``tests/
# test_torch_moe.py``).
HYBRID_TOL = 1e-4
BF16_DECODE_FACTOR = 2.0
# phase kernel's gradient rows: the kernels' autograd Functions (kernel
# forward, the plain version's vjp as the backward) against plain autograd
# through the plain versions on the card, at the training path's attention
# shapes (ATTN_CASES' names) and jamba's scan (f32: name, ba, s, di, ds).
# Both backwards are the same PyTorch ops on the same inputs, so they are
# expected bit for bit; held to GRAD_TOL (atol = rtol). What they check is
# the Functions' wiring (the forward's one launch, gradients reaching
# every input), not a kernel: neither backward reads the kernel's output.
# Forward + backward is timed only at GRAD_TIMED, the training path's
# shape, as the baseline of a later backward kernel.
GRAD_ATTN_CASES = ("gemma3-1b causal", "gemma3-1b window 512",
                   "whisper cross")
GRAD_TIMED = "gemma3-1b causal"
GRAD_SCAN_CASE = ("jamba prefill", 2, 1024, 16384, 16)
GRAD_TOL = 1e-5
GRAD_KEYS = ("max_abs_err", "tol", "bitwise", "ms")
GRAD_TIMING = (5, 2)          # timed batches, calls per batch (attention)
GRAD_BACKWARD = ("plain vjp (the plain version recomputed and "
                 "differentiated); the gradient rows check the Function's "
                 "wiring and cannot reach a kernel")
# phase train: gemma3-1b at full width trained on the card. The pinned f32
# steps (``acceptance.PINNED_TRAIN``) run in a worker beside phases durable
# and determinism (with the LM pins); the bf16 steps (f32 masters, the
# cast inside autograd) at TRAIN_BF16_BATCH x acceptance.TRAIN_SEQ run
# alone: TRAIN_BF16_WARMUP steps, TRAIN_BF16_STEPS timed, one profiled.
# The bf16 model is held to the f32 model on the same masters and the
# first batch, before any update: the loss within TRAIN_BF16_LOSS_TOL
# (absolute), the gradients' global norm (the first step's, and that of
# the gradients of a forward and backward outside the step) within
# TRAIN_BF16_NORM_TOL (relative), and the gradients of acceptance's
# TRAIN_LEAVES (the embedding, a body wq, a body and a tail norm) within
# TRAIN_BF16_LEAF_TOL (||g16 - g32|| / ||g32||). At init the loss sits
# 3.3e-3 from uniform logits' ln(vocab), so a loss gate alone passes a
# forward that outputs nothing useful; the gradients are what a broken
# forward or a lost gradient moves. Each limit lies between the sound
# reading on the card and the readings of TRAIN_BF16_FAULTS, faults
# planted in the bf16 forward (every layer's attention without its
# window; the attention's output cut from autograd, as a kernel output
# without its Function would be), and every run shows the planted faults
# failing the gate. On an H100 (700 W) the sound bf16 model read: loss
# 4.39e-5, norm 1.54e-2 to 1.57e-2, leaves 1.27e-2 to 4.55e-2 (the
# embedding's); the window dropped: loss 1.55e-3, norm 8.9e-4, leaves
# 0.18 to 0.24; the attention detached: loss 4.39e-5, norm 0.53, leaves
# 0.88 to 1. Each limit sits near the geometric mean of the sound
# reading and the nearest fault's.
TRAIN_BF16_BATCH, TRAIN_BF16_WARMUP, TRAIN_BF16_STEPS = 4, 2, 5
TRAIN_BF16_LOSS_TOL = 2e-4
TRAIN_BF16_NORM_TOL = 1e-1
TRAIN_BF16_LEAF_TOL = 1e-1
TRAIN_BF16_FAULTS = ("window dropped", "attention detached")
# phase train_mesh: the training case of phase train cut to
# acceptance.TRAIN_MESH_LAYERS layers (PINNED_TRAIN_MESH: f32, B 2, 1,024
# tokens, 3 AdamW steps, the weights drawn once) through
# ``launch.train``'s mesh path in ``spawn_world`` ranks on cuda:0: a gloo
# world of 2 trains on (1, 2), tensor parallel with 2 local q heads and
# the one KV head whole, then on (2, 1), FSDP; an nccl world of 1 on (1,
# 1). The first mesh's state is saved and restored onto the others.
# The nccl world then times TRAIN_MESH_BF16 = (warm-up, timed) bf16 steps
# of the whole model at TRAIN_BF16_BATCH on its (1, 1) mesh, one more
# under the profiler and one under ``CommDebugMode``. All in one worker
# (``start_alone``) beside TRAIN_MESH_BESIDE, joined before phase durable
# (whose LM pins' workers need the card's memory); the gloo world then
# runs phase train_mesh_families' cases.
TRAIN_MESH_WORLDS = (("gloo", ((1, 2), (2, 1))), ("nccl", ((1, 1),)))
TRAIN_MESH_BF16 = (1, 3)
TRAIN_MESH_TIMEOUT_S = 1100     # the worker (472 s alone on an H100,
#                                 before phase train_mesh_families' cases)
TRAIN_MESH_BESIDE = ("phases virtual_cloud, fleet, mesh, rl, macro, faults "
                     "and serving")
# phase serve_mesh: gemma3-1b at full width on a gloo world of 2 ranks
# sharing cuda:0, mesh (1, 2), the decode cache's sequence split over the
# model axis; bf16 decode steps timed after one warm-up step. Its worker
# starts with phase train_mesh's and is joined after phase serve; phase
# dryrun's host-only worker likewise.
SERVE_MESH_KV = "seq"
SERVE_MESH_STEPS = 8
SERVE_MESH_TIMEOUT_S = 900
SERVE_MESH_BESIDE = TRAIN_MESH_BESIDE + ", beside phase train_mesh's worker"
DRYRUN_TIMEOUT_S = 900
# phase train_mesh_families: the other families trained at full width on
# a gloo world of 2 ranks sharing cuda:0, mesh (1, 2) (the model axis of
# 2), Adafactor: each case of TRAIN_FAMILIES_ORDER (``train_mixtral_1l``:
# 4 experts a rank, 24 local q heads and 4 KV heads; ``train_jamba_1l``:
# the Mamba scan on 8,192 local channels a rank; ``train_whisper``: the
# encoder and the cross-attentions on 6 local heads) held to
# PINNED_TRAIN_FAMILIES, the kernels' launches a step counted on each
# rank (``train_launches``), then a DTensor handed to each kernel's
# wrapper refused. The cases run in phase train_mesh's gloo world, on its
# two ranks, after that phase's own meshes: beside that phase's worker
# the card has no room for two ranks of mixtral. Their weights are drawn
# meanwhile by a worker of their own on the host, started after phase
# thermal, and written under TRAIN_FAMILIES_WORK; TRAIN_FAMILIES_READY
# marks them written.
TRAIN_FAMILIES_MESH = (1, 2)
TRAIN_FAMILIES_ORDER = ("train_mixtral_1l", "train_jamba_1l",
                        "train_whisper")
TRAIN_FAMILIES_WORK = ROOT / "build" / "train_mesh_families"
TRAIN_FAMILIES_READY = TRAIN_FAMILIES_WORK / "ready"
# the fleet phase's hours run beside these workers
BESIDE_GRID = "phase mesh's worlds and phase virtual_cloud's what-ifs"
# the fleet phase: replicas timed (1, the grid, the grid tiled 16x), ticks
# timed at each, and (start tick, ticks) of each profile
FLEET_SIZES = (1, 72, 1152)
FLEET_TIMING = 100
FLEET_PROFILE = (100, 5)
# the rl phase: environments timed, decisions per timed rollout
RL_SCALE_ENVS = (8, 64, 512)
RL_SCALE_STEPS = 4
RL_PROFILE_STEPS = 1   # decisions of the rollout under the profiler
# the macro phase: the engine's chunk of fast ticks a host read (its
# default), the fleet replicas rerun alone, and the environments timed
MACRO_CHUNK = 16
MACRO_FLEET_ALONE = (8, 71)
MACRO_FLEET = "replay_tx_gaia_1h_fleet_macro"   # its worker run's name
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
# the per-tick hours of phases faults and serving and the macro-stepped
# hours of phases macro, faults and serving run in workers started after
# phase virtual_cloud, beside these
EARLY_BESIDE = "phases rl and macro"
# the pins of the LM phases serve_hybrid to serve_vlm (their numpy weights
# drawn in the worker) run in workers started after phase durable's alone
# hour, beside these
LM_PINS_BESIDE = "phases durable and determinism"
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
# the mesh phase (correctness only; its worlds run beside phase fleet's
# alone workers): the fleet hour sharded over a gloo world of 2 on the
# card with a snapshot every MESH_SNAP_S, resumed from the 1,800 s one on
# an nccl world of 1; the thermal fleet at 2; distributed PPO at 1 (nccl)
# and 2 (gloo)
MESH_SNAP_S = 1800.0
# counted host reads a rank of phase mesh's fleet worlds: the fingerprint
# and a snapshot are one each, gloo's gather after the ticks one (its
# leaves drained together), nccl's none
MESH_READS = {"hour": 1 + 2 + 1, "thermal": 1, "resume": 1 + 1}
MESH_TIMEOUT_S = 900
MESH_DIR = ROOT / "build" / "mesh" / "smoke"


def card_memory(torch) -> dict:
    """GB the caching allocator holds for live tensors now and reserves,
    after a garbage collection (a cycle may hold tensors until one), and
    the largest live tensors on the card where over 1 GB is held."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
           "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    if out["allocated_gb"] > 1.0:
        live = [o for o in gc.get_objects()
                if isinstance(o, torch.Tensor) and o.is_cuda]
        out["largest"] = sorted(
            ([t.numel() * t.element_size() / 1e9, list(t.shape),
              str(t.dtype)] for t in live), reverse=True)[:8]
    return out


T_START = time.perf_counter()   # the script's clock: each line's ``script_s``


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "script_s": time.perf_counter() - T_START}), flush=True)


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


def check_attention(torch, np, name, dtype, b, sq, sk, h, kv, hd, causal,
                    window, tol) -> dict:
    """flash_attn against ``attention_torch`` on the card at one shape:
    within ``tol`` (atol = rtol), unmasked bf16 also within ATTN_NORM_TOL
    of it in norm, two calls bitwise equal; timed beside the plain
    version, the bound and ``scaled_dot_product_attention``."""
    from repro_torch.kernels import flash_attn as pfa

    rng = np.random.default_rng(hd + h)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device="cuda").to(dt)
               for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                             (b, sk, kv, hd)))
    got = pfa.flash_attention(q, k, v, causal=causal, window=window)
    again = pfa.flash_attention(q, k, v, causal=causal, window=window)
    want = pfa.attention_torch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attn {name}: two calls differ")
    diff = got.float() - want.float()
    abs_err = float(diff.abs().max())
    norm_err = float(diff.norm() / want.float().norm())
    norm_tol = (ATTN_NORM_TOL if dt == torch.bfloat16 and not causal
                and not window else None)
    torch.testing.assert_close(
        got.float(), want.float(), atol=tol, rtol=tol,
        msg=lambda m: f"flash_attn {name} (norm error {norm_err}): {m}")
    if norm_tol is not None and not norm_err <= norm_tol:
        raise AssertionError(f"flash_attn {name}: norm-relative error "
                             f"{norm_err} over {norm_tol} (max abs error "
                             f"{abs_err})")

    # yardstick: one PyTorch call of the same function (never used by the
    # port), on (B, H, S, hd) views of the same tensors
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if 0 < window < sq:   # a window as wide as the sequence is causal
        pos = torch.arange(sq, device="cuda")
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
    in_out = elem * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
    flops = 4 * b * h * hd * attention_pairs(np, sq, sk, causal, window)
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
    emit("kernel", name="flash_attn", case=name, dtype=dtype, batch=b,
         seq=sq, keys=sk, heads=h, kv_heads=kv, head_dim=hd, causal=causal,
         window=window, tol=tol, norm_rel_err=norm_err, norm_tol=norm_tol,
         gflop=flops / 1e9,
         library_max_abs_err=lib_err, **rec)
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


def _grads(torch, fn, inputs, outs_grad):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple) at output
    gradients ``outs_grad``, for every input."""
    ins = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ins, outs_grad)


def _grad_record(torch, name, got, want, **fields) -> dict:
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=GRAD_TOL, atol=GRAD_TOL,
            msg=lambda m, i=i: f"{name} gradient [{i}]: {m}")
    return dict(max_abs_err=err, tol=GRAD_TOL, bitwise=bitwise, **fields)


def check_attention_grad(torch, np, name, dtype, b, sq, sk, h, kv, hd,
                         causal, window, tol) -> dict:
    """The gradients of q, k, v through ``flash_attention`` on the card
    (``FlashAttention``: the kernel forward, the vjp of ``attention_torch``
    as the backward) against plain autograd through ``attention_torch``,
    at one ATTN_CASES shape; the backward launches no kernel. At
    GRAD_TIMED, forward and backward timed together."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attn as pfa

    rng = np.random.default_rng(hd + h + 1)
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.tensor(rng.normal(size=shape).astype(np.float32),
                               device="cuda").to(dt)
                  for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                                (b, sk, kv, hd), (b, sq, h, hd)))
    mask = dict(causal=causal, window=window)

    def fused(*a):
        return pfa.flash_attention(*a, **mask)

    def plain(*a):
        return pfa.attention_torch(*a, **mask)

    kernels.reset_launches()
    got = _grads(torch, fused, (q, k, v), (g,))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = _grads(torch, plain, (q, k, v), (g,))
    if launches != no_launches(flash_attn=1):
        raise AssertionError(f"flash_attn gradient {name}: launches "
                             f"{launches} (expected one forward)")
    timed = {}
    if name == GRAD_TIMED:
        timed["ms"] = time_ms(torch, lambda: _grads(torch, fused, (q, k, v),
                                                    (g,)), *GRAD_TIMING)
    rec = _grad_record(torch, f"flash_attn {name}", got, want, **timed)
    emit("kernel", name="flash_attn", gradient=True, case=name, dtype=dtype,
         batch=b, seq=sq, keys=sk, heads=h, kv_heads=kv, head_dim=hd,
         causal=causal, window=window, forward_launches=launches, **rec)
    return rec


def check_scan_grad(torch, np, name, ba, s, di, ds) -> dict:
    """The gradients of all eight inputs of ``mamba_scan`` on the card
    (``MambaScan``: the fused kernel forward, the vjp of
    ``mamba_scan_torch`` as the backward), in f32, against plain autograd
    through ``mamba_scan_torch``, inputs laid out as the mixer passes
    them; both outputs' gradients random. Untimed: no training path on
    the card runs a Mamba layer."""
    from repro_torch import kernels
    from repro_torch.kernels import selective_scan as pss

    rng = np.random.default_rng(s + ds + 2)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device="cuda")

    xz = t(rng.standard_normal((ba, s, 2 * di), np.float32))
    proj = t(rng.standard_normal((ba, s, MAMBA_DT_RANK + 2 * ds),
                                 np.float32))
    A = t(-np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                           (di, ds)))
    a = (t(rng.standard_normal((ba, s, di), np.float32)),
         t(rng.normal(0.0, 0.5, (ba, s, di))), t(rng.uniform(-6.9, -2.3, di)),
         A, proj[..., MAMBA_DT_RANK:MAMBA_DT_RANK + ds],
         proj[..., MAMBA_DT_RANK + ds:], xz[..., di:],
         t(rng.standard_normal(di, np.float32)))
    g = (t(rng.standard_normal((ba, s, di), np.float32)),
         t(rng.standard_normal((ba, di, ds), np.float32)))
    kernels.reset_launches()
    got = _grads(torch, pss.mamba_scan, a, g)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = _grads(torch, pss.mamba_scan_torch, a, g)
    if launches != no_launches(selective_scan=1):
        raise AssertionError(f"mamba_scan gradient {name}: launches "
                             f"{launches} (expected one forward)")
    rec = _grad_record(torch, f"mamba_scan {name}", got, want)
    emit("kernel", name="selective_scan", entry="mamba_scan", gradient=True,
         case=name, dtype="float32", batch=ba, seq=s, d_inner=di, d_state=ds,
         forward_launches=launches, **rec)
    return rec


def _counted(torch, fn):
    """``fn()``, synchronised, and the kernel launches it made."""
    from repro_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


def _on_card(torch, memory: dict) -> dict:
    return {k: torch.tensor(v, device="cuda") for k, v in memory.items()}


def path_launches(cfg) -> dict:
    """The kernel launches of one prefill of ``cfg``: one flash_attn per
    attention call (``spec.attention_calls``), one selective_scan per
    Mamba layer."""
    from repro_torch.configs.base import MAMBA
    from repro_torch.models import spec as S

    n_mamba = sum(S.layer_kind_at(cfg, i) == MAMBA
                  for i in range(cfg.n_layers))
    return no_launches(flash_attn=S.attention_calls(cfg),
                       selective_scan=n_mamba)


def lm_case_pins(torch, case: str) -> dict:
    """Worker entry (``start_alone``, ``entry="lm_case_pins"``) of a serve
    phase's pins: the pinned case (``acceptance.lm_case``) in f32 on the
    card, its numpy weights and memory drawn here
    (``acceptance.lm_case_inputs``), the prefill and the decode steps with
    their launches counted and an MoE model's dropped slots recorded. For
    the cases of BF16_PIN_CASES, also the bf16 prefill's distance from the
    f32 one on the same weights. Returns ``lm_summary``, the launches, the
    seconds, the peak memory and whether every logit is finite."""
    from repro_torch.configs import acceptance as A
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.moe import record_routing

    t0 = time.perf_counter()
    cfg, tree, toks, memory = A.lm_case_inputs(case)
    _, _, S, N, _ = A.lm_case(case)
    weights_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = lm_params_from_numpy(tree, cfg, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if case not in BF16_PIN_CASES:
        del tree
    toks = torch.tensor(toks, device="cuda")
    extras = _on_card(torch, memory)
    out, dropped = [], []

    def run(fn):
        with record_routing() as rec:
            logits, cache = fn()
        out.append(logits)
        dropped.append([(~r.keep).sum() for r in rec])
        return cache

    t0 = time.perf_counter()
    cache, per_prefill = _counted(torch, lambda: run(lambda: prefill(
        model, toks[:, :S], cache_seq_len=S + N, extras=extras)))

    def decode_all(cache):
        for i in range(N):
            cache = run(lambda: decode_step(model, cache,
                                            toks[:, S + i:S + i + 1], S + i))

    _, per_decode = _counted(torch, lambda: decode_all(cache))
    run_s = time.perf_counter() - t0
    res = {"summary": A.lm_summary(
               [x.cpu().numpy() for x in out],
               [[int(c) for c in step] for step in dropped]
               if cfg.moe.n_experts else None),
           "finite": all(bool(torch.isfinite(x).all()) for x in out),
           "params": cfg.param_count(), "weights_s": weights_s,
           "load_s": load_s, "run_s": run_s,
           "launches_per_prefill": per_prefill,
           "launches_in_decode": per_decode,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if case in BF16_PIN_CASES:
        del model, cache
        m16 = lm_params_from_numpy(
            tree, dataclasses.replace(cfg, dtype="bfloat16"), "cuda")
        del tree
        got, _ = prefill(m16, toks[:, :S], cache_seq_len=S, extras=extras)
        res["bf16_prefill_vs_f32_max_abs"] = float(
            (got - out[0]).abs().max())
    return res


def train_launches(cfg, remat: str = "block") -> dict:
    """The kernel launches of one training step (on each rank of a mesh):
    those of a forward (``path_launches``: a flash_attn per attention
    call, a selective_scan per Mamba layer), and again the body's when
    remat recomputes it in the backward pass (the tail is never
    recomputed; an encoder's layers are, with the body); the kernels'
    backward is the plain version's vjp and launches nothing."""
    from repro_torch.models import spec as S

    period, R, _ = S.layout(cfg)
    forward = path_launches(cfg)
    body = path_launches(dataclasses.replace(cfg, n_layers=R * period))
    if remat == "none":
        return forward
    return {k: forward[k] + body[k] for k in forward}


def train_pins(torch) -> dict:
    """Worker entry (``start_alone``, ``entry="train_pins"``) of phase
    train's pinned f32 steps: ``acceptance.run_train`` of the training
    case on the card, its numpy weights drawn here. Returns the summary,
    the launches and seconds of each step and the peak memory."""
    from repro_torch.configs import acceptance as A
    from repro_torch.models import seeded_numpy_params

    t0 = time.perf_counter()
    cfg = A.train_config()
    tree = seeded_numpy_params(cfg, A.LM_SEED)
    weights_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary, launches, step_s = A.run_train(cfg, tree, "cuda")
    return {"summary": summary, "launches_per_step": launches,
            "params": cfg.param_count(), "weights_s": weights_s,
            "run_s": time.perf_counter() - t0, "step_s": step_s,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_lm_pins(phase: str, case: str, pins: dict) -> None:
    """A serve phase's pins (run in a worker: ``pins``) against
    ``acceptance.PINNED_CASES[case]`` in f32, every logit finite, and the
    launches: ``path_launches`` per prefill, none in the decode steps."""
    from repro_torch.configs import acceptance as A

    report = A.check_lm(pins["summary"], "float32",
                        pins=A.PINNED_CASES[case], case=case)
    per_prefill, per_decode = (pins["launches_per_prefill"],
                               pins["launches_in_decode"])
    emit(phase, step="pins", case=case, in_worker_beside=LM_PINS_BESIDE,
         **{k: pins[k] for k in ("params", "weights_s", "load_s", "run_s",
                                 "max_memory_gb",
                                 "bf16_prefill_vs_f32_max_abs") if k in pins},
         launches_per_prefill=per_prefill, launches_in_decode=per_decode,
         **report)
    if not pins["finite"]:
        raise AssertionError(f"{case}: non-finite logits")
    want = path_launches(A.lm_case(case)[0])
    if per_prefill != want or per_decode != no_launches():
        raise AssertionError(f"{case}: launches {per_prefill} per prefill, "
                             f"{per_decode} in the decode steps (expected "
                             f"{want}, then none)")


def serve_invariant(torch, phase: str, case: str, cfg_of, tree, prompt,
                    extras=None, routing: bool = False,
                    serve_tol_suffices: bool = False, **labels):
    """A serve phase's prefill/decode invariant on its path model, in f32
    and then bf16 (``DecoderLM.from_tree(cfg_of(dtype), tree)``; the f32
    model is freed before the bf16 one is made): prefill S (``prompt``
    less its last token) then decode token S, against a prefill of S + 1;
    launches counted, ``path_launches`` per prefill and none per decode
    step. f32 within HYBRID_TOL. The bf16 decode step within
    BF16_DECODE_FACTOR x the bf16 prefill's own distance from the f32
    answer; or, with ``serve_tol_suffices``, within SERVE_TOL of the bf16
    prefill. With ``routing`` (an MoE model): no slot dropped, and the bf16
    gate excused where an MoE layer picks other experts for the decoded
    token than the longer prefill did. Returns the bf16 model and its
    launches per prefill."""
    import contextlib

    from repro_torch.models import DecoderLM
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.moe import record_routing

    S = prompt.shape[1] - 1
    record = record_routing if routing else contextlib.nullcontext
    truth = None     # the f32 model's logits of the longer prefill
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_of(dtype)
        model = DecoderLM.from_tree(cfg, tree)
        t0 = time.perf_counter()
        with record() as long_rec:
            want, _ = prefill(model, prompt, cache_seq_len=S + 1,
                              extras=extras)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        (_, cache), per_prefill = _counted(torch, lambda: prefill(
            model, prompt[:, :S], cache_seq_len=S + 1, extras=extras))
        with record() as dec_rec:
            (got, _), per_decode = _counted(
                torch, lambda: decode_step(model, cache, prompt[:, S:], S))
        err = float((got - want).abs().max())
        fields = {}
        if routing:
            fields = dict(_last_token_routing(long_rec, dec_rec, S),
                          dropped=[int((~r.keep).sum())
                                   for r in long_rec + dec_rec])
        if dtype == "float32":
            truth = want
            limit = dict(tol=HYBRID_TOL)
        else:
            prefill_off = float((want - truth).abs().max())
            limit = dict(
                serve_tol=SERVE_TOL, below_serve_tol=err <= SERVE_TOL,
                decode_vs_f32_max_abs=float((got - truth).abs().max()),
                prefill_vs_f32_max_abs=prefill_off,
                limit=BF16_DECODE_FACTOR * prefill_off)
        emit(phase, step="prefill_decode_invariant", case=case, dtype=dtype,
             batch=prompt.shape[0], prompt=S, **labels, max_abs_err=err,
             **limit, argmax_agree_share=float(
                 (got.argmax(-1) == want.argmax(-1)).float().mean()),
             **fields, prefill_s=prefill_s, launches_per_prefill=per_prefill,
             launches_per_decode_step=per_decode)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{case} ({dtype}): non-finite logits")
        if routing and any(fields["dropped"]):
            raise AssertionError(f"{case} ({dtype}): slots dropped: "
                                 f"{fields['dropped']}")
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=HYBRID_TOL,
                                       rtol=HYBRID_TOL)
        elif not (limit["decode_vs_f32_max_abs"] <= limit["limit"]
                  or (serve_tol_suffices and limit["below_serve_tol"])
                  or (routing and fields["routing_differs"])):
            raise AssertionError(
                f"{case} (bf16): the decode step is {err} off the longer "
                f"prefill and {limit['decode_vs_f32_max_abs']} off the f32 "
                f"answer, over {BF16_DECODE_FACTOR} x the bf16 prefill's "
                f"{prefill_off}")
        want_launches = path_launches(cfg)
        if per_prefill != want_launches or per_decode != no_launches():
            raise AssertionError(
                f"{case} ({dtype}): launches {per_prefill} per prefill and "
                f"{per_decode} per decode step (expected {want_launches} "
                "and none)")
        if dtype == "float32":
            del model, cache, got, want, long_rec, dec_rec
            torch.cuda.empty_cache()
    return model, per_prefill


def serve_hybrid(torch, np, pins: dict) -> int:
    """The jamba hybrid without experts at full width on the card:
    ``serve_jamba_1l`` in f32 against ``PINNED_JAMBA`` (run in a worker:
    ``pins``); ``serve_jamba_8l``'s prefill/decode invariant in f32 and
    bf16 (``serve_invariant``), then timed ``generate`` runs in bf16 under
    sync-debug "error". Returns the selective_scan launches of one 8-layer
    prefill."""
    from repro_torch.configs import acceptance as A
    from repro_torch.models import init_params

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    check_lm_pins("serve_hybrid", A.JAMBA_CASE, pins)

    # serve_jamba_8l: one whole 7:1 period, f32 masters made on the card
    n_layers = A.JAMBA_PATH_LAYERS
    cfg = A.jamba_config(n_layers, "float32")
    t0 = time.perf_counter()
    tree = init_params(cfg, torch.Generator("cuda").manual_seed(A.JAMBA_SEED))
    torch.cuda.synchronize()
    emit("serve_hybrid", step="weights", case=A.JAMBA_PATH_CASE,
         params=cfg.param_count(), seconds=time.perf_counter() - t0)
    prompt = torch.tensor(
        np.random.default_rng(2).integers(0, cfg.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT + 1),
                                          dtype=np.int32), device="cuda")
    model, per_prefill = serve_invariant(
        torch, "serve_hybrid", A.JAMBA_PATH_CASE,
        lambda dt: A.jamba_config(n_layers, dt), tree, prompt)
    del tree

    # generate in bf16 at B = 4, prompt 1024, 32 new tokens, no host sync
    time_generate(torch, np, model, prompt[:, :SERVE_PROMPT].contiguous(),
                  "serve_hybrid", case=A.JAMBA_PATH_CASE)
    del model
    torch.cuda.empty_cache()
    return per_prefill["selective_scan"]



def _last_token_routing(long_rec, dec_rec, prompt: int) -> dict:
    """The experts each MoE layer picks for the decoded token in a
    decode step (``dec_rec``) and for the same token at the end of the
    longer prefill (``long_rec``): how many (layer, prompt) pairs pick
    another set, and their top-2/top-3 gaps (the second chosen prob
    less the best unchosen one) on both sides."""
    import torch

    differ, gaps = 0, []
    for layer, (lr, dr) in enumerate(zip(long_rec, dec_rec)):
        batch = dr.expert_idx.shape[1]
        k = dr.expert_idx.shape[2]
        long_idx = lr.expert_idx[0].view(batch, prompt + 1, k)[:, -1]
        long_p = lr.probs[0].view(batch, prompt + 1, -1)[:, -1]
        for b in range(batch):
            a = sorted(long_idx[b].tolist())
            d = sorted(dr.expert_idx[0, b].tolist())
            if a == d:
                continue
            differ += 1
            pl = torch.sort(long_p[b], descending=True).values
            pd = torch.sort(dr.probs[0, b], descending=True).values
            gaps.append({"layer": layer, "prompt": b, "prefill": a,
                         "decode": d,
                         "prefill_top2_top3_gap": float(pl[k - 1] - pl[k]),
                         "decode_top2_top3_gap": float(pd[k - 1] - pd[k])})
    return {"routing_differs": differ, "differing": gaps}


def serve_moe(torch, np, pins: dict) -> int:
    """Phase ``serve_moe`` (see the module docstring, phase 17): the pins
    of ``serve_mixtral_1l`` (run in a worker: ``pins``),
    ``serve_mixtral_4l``'s prefill/decode invariant in f32 and bf16 at
    capacity E / K (``serve_invariant``), the tie check and timed
    ``generate``. Returns the flash_attn launches of one 4-layer
    prefill."""
    from repro_torch.configs import acceptance as A
    from repro_torch.models import init_params
    from repro_torch.models import moe
    from repro_torch.train.serve_step import generate

    before_gc = torch.cuda.memory_allocated() / 1e9
    emit("serve_moe", step="start", allocated_before_gc_gb=before_gc,
         **card_memory(torch))
    torch.cuda.reset_peak_memory_stats()

    # (a) serve_mixtral_1l in f32 against the JAX package's pins
    check_lm_pins("serve_moe", A.MIXTRAL_CASE, pins)

    # serve_mixtral_4l: f32 masters made on the card, at capacity E / K
    # (nothing drops) for the invariant
    n_layers = A.MIXTRAL_PATH_LAYERS
    full = A.mixtral_config(n_layers, "float32")
    E, K = full.moe.n_experts, full.moe.top_k
    t0 = time.perf_counter()
    tree = init_params(full, torch.Generator("cuda").manual_seed(
        A.MIXTRAL_SEED))
    torch.cuda.synchronize()
    emit("serve_moe", step="weights", case=A.MIXTRAL_PATH_CASE,
         params=full.param_count(), seconds=time.perf_counter() - t0)
    prompt = torch.tensor(
        np.random.default_rng(2).integers(0, full.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT + 1),
                                          dtype=np.int32), device="cuda")
    model, per_prefill = serve_invariant(
        torch, "serve_moe", A.MIXTRAL_PATH_CASE,
        lambda dt: A.mixtral_config(n_layers, dt, capacity_factor=E / K),
        tree, prompt, routing=True, capacity_factor=E / K)
    del tree

    # (b) exact ties on the card: a zero router at full width, through
    # the first layer's f32 experts
    serve_moe_ties(torch, np, dict(model.layers[0].named_parameters(
        recurse=False)), A.mixtral_config(n_layers, "float32"))

    # (d) generate in bf16 at the published capacity factor 1.25, B = 4,
    # prompt 1024, 32 new tokens, no host sync; the slots each layer drops
    model.cfg = A.mixtral_config(n_layers, "bfloat16")
    prompt = prompt[:, :SERVE_PROMPT].contiguous()
    time_generate(torch, np, model, prompt, "serve_moe",
                  case=A.MIXTRAL_PATH_CASE,
                  capacity_factor=model.cfg.moe.capacity_factor)
    with moe.record_routing() as rec:
        generate(model, prompt, SERVE_GEN)
    per_call = [int((~r.keep).sum()) for r in rec]
    emit("serve_moe", step="dropped", case=A.MIXTRAL_PATH_CASE,
         capacity_factor=model.cfg.moe.capacity_factor,
         capacity_prefill=rec[0].capacity,
         slots_prefill=int(rec[0].keep.numel()),
         dropped_prefill_per_layer=per_call[:n_layers],
         dropped_decode_total=sum(per_call[n_layers:]),
         decode_steps=len(rec) // n_layers - 1)
    del model, rec
    torch.cuda.empty_cache()
    return per_prefill["flash_attn"]


def serve_moe_ties(torch, np, w: dict, cfg) -> None:
    """Phase ``serve_moe`` (b): a zero router at mixtral's width on (4,
    1024) tokens gives every prob 1/8, so every slot picks experts (0, 1)
    in that order, ranks follow the tokens and exactly the slots past rank
    C - 1 = 1,279 drop. The routing on the card equals the CPU's bit for
    bit (probabilities, experts, gates, ranks, kept slots, capacity, aux);
    through the layer's experts (``w``, f32) the dropped tokens' rows are
    exactly 0 and the kept ones not."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm

    D, E, K = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    B, S = SERVE_BATCH, SERVE_PROMPT
    T = B * S
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (B, S, D), dtype=np.float32))
    zero = torch.zeros(D, E)
    h = rms_norm(x, torch.ones(D), cfg.norm_eps).reshape(1, T, D)
    published = 1.25
    cpu = moe.route(zero, h, cfg, published)
    card = moe.route(zero.cuda(), h.cuda(), cfg, published)
    differ = [f for f in moe.Routing._fields if f != "capacity"
              and not torch.equal(getattr(cpu, f),
                                  getattr(card, f).cpu())]
    C = moe.capacity(published, T, K, E)
    tokens = torch.arange(T)
    want_keep = (tokens < C).repeat_interleave(K)[None]
    expected = (torch.equal(cpu.expert_idx[0], torch.arange(K).repeat(T, 1))
                and torch.equal(cpu.rank[0], tokens.repeat_interleave(K))
                and torch.equal(cpu.keep, want_keep)
                and bool((cpu.gates == 0.5).all()) and float(cpu.aux) == 2.0)
    with moe.record_routing() as rec:
        y, aux = moe.moe_apply({**w, "router": zero.cuda()}, x.cuda(), cfg,
                               capacity_factor=published)
    rows = y.reshape(T, D)
    layer_bitwise = all(torch.equal(getattr(rec[0], f), getattr(card, f))
                        for f in moe.Routing._fields if f != "capacity")
    dropped_zero = not bool(rows[C:].any())
    kept_live = bool((rows[:C].abs().amax(-1) > 0).all()) and bool(
        torch.isfinite(rows).all())
    emit("serve_moe", step="ties", batch=B, prompt=S, d_model=D,
         capacity=card.capacity, dropped_slots=int((~card.keep).sum()),
         fields_differing_card_vs_cpu=differ, as_expected=expected,
         layer_routing_bitwise=layer_bitwise, dropped_rows_zero=dropped_zero,
         kept_rows_nonzero=kept_live, aux=float(aux))
    if (card.capacity != cpu.capacity or C != 1280 or differ or not expected
            or not layer_bitwise or not dropped_zero or not kept_live):
        raise AssertionError("serve_moe ties: the card's routing of a zero "
                             "router is not the CPU's, or not as expected")


def serve_last(torch, np, case: str, pins: dict) -> dict:
    """Phase ``serve_xlstm``, ``serve_whisper`` or ``serve_vlm`` (its name
    is the case's): the pins (run in a worker: ``pins``) in f32; the path
    model's prefill/decode invariant in f32 and bf16 (``serve_invariant``;
    xlstm-125m and whisper-small whole, the VLM cut to VLM_PATH_LAYERS;
    ``init_params`` on the card, the VLM's gate opened); a profile of the
    bf16 prefill and decode steps (busy share); timed ``generate`` in bf16
    under sync-debug "error" at B = 4, LAST_PROMPT[case] tokens, with the
    memory. Returns the flash_attn launches per prefill of the pinned and
    the path model, as measured."""
    from repro_torch.configs import acceptance as A
    from repro_torch.models import init_params

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    check_lm_pins(case, case, pins)

    # the path model in f32 and bf16
    cfg = A.lm_case(case)[0]
    path = (A.vlm_config(A.VLM_PATH_LAYERS) if case == A.VLM_CASE else cfg)
    path_case = A.VLM_PATH_CASE if case == A.VLM_CASE else case
    t0 = time.perf_counter()
    tree = init_params(path, torch.Generator("cuda").manual_seed(
        A.LAST_SEED))
    if case == A.VLM_CASE:
        A.open_xgate(tree)
    torch.cuda.synchronize()
    emit(case, step="weights", case=path_case, params=path.param_count(),
         seconds=time.perf_counter() - t0)
    S = LAST_PROMPT[case]
    prompt = torch.tensor(
        np.random.default_rng(2).integers(0, path.vocab, (SERVE_BATCH, S + 1),
                                          dtype=np.int32), device="cuda")
    extras = _on_card(torch, A.lm_memory(path, SERVE_BATCH))
    model, per_prefill = serve_invariant(
        torch, case, path_case,
        lambda dt: dataclasses.replace(path, dtype=dt), tree, prompt,
        extras=extras, serve_tol_suffices=True)
    del tree

    # where the bf16 time goes: the device's busy share
    from repro_torch.tools.profile_serve import profile

    P = LAST_PROFILE_PROMPT.get(case, S)
    for name, rec in profile(model, prompt[:, :P].contiguous(),
                             LAST_PROFILE_STEPS, extras, top=3).items():
        emit(case, step="profile", case=path_case, part=name,
             dtype="bfloat16", batch=SERVE_BATCH, prompt=P,
             **{k: rec[k] for k in (
                 "per", "host_ms", "host_ms_profiled", "cuda_kernels",
                 "device_us", "device_busy_share", "flash_attn_launches",
                 "port_kernel_us", "top_kernels_us")})

    # generate in bf16 at B = 4, 32 new tokens, no host sync
    time_generate(torch, np, model, prompt[:, :S].contiguous(), case,
                  extras=extras, case=path_case)
    del model
    torch.cuda.empty_cache()
    return {"launches_per_pinned_prefill":
                pins["launches_per_prefill"]["flash_attn"],
            "launches_per_path_prefill": per_prefill["flash_attn"],
            "path_case": path_case}


def serve(torch, np) -> tuple:
    """gemma3-1b at full width and depth on the card: the f32 and bf16
    models held to the pins, the launch counts, the bf16 prefill/decode
    invariant, and timed ``generate`` runs under sync-debug "error".
    Returns the flash_attn launches of one prefill and the timed runs'
    fields."""
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
    return per_prefill, time_generate(torch, np, model, prompt, "serve")


def time_generate(torch, np, model, prompt, phase: str, extras=None,
                  **labels) -> dict:
    """``generate`` of SERVE_GEN tokens after ``prompt`` (bf16; with the
    memory ``extras`` where the model attends to one), SERVE_RUNS timed
    runs after a warm-up, each under sync-debug "error": prefill ms and
    decode ms per token (CUDA events inside ``generate``), tokens/s (host
    clock around a synchronised run), median and p10-p90. Returns the
    fields it emits."""
    from repro_torch.train.serve_step import generate

    walls, prefill_ms, decode_ms = [], [], []
    for run in range(SERVE_RUNS + 1):     # the first run warms up
        events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        toks_out = generate(model, prompt, SERVE_GEN, events=events,
                            extras=extras)
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
    fields = dict(dtype="bfloat16", batch=batch, prompt=prompt.shape[1],
                  new_tokens=SERVE_GEN, runs=SERVE_RUNS,
                  prefill_ms_median_p10_p90=q(prefill_ms),
                  decode_ms_per_token_median_p10_p90=q(decode_ms),
                  tokens_per_s_median_p10_p90=q(tok_s),
                  wall_s_median=float(np.median(walls)),
                  max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                  sample=toks_out[0, :8].tolist())
    emit(phase, step="generate", **labels, **fields)
    return fields


def masters_grads(torch, params, batch, cfg, remat: str = "block",
                  fault: str = "") -> dict:
    """``forward_train``'s loss of ``batch`` and its gradients with respect
    to the f32 masters ``params``, each cast to ``cfg.dtype`` inside
    autograd as the train step casts it, optionally with one of
    TRAIN_BF16_FAULTS planted in the attention: the loss, the gradients'
    global norm, acceptance's TRAIN_LEAVES' gradients (a gradient that
    never arrives counts as zero), and the flash_attn launches of the
    forward and of the backward."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.models import layers
    from repro_torch.models.model import forward_train
    from repro_torch.sharding.ctx import ShardCtx
    from repro_torch.utils.tree import (
        tree_leaves_with_names,
        tree_map_with_path_names,
    )

    real = layers.flash_attention

    def planted(q, k, v, *, causal, window):
        if fault == "window dropped":
            return real(q, k, v, causal=causal, window=0)
        return real(q, k, v, causal=causal, window=window).detach()

    names, leaves = zip(*tree_leaves_with_names(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    dtype = getattr(torch, cfg.dtype)
    by = dict(zip(names, (p.to(dtype) for p in live)))
    cast = tree_map_with_path_names(lambda n, _: by[n], params)
    if fault:
        assert fault in TRAIN_BF16_FAULTS, fault
        layers.flash_attention = planted
    try:
        kernels.reset_launches()
        loss, _ = forward_train(cast, batch, cfg, ShardCtx(remat=remat))
        torch.cuda.synchronize()
        fwd = kernels.LAUNCHES["flash_attn"]
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        torch.cuda.synchronize()
    finally:
        layers.flash_attention = real
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, live, grads)}
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    return {"loss": float(loss.detach()), "grad_norm": float(norm),
            "leaves": {n: grads[n] for n in A.TRAIN_LEAVES},
            "forward": fwd, "backward": kernels.LAUNCHES["flash_attn"] - fwd}


def bf16_distance(torch, got: dict, want: dict) -> dict:
    """How far ``masters_grads``' reading ``got`` lies from ``want``'s
    (the f32 model's): the loss's absolute distance, the global norm's
    relative one, each kept leaf's ||g - g32|| / ||g32||, and which of
    TRAIN_BF16_*_TOL they exceed."""
    d = {"loss_err": abs(got["loss"] - want["loss"]),
         "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"])
         / want["grad_norm"],
         "leaf_rel": {n: float(torch.linalg.vector_norm(
             got["leaves"][n] - w) / torch.linalg.vector_norm(w))
             for n, w in want["leaves"].items()}}
    d["misses"] = [k for k, bad in (
        ("loss", d["loss_err"] > TRAIN_BF16_LOSS_TOL),
        ("grad_norm", d["grad_norm_rel"] > TRAIN_BF16_NORM_TOL),
        ("leaves", max(d["leaf_rel"].values()) > TRAIN_BF16_LEAF_TOL))
        if bad]
    return d


def train(torch, np, pinned: dict) -> dict:
    """Phase train: gemma3-1b at full width trained on the card. (a) The
    pinned f32 steps (run in a worker: ``pinned``) against
    ``acceptance.PINNED_TRAIN`` with ``train_launches`` a step. (b) In
    bf16 with f32 masters (``init_params`` on the card), the launches of a
    forward and of its backward pass, with remat "block" and "none". (c)
    The bf16 model against the f32 model on the same masters and batch
    (``bf16_distance``: the loss, the gradients' norm and the TRAIN_LEAVES'
    gradients), and the planted TRAIN_BF16_FAULTS failing that gate; the
    first bf16 step's loss and gradient norm held the same way. (d)
    TRAIN_BF16_STEPS timed steps
    (CUDA events and the host clock), then one under the profiler: ms a
    step, tokens/s, CUDA kernels and the device's busy share, launches a
    step, peak memory. Returns the record for the kernels line."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.data.synth_lm import lm_batch_at
    from repro_torch.tools.profile_tick import device_summary
    from repro_torch.train import create_train_state, make_train_step

    cfg = A.train_config()
    report = A.check_train(pinned["summary"])
    want = train_launches(cfg)
    emit("train", step="pins", case=A.TRAIN_CASE, dtype="float32",
         batch=A.TRAIN_BATCH, seq=A.TRAIN_SEQ, in_worker_beside=(
             LM_PINS_BESIDE), **{k: pinned[k] for k in (
                 "params", "weights_s", "run_s", "step_s", "max_memory_gb")},
         loss=pinned["summary"]["loss"],
         grad_norm=pinned["summary"]["grad_norm"],
         launches_per_step=pinned["launches_per_step"],
         expected_launches_per_step=want, **report)
    if any(n != want for n in pinned["launches_per_step"]):
        raise AssertionError(f"{A.TRAIN_CASE}: launches a step "
                             f"{pinned['launches_per_step']}, expected {want}")

    t0 = time.perf_counter()
    cfg16 = A.train_config("bfloat16")
    opt = A.train_optimizer(TRAIN_BF16_WARMUP + TRAIN_BF16_STEPS + 1)
    state = create_train_state(cfg16, opt,
                               torch.Generator("cuda").manual_seed(0), "cuda")
    batches = [lm_batch_at(i, vocab=cfg.vocab, batch=TRAIN_BF16_BATCH,
                           seq_len=A.TRAIN_SEQ, seed=A.TRAIN_DATA_SEED,
                           device="cuda")
               for i in range(TRAIN_BF16_WARMUP + TRAIN_BF16_STEPS + 1)]
    torch.cuda.synchronize()
    emit("train", step="setup", dtype="bfloat16", seconds=(
        time.perf_counter() - t0), params=cfg.param_count())

    # (b) launches of a forward and of its backward, remat on and off
    split = {}
    for remat in ("block", "none"):
        got = masters_grads(torch, state["params"], batches[0], cfg16, remat)
        split[remat] = {k: got[k] for k in ("forward", "backward")}
        if remat == "block":
            bf16 = got
        del got
        torch.cuda.empty_cache()
        total = train_launches(cfg, remat)["flash_attn"]
        if (split[remat]["forward"] != cfg.n_layers
                or split[remat]["forward"] + split[remat]["backward"]
                != total):
            raise AssertionError(f"train (remat {remat}): flash_attn "
                                 f"launches {split[remat]}, expected "
                                 f"{cfg.n_layers} + {total - cfg.n_layers}")
    emit("train", step="launches", dtype="bfloat16", remat=split,
         note="backward = remat's recompute of the body's 24 attention "
              "layers; the kernels' own backward (plain vjp) launches none")

    # (c) the bf16 model against the f32 model on the same masters and
    # batch; the planted faults must fail the same gate
    f32 = masters_grads(torch, state["params"], batches[0], cfg)
    gate = bf16_distance(torch, bf16, f32)
    controls = {fault: bf16_distance(torch, masters_grads(
        torch, state["params"], batches[0], cfg16, fault=fault), f32)
        for fault in TRAIN_BF16_FAULTS}
    torch.cuda.empty_cache()
    step = make_train_step(cfg16, opt)
    kernels.reset_launches()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    first = dict(kernels.LAUNCHES)
    step_gate = {"loss_err": abs(float(m["loss"]) - f32["loss"]),
                 "grad_norm_rel": abs(float(m["grad_norm"])
                                      - f32["grad_norm"]) / f32["grad_norm"]}
    emit("train", step="bf16_vs_f32", batch=TRAIN_BF16_BATCH,
         seq=A.TRAIN_SEQ, loss_f32=f32["loss"], loss_bf16=bf16["loss"],
         grad_norm_f32=f32["grad_norm"], grad_norm_bf16=bf16["grad_norm"],
         step_loss_bf16=float(m["loss"]),
         step_grad_norm_bf16=float(m["grad_norm"]), step_gate=step_gate,
         tols={"loss": TRAIN_BF16_LOSS_TOL, "grad_norm": TRAIN_BF16_NORM_TOL,
               "leaves": TRAIN_BF16_LEAF_TOL},
         sound=gate, planted=controls)
    del bf16, f32
    if (gate["misses"] or step_gate["loss_err"] > TRAIN_BF16_LOSS_TOL
            or step_gate["grad_norm_rel"] > TRAIN_BF16_NORM_TOL):
        raise AssertionError(f"train (bf16): off the f32 model by {gate} "
                             f"(the step: {step_gate})")
    unseen = [f for f, c in controls.items() if not c["misses"]]
    if unseen:
        raise AssertionError(f"train (bf16): the gate passes the planted "
                             f"faults {unseen}: {controls}")
    if first != train_launches(cfg):
        raise AssertionError(f"train (bf16): launches {first} a step")

    # (d) timed steps, then one profiled
    for b in batches[1:TRAIN_BF16_WARMUP]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev_ms, host_ms, launches, losses = [], [], [], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for b in batches[TRAIN_BF16_WARMUP:-1]:
        kernels.reset_launches()
        t1 = time.perf_counter()
        start.record()
        state, m = step(state, b)
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t1))
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        launches.append(kernels.LAUNCHES["flash_attn"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, m = step(state, batches[-1])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    prof_summary = device_summary(prof, wall_us, 1, 10)
    ms = float(np.median(dev_ms))
    rec = dict(ms_per_step=ms, ms_per_step_all=dev_ms,
               host_ms_per_step=host_ms,
               tokens_per_s=TRAIN_BF16_BATCH * A.TRAIN_SEQ / (ms / 1e3),
               flash_attn_per_step=launches, peak_memory_gb=peak_gb,
               losses=losses, profiled_host_ms=wall_us / 1e3,
               **{k: prof_summary[k] for k in (
                   "cuda_kernels", "device_us", "device_busy_share",
                   "port_kernel_us", "top_kernels_us", "top_host_ops_us")})
    emit("train", step="bf16_steps", batch=TRAIN_BF16_BATCH,
         seq=A.TRAIN_SEQ, steps=TRAIN_BF16_STEPS, **rec)
    if not all(np.isfinite(losses)) or any(
            n != train_launches(cfg)["flash_attn"] for n in launches):
        raise AssertionError(f"train (bf16): losses {losses}, flash_attn "
                             f"launches {launches} a step")
    del state, batches
    torch.cuda.empty_cache()
    return {"launches_per_train_step": launches[0],
            "bf16_ms_per_step": ms, "remat_split": split}


def _numpy_like(cfg):
    """The parameter tree of ``cfg`` as zero-stride numpy arrays of the
    leaves' shapes: ``checkpoint.restore``'s template for numpy leaves,
    with no memory behind it."""
    import numpy as np

    from repro_torch.models import spec as S
    from repro_torch.models.init import _unflatten

    zero = np.zeros((), np.float32)
    specs = S.model_param_specs(cfg)
    return _unflatten(specs, {n: np.broadcast_to(zero, shape)
                              for n, shape in S.leaves_with_names(specs)})


def comm_bytes_mode():
    """A ``CommDebugMode`` that also sums each collective's input bytes by
    operation (``.bytes``): what a rank hands its collectives."""
    from torch.distributed.tensor.debug import CommDebugMode

    class Mode(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            packet = func._overloadpacket
            if packet in getattr(self, "comm_registry", ()):
                first = args[0] if args else None
                tensors = first if isinstance(first, (list, tuple)) \
                    else [first]
                self.bytes[str(packet)] = self.bytes.get(str(packet), 0) + sum(
                    t.numel() * t.element_size() for t in tensors
                    if hasattr(t, "numel"))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Mode()


def _counts(mode) -> dict:
    return {str(k): int(v) for k, v in mode.get_comm_counts().items()}


def _saved_equal(torch, state, directory: str) -> dict:
    """This rank's shard of every leaf of ``state`` against its block of
    the checkpoint's file in ``directory``, cut here by the leaf's
    placements (``numpy.array_split`` of the mapped file in mesh order,
    not DTensor's own cut; only the block is read, and no collective
    runs), bit for bit: the leaves that differ and the bytes compared."""
    import numpy as np
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.utils.tree import tree_leaves_with_names

    differ, nbytes = [], 0
    for name, x in tree_leaves_with_names(state):
        block = np.load(os.path.join(directory, name.replace("/", "__")
                                     + ".npy"), mmap_mode="r")
        if isinstance(x, DTensor):
            mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
            for i, p in enumerate(x.placements):
                if isinstance(p, Shard):
                    block = np.array_split(block, mesh.size(i),
                                           axis=p.dim)[coord[i]]
            x = x.to_local()
        block = torch.from_numpy(np.array(block))
        nbytes += block.numel() * block.element_size()
        if x.shape != block.shape or not torch.equal(x, block.to(x.device)):
            differ.append(name)
    return {"leaves_differing": differ, "bytes_compared": nbytes}


def _train_mesh_bf16(torch, np, mesh) -> dict:
    """TRAIN_MESH_BF16's bf16 steps of phase train's case on ``mesh`` (a
    (1, 1) mesh): ms a step (CUDA events), flash_attn launches a step, the
    CUDA kernels and device busy share of a profiled step, the
    collectives and their bytes of one more step, the peak memory."""
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs import acceptance as A
    from repro_torch.data.synth_lm import lm_batch_at
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import batch_pspecs, distribute
    from repro_torch.tools.profile_tick import device_summary
    from repro_torch.train import (
        create_train_state,
        make_train_step,
        train_state_pspecs,
    )

    warmup, timed = TRAIN_MESH_BF16
    n = warmup + timed + 2
    cfg = A.train_config("bfloat16")
    opt = A.train_optimizer(n)
    ctx = make_ctx(False, tp_size=1, dp_size=1)
    state = distribute(create_train_state(
        cfg, opt, torch.Generator("cuda").manual_seed(0), "cuda"),
        train_state_pspecs(cfg, ctx, opt, mesh), mesh)
    bps = batch_pspecs(cfg, ShapeConfig("bf16", A.TRAIN_SEQ,
                                        TRAIN_BF16_BATCH, "train"), ctx)
    batches = [distribute(lm_batch_at(
        i, vocab=cfg.vocab, batch=TRAIN_BF16_BATCH, seq_len=A.TRAIN_SEQ,
        seed=A.TRAIN_DATA_SEED, device="cuda"), bps, mesh) for i in range(n)]
    step = make_train_step(cfg, opt, ctx)
    for b in batches[:warmup]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms, launches, losses = [], [], []
    for b in batches[warmup:warmup + timed]:
        kernels.reset_launches()
        start.record()
        state, m = step(state, b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        launches.append(kernels.LAUNCHES["flash_attn"])
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, m = step(state, batches[-2])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    summary = device_summary(prof, wall_us, 1, 10)
    with comm_bytes_mode() as comm:
        state, m = step(state, batches[-1])
        torch.cuda.synchronize()
    del state, batches
    torch.cuda.empty_cache()
    return {"batch": TRAIN_BF16_BATCH, "ms_per_step": float(np.median(ms)),
            "ms_per_step_all": ms, "flash_attn_per_step": launches,
            "losses": losses, "peak_memory_gb": peak,
            "collectives_per_step": _counts(comm),
            "collective_bytes_per_step": comm.bytes,
            **{k: summary[k] for k in ("cuda_kernels", "device_us",
                                       "device_busy_share")}}


def _train_mesh_one(torch, fmesh, work: str, init, data: int, model: int,
                    saved: str) -> dict:
    """One mesh of a phase train_mesh world on this rank:
    ``launch.train.run`` on the (data, model) mesh from the weights
    ``init`` (the launcher's ``--model-axis``, its mesh path); the pinned
    summary of the run, its launches, staged collectives and peak memory;
    the mesh named ``saved`` writes its state at the end (``--ckpt``) and
    checks its shards against the files, the others restore that
    checkpoint onto their own mesh and check theirs."""
    from repro_torch import kernels
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.configs import acceptance as A
    from repro_torch.data.synth_lm import lm_batch_at
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import STAGED, make_mesh_for
    from repro_torch.optim.base import plain
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import named_shardings
    from repro_torch.train import train_state_pspecs
    from repro_torch.utils.tree import tree_leaves_with_names, tree_map

    name = f"{fmesh.backend} ({data}, {model})"
    cfg = A.train_mesh_config()
    named = dict(tree_leaves_with_names(init))
    params0 = {n: named[n] for n in A.TRAIN_LEAVES}
    directory = os.path.join(work, "saved")
    argv = ["--arch", A.LM_ARCH, "--dtype", cfg.dtype,
            "--steps", str(A.TRAIN_STEPS),
            "--batch", str(A.TRAIN_BATCH), "--seq", str(A.TRAIN_SEQ),
            "--lr", str(A.TRAIN_LR), "--warmup", str(A.TRAIN_WARMUP),
            "--seed", str(A.TRAIN_DATA_SEED), "--log-every", "1",
            "--model-axis", str(model)]
    if name == saved:
        argv += ["--ckpt", directory, "--ckpt-every", str(A.TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    staged = dict(STAGED)
    t0 = time.perf_counter()
    history, state = T.run(T.parse_args(argv), init=init, cfg=cfg)
    torch.cuda.synchronize()
    rec = {"world": name, "rank": fmesh.rank,
           "run_s": time.perf_counter() - t0,
           "launches": dict(kernels.LAUNCHES),
           "staged": {k: STAGED[k] - staged[k] for k in STAGED},
           "tok_per_s": [h["tok_per_s"] for h in history],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    tokens = [lm_batch_at(i, vocab=cfg.vocab, batch=A.TRAIN_BATCH,
                          seq_len=A.TRAIN_SEQ, seed=A.TRAIN_DATA_SEED,
                          device="cuda")["tokens"].cpu().numpy()
              for i in range(A.TRAIN_STEPS)]
    named = dict(tree_leaves_with_names(state["params"]))
    rec["summary"] = A.train_summary(
        history, tokens, params0,
        {n: plain(named[n]).cpu().numpy() for n in A.TRAIN_LEAVES})
    del named
    step = latest_step(directory)
    t0 = time.perf_counter()
    if name != saved:
        like = tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                              device="meta"), state)
        del state
        mesh = make_mesh_for(model_axis=model)
        ctx = make_ctx(False, tp_size=model, dp_size=data)
        state = restore(directory, step, like, shardings=named_shardings(
            train_state_pspecs(cfg, ctx, A.train_optimizer(), mesh), mesh))
        rec["restored_placements"] = {
            n: str(state["params"][n].placements) for n in ("emb",)}
    rec["saved"] = _saved_equal(torch, state,
                                os.path.join(directory, f"step_{step:010d}"))
    rec["check_s"] = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    return rec


def train_mesh_world(fmesh, work: str, meshes: tuple, saved: str) -> dict:
    """One rank of a phase train_mesh world: the weights under
    ``work/init`` read once, then each (data, model) of ``meshes`` in turn
    (``_train_mesh_one``); under nccl the bf16 steps on (1, 1) after."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import restore
    from repro_torch.configs import acceptance as A
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.utils.device import exact_matmul

    exact_matmul()
    t0 = time.perf_counter()
    init = restore(os.path.join(work, "init"), 0,
                   _numpy_like(A.train_mesh_config()))
    out = {"load_s": time.perf_counter() - t0}
    for data, model in meshes:
        t0 = time.perf_counter()
        out[data, model] = _train_mesh_one(torch, fmesh, work, init, data,
                                           model, saved)
        out[data, model]["wall_s"] = time.perf_counter() - t0
    del init
    if fmesh.backend == "nccl":
        out["bf16"] = _train_mesh_bf16(torch, np, make_mesh_for(model_axis=1))
    else:
        t0 = time.perf_counter()
        out["families"] = train_families_cases(torch, fmesh)
        out["families"]["wall_s"] = time.perf_counter() - t0
    return out


def train_mesh_run(torch) -> dict:
    """Worker entry (``start_alone``, ``entry="train_mesh"``) of phase
    train_mesh: the weights drawn once and written under
    ``build/train_mesh/init``, then each world of TRAIN_MESH_WORLDS in
    turn (``train_mesh_world`` on every rank), the first mesh saving its
    state for the others. Returns each mesh's ranks' records and seconds,
    and each world's."""
    import shutil

    from repro_torch.checkpoint import save
    from repro_torch.configs import acceptance as A
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import seeded_numpy_params

    work = ROOT / "build" / "train_mesh"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    save(str(work / "init"), 0, seeded_numpy_params(A.train_mesh_config(),
                                                     A.LM_SEED))
    out = {"weights_s": time.perf_counter() - t0, "worlds": {},
           "world_s": {}}
    first = TRAIN_MESH_WORLDS[0]
    saved = "{} ({}, {})".format(first[0], *first[1][0])
    for backend, meshes in TRAIN_MESH_WORLDS:
        t0 = time.perf_counter()
        ranks = spawn_world(train_mesh_world, max(d * m for d, m in meshes),
                            backend=backend, args=(str(work), meshes, saved),
                            timeout=TRAIN_MESH_TIMEOUT_S)
        out["world_s"][backend] = time.perf_counter() - t0
        for data, model in meshes:
            out["worlds"][f"{backend} ({data}, {model})"] = {
                "ranks": [r[data, model] for r in ranks],
                "wall_s": ranks[0][data, model]["wall_s"],
                "load_s": ranks[0]["load_s"]}
        if "bf16" in ranks[0]:
            out["bf16"] = ranks[0]["bf16"]
        if "families" in ranks[0]:
            out["families"] = [r["families"] for r in ranks]
    shutil.rmtree(work, ignore_errors=True)
    return out


def _refusals(torch, mesh) -> dict:
    """Each kernel's wrapper handed DTensors on ``mesh``: the TypeError
    it raises, or None where it took them."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.selective_scan import mamba_scan

    def d(*shape):
        return distribute_tensor(torch.zeros(shape, device="cuda"), mesh,
                                 [Replicate()] * mesh.ndim)

    calls = {"flash_attn": lambda: flash_attention(
                 d(1, 8, 2, 64), d(1, 8, 2, 64), d(1, 8, 2, 64)),
             "mamba_scan": lambda: mamba_scan(
                 d(1, 8, 16), d(1, 8, 16), d(16), -d(16, 16) - 1,
                 d(1, 8, 16), d(1, 8, 16), d(1, 8, 16), d(16))}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def train_families_cases(torch, fmesh) -> dict:
    """Phase train_mesh_families on one rank of phase train_mesh's gloo
    world of 2, once its weights are written (TRAIN_FAMILIES_READY): each
    case of TRAIN_FAMILIES_ORDER on a (1, 2) mesh through
    ``acceptance.run_train`` from its weights under TRAIN_FAMILIES_WORK
    (read from their files as touched, each rank's shard of a leaf cut on
    the host), its summary, launches a step, staged all-gathers, seconds
    and peak memory; then the refusals."""
    import gc

    import torch.distributed as dist

    from repro_torch.checkpoint import restore
    from repro_torch.configs import acceptance as A
    from repro_torch.launch.mesh import STAGED, make_mesh_for

    data, model = TRAIN_FAMILIES_MESH
    mesh = make_mesh_for(model_axis=model)
    assert tuple(mesh.shape) == (data, model)
    t0 = time.perf_counter()
    if fmesh.rank == 0:
        while not TRAIN_FAMILIES_READY.exists():
            time.sleep(0.5)
    dist.barrier()
    out = {"waited_s": time.perf_counter() - t0}
    for case in TRAIN_FAMILIES_ORDER:
        cfg = A.train_family_config(case)
        t0 = time.perf_counter()
        tree = restore(str(TRAIN_FAMILIES_WORK / case), 0, _numpy_like(cfg),
                       mmap=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        staged = dict(STAGED)
        summary, launches, step_s = A.run_train(
            cfg, tree, "cuda", optimizer=A.TRAIN_FAMILY_OPTIMIZER,
            mesh=mesh, leaves=A.TRAIN_FAMILY_LEAVES[case])
        torch.cuda.synchronize()
        out[case] = {"rank": fmesh.rank, "summary": summary,
                     "launches": launches, "step_s": step_s,
                     "run_s": time.perf_counter() - t0,
                     "params": cfg.param_count(),
                     "staged": {k: STAGED[k] - staged[k] for k in STAGED},
                     "peak_memory_gb":
                         torch.cuda.max_memory_allocated() / 1e9}
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    out["refusals"] = _refusals(torch, mesh)
    return out


def train_families_draw(torch) -> dict:
    """Worker entry (``start_alone``, ``entry="train_mesh_families"``) of
    phase train_mesh_families: each case's weights drawn and written under
    TRAIN_FAMILIES_WORK, on the host alone, then TRAIN_FAMILIES_READY.
    Returns the seconds each case took."""
    import shutil

    from repro_torch.checkpoint import save
    from repro_torch.configs import acceptance as A
    from repro_torch.models import seeded_numpy_params

    shutil.rmtree(TRAIN_FAMILIES_WORK, ignore_errors=True)
    drawn_s = {}
    for case in TRAIN_FAMILIES_ORDER:
        t0 = time.perf_counter()
        save(str(TRAIN_FAMILIES_WORK / case), 0, seeded_numpy_params(
            A.train_family_config(case), A.LM_SEED))
        drawn_s[case] = time.perf_counter() - t0
    TRAIN_FAMILIES_READY.touch()
    return {"drawn_s": drawn_s}


def train_mesh_families(torch, ranks: list, drawn: dict,
                        wall_s: float) -> dict:
    """Phase train_mesh_families' checks of the ranks' records ``ranks``
    (run in phase train_mesh's gloo world) and the drawing worker's
    ``drawn`` (its wall seconds ``wall_s``):
    every case on every rank within TRAIN_TOLS of its
    PINNED_TRAIN_FAMILIES entry (one summary on every rank),
    ``train_launches`` a step on every rank, and both kernels' wrappers
    refusing a DTensor on every rank. Returns the launches a step by case
    for the kernels line."""
    from repro_torch.configs import acceptance as A

    per_step = {}
    for case in TRAIN_FAMILIES_ORDER:
        recs = [r[case] for r in ranks]
        want = train_launches(A.train_family_config(case))
        report = A.check_train(recs[0]["summary"],
                               A.PINNED_TRAIN_FAMILIES[case])
        if any(r["summary"] != recs[0]["summary"] for r in recs):
            raise AssertionError(f"train_mesh_families {case}: the ranks' "
                                 "summaries differ")
        per_step[case] = {k: [[step[k] for step in r["launches"]]
                              for r in recs]
                          for k in ("flash_attn", "selective_scan")}
        emit("train_mesh_families", case=case, mesh=str(TRAIN_FAMILIES_MESH),
             backend="gloo", optimizer=A.TRAIN_FAMILY_OPTIMIZER,
             batch=A.TRAIN_BATCH, seq=A.TRAIN_SEQ,
             loss=recs[0]["summary"]["loss"],
             grad_norm=recs[0]["summary"]["grad_norm"],
             launches_per_step_per_rank=per_step[case],
             expected_per_step={k: want[k] for k in per_step[case]},
             drawn_s=drawn["drawn_s"][case],
             **report, ranks=[{k: r[k] for k in (
                 "rank", "params", "run_s", "step_s", "staged",
                 "peak_memory_gb")} for r in recs])
        bad = [r["rank"] for r in recs if any(
            step[k] != want[k] for step in r["launches"] for k in want)]
        if bad:
            raise AssertionError(f"train_mesh_families {case}: launches a "
                                 f"step {[r['launches'] for r in recs]}, "
                                 f"expected {want}")
    refused = [r["refusals"] for r in ranks]
    emit("train_mesh_families", step="refusals", ranks=refused,
         drawing_worker_wall_s=wall_s,
         cases_wall_s=[r["wall_s"] for r in ranks],
         waited_for_weights_s=[r["waited_s"] for r in ranks],
         in_world_of="phase train_mesh's gloo world, after its meshes")
    if any(msg is None or "DTensor" not in msg for r in refused
           for msg in r.values()):
        raise AssertionError(f"train_mesh_families: a kernel took a "
                             f"DTensor: {refused}")
    return per_step


RANK_KEYS = ("rank", "run_s", "check_s", "tok_per_s",
             "peak_memory_gb", "staged", "saved", "restored_placements",
             "launches")


def train_mesh(torch, result: dict, trained: dict, wall_s: float) -> dict:
    """Phase train_mesh's checks of the worker's ``result``: every rank of
    every world within TRAIN_TOLS of PINNED_TRAIN_MESH (one summary on every
    rank), ``train_launches`` flash_attn launches a step on every rank, the
    saved state bit for bit in each world (as saved, and restored onto the
    others' meshes), finite bf16 losses with the launches of a step; the
    bf16 step on (1, 1) beside phase train's unsharded one (``trained``).
    Returns the launches a step by world for the kernels line."""
    from repro_torch.configs import acceptance as A

    want = train_launches(A.train_mesh_config())["flash_attn"]
    per_step = {}
    for name, world in result["worlds"].items():
        ranks = world["ranks"]
        report = A.check_train(ranks[0]["summary"], A.PINNED_TRAIN_MESH)
        if any(r["summary"] != ranks[0]["summary"] for r in ranks):
            raise AssertionError(f"train_mesh {name}: the ranks' summaries "
                                 "differ")
        launches = [r["launches"].get("flash_attn", 0) / A.TRAIN_STEPS
                    for r in ranks]
        per_step[name] = launches
        emit("train_mesh", world=name, wall_s=world["wall_s"],
             load_s=world["load_s"],
             loss=ranks[0]["summary"]["loss"],
             grad_norm=ranks[0]["summary"]["grad_norm"],
             flash_attn_per_step_per_rank=launches,
             expected_per_step=want, **report,
             ranks=[{k: r[k] for k in RANK_KEYS if k in r} for r in ranks])
        if any(n != want for n in launches):
            raise AssertionError(f"train_mesh {name}: flash_attn launches a "
                                 f"step {launches}, expected {want}")
        bad = [r["saved"]["leaves_differing"] for r in ranks
               if r["saved"]["leaves_differing"]]
        if bad:
            raise AssertionError(f"train_mesh {name}: the saved state "
                                 f"differs in {bad[0][:5]}")
    bf16 = result["bf16"]
    emit("train_mesh", step="bf16", mesh="(1, 1)", backend="nccl",
         unsharded_ms_per_step=trained["bf16_ms_per_step"],
         weights_s=result["weights_s"], world_s=result["world_s"],
         worker_wall_s=wall_s,
         in_worker_beside=TRAIN_MESH_BESIDE, **bf16)
    if not all(math.isfinite(x) for x in bf16["losses"]) or any(
            n != train_launches(A.train_config())["flash_attn"]
            for n in bf16["flash_attn_per_step"]):
        raise AssertionError(f"train_mesh (bf16): losses {bf16['losses']}, "
                             f"launches {bf16['flash_attn_per_step']}")
    return per_step


def serve_mesh_world(fmesh) -> dict:
    """One rank of phase serve_mesh's gloo world of two ranks sharing the
    card: gemma3-1b at full width on mesh (1, 2) under
    ``decode_kv_shard=SERVE_MESH_KV``, its weights laid out by
    ``param_pspecs`` (each rank draws the numpy tree and keeps its shard):
    the f32 prefill of the ``PINNED_LM`` case and its decode steps (the
    logits whole on this rank, the flash_attn launches of the prefill, the
    cache leaves' layouts after each step), then the bf16 model's decode
    steps timed after a prefill at B SERVE_BATCH, prompt SERVE_PROMPT."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import seeded_numpy_params
    from repro_torch.models.model import DecoderLM, decode_step, prefill
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import (
        distribute,
        distribute_leaf,
        layer_cache_pspecs,
        param_pspecs,
        placements,
    )
    from repro_torch.utils.device import exact_matmul
    from repro_torch.utils.tree import tree_map

    exact_matmul()
    mesh = make_mesh_for(model_axis=2)
    ctx = make_ctx(False, tp_size=2, dp_size=1,
                   decode_kv_shard=SERVE_MESH_KV)
    cfg = A.lm_config("float32")
    t0 = time.perf_counter()
    tree = tree_map(torch.from_numpy, seeded_numpy_params(cfg, A.LM_SEED))
    out = {"rank": fmesh.rank, "weights_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    model = DecoderLM.from_tree(cfg, distribute(
        tree, param_pspecs(cfg, ctx, mesh), mesh))
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    toks = torch.from_numpy(A.lm_tokens(cfg))
    S, N = A.LM_PROMPT, A.LM_DECODE
    spec = (ctx.axis("dp"), None)

    def tokens(a, b):
        return distribute_leaf(toks[:, a:b].contiguous(), spec, mesh)

    specs = layer_cache_pspecs(cfg, ctx)

    def layout_faults(cache):
        return [(i, k) for i, e in enumerate(cache) for k, t in e.items()
                if tuple(t.placements) != placements(specs[i][k], mesh)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (logits, cache), launches = _counted(torch, lambda: prefill(
        model, tokens(0, S), cache_seq_len=S + N, ctx=ctx))
    out["prefill_s"] = time.perf_counter() - t0
    out["launches_per_prefill"] = launches
    logits_all, faults = [logits.full_tensor()], layout_faults(cache)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for i in range(N):
        logits, cache = decode_step(model, cache, tokens(S + i, S + i + 1),
                                    S + i, ctx=ctx)
        logits_all.append(logits.full_tensor())
        faults += layout_faults(cache)
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    out["launches_in_decode"] = dict(kernels.LAUNCHES)
    out["finite"] = all(bool(torch.isfinite(x).all()) for x in logits_all)
    out["summary"] = A.lm_summary([x.cpu().numpy() for x in logits_all])
    out["layout_faults"] = faults
    out["f32_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, cache, logits, logits_all
    torch.cuda.empty_cache()

    # bf16: decode steps timed after a prefill of SERVE_PROMPT tokens
    b16 = dataclasses.replace(cfg, dtype="bfloat16")
    model = DecoderLM.from_tree(b16, distribute(
        tree, param_pspecs(b16, ctx, mesh), mesh))
    del tree
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT + SERVE_MESH_STEPS + 1),
        dtype=np.int32))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, cache = prefill(model, distribute_leaf(
        prompt[:, :SERVE_PROMPT].contiguous(), spec, mesh),
        cache_seq_len=SERVE_PROMPT + SERVE_MESH_STEPS + 1, ctx=ctx)
    torch.cuda.synchronize()
    out["bf16_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    step_ms = []
    for i in range(SERVE_MESH_STEPS + 1):       # the first warms up
        pos = SERVE_PROMPT + i
        t0 = time.perf_counter()
        _, cache = decode_step(model, cache, distribute_leaf(
            prompt[:, pos:pos + 1].contiguous(), spec, mesh), pos, ctx=ctx)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    out["bf16_decode_ms_per_token"] = step_ms[1:]
    out["bf16_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def serve_mesh_run(torch) -> dict:
    """Worker entry (``start_alone``, ``entry="serve_mesh"``) of phase
    serve_mesh: its gloo world of two ranks on cuda:0
    (``serve_mesh_world`` on each). Returns the ranks' records and the
    world's seconds."""
    from repro_torch.launch.mesh import spawn_world

    t0 = time.perf_counter()
    ranks = spawn_world(serve_mesh_world, 2, backend="gloo",
                        timeout=SERVE_MESH_TIMEOUT_S)
    return {"ranks": ranks, "world_s": time.perf_counter() - t0}


def serve_mesh(torch, result: dict, wall_s: float,
               one_card: dict) -> int:
    """Phase serve_mesh's checks: both ranks' logits at ``PINNED_LM``
    within ``LM_F32_TOL`` (``check_lm``), every logit finite, the cache's
    layout kept, flash_attn launched once a layer in each rank's prefill
    (its 2 local q heads of 4; Kv 1 whole) and never in a decode step.
    Reports the bf16 decode ms a token on (1, 2) beside phase serve's
    one-card figure (not a gate), the seconds and the peak GB a rank.
    Returns the flash_attn launches of a rank's prefill."""
    import numpy as np

    from repro_torch.configs import acceptance as A

    cfg = A.lm_config("float32")
    per_prefill = []
    for r in result["ranks"]:
        report = A.check_lm(r["summary"], "float32")
        got = r["launches_per_prefill"]["flash_attn"]
        per_prefill.append(got)
        emit("serve_mesh", step="pins", rank=r["rank"], mesh=[1, 2],
             decode_kv_shard=SERVE_MESH_KV, case=A.LM_CASE,
             flash_attn_per_prefill=got,
             flash_attn_in_decode=r["launches_in_decode"]["flash_attn"],
             weights_s=r["weights_s"], load_s=r["load_s"],
             prefill_s=r["prefill_s"], decode_s=r["decode_s"],
             f32_peak_gb=r["f32_peak_gb"], **report)
        if not r["finite"]:
            raise AssertionError(f"serve_mesh rank {r['rank']}: non-finite "
                                 "logits")
        if r["layout_faults"]:
            raise AssertionError(f"serve_mesh rank {r['rank']}: cache "
                                 f"leaves left their layout: "
                                 f"{r['layout_faults'][:4]}")
        if got != cfg.n_layers or r["launches_in_decode"]["flash_attn"]:
            raise AssertionError(
                f"serve_mesh rank {r['rank']}: flash_attn launched {got} "
                f"times in a prefill and {r['launches_in_decode']} in the "
                f"decode steps (expected {cfg.n_layers} and 0)")
    q = lambda a: [float(v) for v in np.percentile(np.asarray(a),
                                                   [50, 10, 90])]
    emit("serve_mesh", step="bf16 decode", mesh=[1, 2], batch=SERVE_BATCH,
         prompt=SERVE_PROMPT, steps=SERVE_MESH_STEPS,
         decode_ms_per_token_median_p10_p90_by_rank=[
             q(r["bf16_decode_ms_per_token"]) for r in result["ranks"]],
         prefill_ms_by_rank=[r["bf16_prefill_ms"] for r in result["ranks"]],
         one_card_decode_ms_per_token_median_p10_p90=one_card.get(
             "decode_ms_per_token_median_p10_p90"),
         bf16_peak_gb_by_rank=[r["bf16_peak_gb"] for r in result["ranks"]],
         world_s=result["world_s"], worker_wall_s=wall_s,
         beside=SERVE_MESH_BESIDE)
    return per_prefill[0]


def dryrun_run(torch) -> dict:
    """Worker entry (``start_alone``, ``entry="dryrun"``) of phase dryrun:
    ``launch/dryrun.py``'s cells of ``acceptance.DRYRUN_CHIP_CELLS`` on
    the card's host, each on a fake world of 256 or 512 ranks (no tensor
    allocated, the card untouched), with the layer-delta probes on
    ``single`` as the CLI runs them. Returns each cell's record and its
    seconds."""
    from repro_torch.configs import acceptance as A
    from repro_torch.launch.dryrun import record_cell

    out = {}
    for arch, shape, mesh in A.DRYRUN_CHIP_CELLS:
        t0 = time.perf_counter()
        rec = record_cell(arch, shape, mesh, verbose=False,
                          probes=mesh != "multi")
        out[f"{arch}__{shape}__{mesh}"] = {"record": rec,
                                           "wall_s": time.perf_counter() - t0}
    return out


def dryrun(result: dict, wall_s: float) -> None:
    """Phase dryrun's checks: every cell ``OK``, its analytic fields equal
    to ``acceptance.PINNED_DRYRUN_FIELDS`` and, where the JAX dry-run's
    record is pinned (``PINNED_DRYRUN``), its argument bytes equal; one
    line a cell with the FLOPs, the collective bytes a device, the
    argument GiB and the trace's seconds."""
    from repro_torch.configs import acceptance as A

    for cell, got in result.items():
        rec = got["record"]
        if rec["status"] != "OK":
            raise AssertionError(f"dryrun {cell}: {rec['status']} "
                                 f"{rec.get('error', rec.get('reason'))}")
        pins = A.PINNED_DRYRUN_FIELDS[cell]
        off = {k: (rec[k], v) for k, v in pins.items() if rec[k] != v}
        pinned = A.PINNED_DRYRUN.get(cell)
        if pinned and (rec["memory"]["argument_bytes"]
                       != pinned["memory"]["argument_bytes"]):
            off["argument_bytes"] = (rec["memory"]["argument_bytes"],
                                     pinned["memory"]["argument_bytes"])
        mem = rec["memory"]
        emit("dryrun", cell=cell, flops_per_dev=rec["hlo_flops_per_dev"],
             bytes_per_dev=rec["hlo_bytes_per_dev"],
             collective_bytes_per_dev=rec["collective_bytes_per_dev"],
             collective_bytes_by_kind=rec["collectives"]["bytes_by_kind"],
             argument_gib=mem["argument_bytes"] / 2**30,
             temp_gib=mem["temp_bytes"] / 2**30,
             trace_s=rec["compile_s"],
             probe_s=(rec["probe"] or {}).get("probe_compile_s"),
             cell_wall_s=got["wall_s"], dominant=rec["dominant"],
             pinned_fields=sorted(pins) + (["argument_bytes"] if pinned
                                           else []))
        if off:
            raise AssertionError(f"dryrun {cell}: off the pins: {off}")
    emit("dryrun", step="done", cells=len(result), worker_wall_s=wall_s,
         host="the card's host (no device work)")


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
    "error", then ``check_hour``. Returns (launches, final state,
    telemetry, wall seconds)."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance
    from repro_torch.core import init_state, load_jobs, run_episode

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
    return check_hour(torch, case, cfg, final, telem, dict(kernels.LAUNCHES),
                      wall_s, phase, setup_s=setup_s)


def hour_run(case: str, cfg, statics, state) -> dict:
    """``drive``'s hour as a measured run for a worker (``start_alone``):
    sync-debug "error", its launches counted; ``check_hour`` its result."""
    from repro_torch.configs import acceptance

    return dict(cfg=cfg, statics=statics, state=state,
                n_steps=acceptance.N_STEPS, scheduler=acceptance.SCHEDULER,
                kw=dict(summary_only=True), measure=True, case=case)


def macro_hour_run(cfg, statics, state, entry: str = "run_episode",
                   **kw) -> dict:
    """An hour at ``macro=True`` as a run for a worker (``start_alone``):
    ``run_episode`` of ``acceptance.SCHEDULER`` (or ``run_fleet`` of the
    policies in ``kw``) under ``_macro_counts`` (sync-debug "error", the
    launches, the macro ticks and the host reads counted), whose tuple it
    returns."""
    from repro_torch.configs import acceptance

    return dict(entry=entry, cfg=cfg, statics=statics, state=state,
                n_steps=acceptance.N_STEPS,
                scheduler=(acceptance.SCHEDULER if entry == "run_episode"
                           else None),
                kw=dict(kw, macro=True), macro_counts=True)


def check_hour(torch, case: str, cfg, final, telem, launches: dict,
               wall_s: float, phase: str, **labels):
    """An hour of ``case`` held to its pinned values, one power_scatter
    launch per tick and, with the thermal twin on, one rack_thermal launch
    per tick, every final float finite. Returns (launches, final state,
    telemetry, wall seconds)."""
    from repro_torch.configs import acceptance
    from repro_torch.core import summary

    got = summary(final, telem)
    pins = (acceptance.PINNED_FAULTS if case in acceptance.PINNED_FAULTS
            else acceptance.PINNED)[case]
    emit(phase, case=case, ticks=acceptance.N_STEPS, **labels,
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


_ALONE_BATCHES = [0]     # batches of worker files made so far


def start_alone(torch, runs: list, limit: int | None = None) -> dict:
    """Write each of ``runs`` (see ``run_alone``) to a file of its own
    under ``build/alone/`` (a fresh batch prefix, so batches may overlap)
    and start up to ``limit`` workers (all by default). Returns the batch's
    handle for ``poll_alone`` / ``join_alone`` / ``stop_alone``."""
    work = ROOT / "build" / "alone"
    work.mkdir(parents=True, exist_ok=True)
    batch = _ALONE_BATCHES[0]
    _ALONE_BATCHES[0] += 1
    paths = []
    for i, run in enumerate(runs):
        src, out, log = (work / f"b{batch}_run{i}.pt",
                         work / f"b{batch}_out{i}.pt",
                         work / f"b{batch}_log{i}.txt")
        out.unlink(missing_ok=True)
        torch.save(run, src)
        paths.append((src, out, log))
    handle = {"paths": paths, "pending": list(range(len(runs))),
              "live": {}, "limit": limit or len(runs), "wall_s": {},
              "timeouts": [run.get("timeout_s", ALONE_TIMEOUT_S)
                           for run in runs]}
    poll_alone(handle)
    return handle


def poll_alone(handle: dict) -> bool:
    """Start pending workers as slots free, check the live ones (a worker
    that failed or outlives ALONE_TIMEOUT_S raises). True when all are
    done."""
    paths, live = handle["paths"], handle["live"]
    while handle["pending"] and len(live) < handle["limit"]:
        i = handle["pending"].pop(0)
        src, out, log = paths[i]
        with open(log, "w") as f:
            live[i] = (subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--alone",
                 str(src), str(out)], stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True),
                time.perf_counter(), time.time())
    for i, (proc, t0, started) in list(live.items()):
        if proc.poll() is None:
            limit = handle["timeouts"][i]
            if time.perf_counter() - t0 > limit:
                raise AssertionError(f"alone run {i}: over {limit} s")
            continue
        del live[i]
        # from its start to its result file's last write, however late
        # the parent polls
        out = paths[i][1]
        handle["wall_s"][i] = (out.stat().st_mtime - started
                               if out.exists() else None)
        if proc.returncode != 0:
            raise AssertionError(f"alone run {i} failed:\n"
                                 f"{paths[i][2].read_text()}")
    return not handle["pending"] and not live


def stop_alone(handle: dict) -> None:
    """Kill any live worker of the batch, with the processes it started
    (its session), and wait for it."""
    import signal

    for proc, _, _ in handle["live"].values():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    handle["live"].clear()
    handle["pending"].clear()


def join_alone(torch, handle: dict) -> list:
    """Wait for every worker of the batch (stopping them all if one
    fails) and return each run's result on the card, in run order."""
    try:
        while not poll_alone(handle):
            time.sleep(0.2)
    finally:
        stop_alone(handle)
    return [torch.load(out, map_location="cuda", weights_only=False)
            for _, out, _ in handle["paths"]]


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
    handle = start_alone(torch, runs, ALONE_WORKERS)
    try:
        meanwhile = during() if during is not None else None
    except BaseException:
        stop_alone(handle)
        raise
    results = join_alone(torch, handle)
    return (results, meanwhile) if during is not None else results


def alone_main(src: str, out: str) -> int:
    """Worker of ``run_alone`` / ``start_alone``: one ``run_episode`` on the
    card (or the run's ``entry``: ``run_fleet``, or ``lm_case_pins`` of
    the run's ``case``). A run
    with ``measure`` is timed under sync-debug "error" with its launches
    counted, and its result carries them as a third element; a run with
    ``macro_counts`` returns ``_macro_counts``' tuple instead."""
    import contextlib

    import torch

    from repro_torch import kernels
    from repro_torch.core import run_episode, run_fleet
    from repro_torch.utils.device import exact_matmul

    exact_matmul()
    run = torch.load(src, map_location="cuda", weights_only=False)
    if run.get("entry") == "lm_case_pins":
        torch.save(lm_case_pins(torch, run["case"]), out)
        return 0
    if run.get("entry") == "train_pins":
        torch.save(train_pins(torch), out)
        return 0
    if run.get("entry") == "train_mesh":
        torch.save(train_mesh_run(torch), out)
        return 0
    if run.get("entry") == "train_mesh_families":
        torch.save(train_families_draw(torch), out)
        return 0
    if run.get("entry") == "serve_mesh":
        torch.save(serve_mesh_run(torch), out)
        return 0
    if run.get("entry") == "dryrun":
        torch.save(dryrun_run(torch), out)
        return 0
    entry = {"run_episode": run_episode,
             "run_fleet": run_fleet}[run.get("entry", "run_episode")]
    if run["kw"].get("policies") is not None:
        # a Policy's ids are host data, which the load put on the card
        run["kw"]["policies"] = type(run["kw"]["policies"])(
            *(v.cpu() for v in run["kw"]["policies"]))
    if run.get("macro_counts"):
        torch.save(_macro_counts(torch, lambda: entry(
            run["cfg"], run["statics"], run["state"], run["n_steps"],
            run["scheduler"], **run["kw"])), out)
        return 0
    measure = run.get("measure", False)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with (no_sync(torch)() if measure else contextlib.nullcontext()):
        final, telem = entry(run["cfg"], run["statics"], run["state"],
                             run["n_steps"], run["scheduler"], **run["kw"])
    torch.cuda.synchronize()
    result = (final, telem)
    if measure:
        result += ({"wall_s": time.perf_counter() - t0,
                    "launches": dict(kernels.LAUNCHES)},)
    torch.save(result, out)
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


def fleet(torch, np, jobs, bank, beside=()) -> tuple:
    """The fleet case (``acceptance.fleet_grid``: 8 policies x 9 scenarios,
    72 replicas of ``replay_tx_gaia_1h``) for the hour in one batched run
    under sync-debug "error": every replica at ``PINNED_FLEET``, replica 0
    at ``replay_tx_gaia_1h``'s pins, one power_scatter launch a tick;
    FLEET_ALONE rerun alone through ``run_episode`` (in worker processes,
    ``run_alone``); the thermal hour's
    config for FLEET_THERMAL_TICKS at E = 72 (one rack_thermal launch a
    tick) with FLEET_THERMAL_ALONE rerun alone; then ms per tick, us per
    replica-tick, CUDA kernels per tick and the device's busy share at
    E = 1, 72 and 1152 (the grid tiled 16x), alone. ``beside``: runs for
    ``start_alone`` (phase virtual_cloud's what-ifs), started first with
    phase mesh's worlds, beside the grid's hours and the replicas rerun
    alone. Returns (the hour's launches and wall seconds, the results of
    ``beside``)."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core.fleet import run_fleet

    t0 = time.perf_counter()
    beside_handle = start_alone(torch, list(beside))
    try:
        runs = _fleet_checks(torch, jobs, bank, mesh_start(torch), t0)
        beside_runs = join_alone(torch, beside_handle)
    finally:
        stop_alone(beside_handle)

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
    return runs["replay_tx_gaia_1h"], beside_runs


def _fleet_checks(torch, jobs, bank, mesh_run, t0) -> dict:
    """Phase ``fleet``'s hours and their replicas rerun alone, then phase
    ``mesh`` (its worlds started at ``t0``). Returns the hours' launches
    and wall seconds by case."""
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

    runs, finals = {}, {}
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
        emit("fleet", step="grid", **rec, beside=BESIDE_GRID)
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
        finals[case] = final, telem
    # the replicas rerun alone, beside phase mesh's worlds and phase
    # virtual_cloud's what-ifs
    started = time.perf_counter()
    alone_runs = run_alone(torch, alone)
    for (f1, t1), (case, name, scn_id, e, final, telem) in zip(
            alone_runs, checks):
        emit("fleet", step="alone", case=case, policy=name,
             scenario=scn_id, **_alone_vs_fleet(
                 torch, f"fleet {case}", f1, final, e, t1, telem))
    emit("fleet", step="alone runs", runs=len(alone),
         workers=ALONE_WORKERS, wall_s=time.perf_counter() - started)
    mesh(torch, mesh_run, finals)
    emit("fleet", step="alone runs and mesh", wall_s=time.perf_counter() - t0)
    return runs


def virtual_cloud_runs(torch, np) -> list:
    """Phase ``virtual_cloud``'s set-up: the LM workload built on this
    host (numpy and float64, as in the JAX package) and checked against
    its pinned digest, then each pinned what-if's config, statics and
    state on the card, as measured runs for ``run_alone``."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import build_statics, init_state, load_jobs

    t0 = time.perf_counter()
    jobs, bank = A.virtual_cloud_workload()
    digest = A.workload_digest(jobs, bank)
    pinned = A.PINNED_VIRTUAL_CLOUD["digest"]
    emit("virtual_cloud", step="workload", numpy=np.__version__,
         jobs=int(len(jobs["dur"])), digest=digest, pinned=pinned,
         seconds=time.perf_counter() - t0)
    if digest != pinned:
        raise AssertionError(f"virtual cloud workload digest {digest} != "
                             f"pinned {pinned}")
    runs = []
    for name in A.VIRTUAL_CLOUD_PINNED:
        cfg = A.virtual_cloud_config(name)
        statics = build_statics(cfg, bank)
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        runs.append(dict(cfg=cfg, statics=statics, state=state,
                         n_steps=A.VIRTUAL_CLOUD_TICKS,
                         scheduler=A.VIRTUAL_CLOUD_SCHEDULER,
                         kw=dict(summary_only=True), measure=True))
    torch.cuda.synchronize()
    emit("virtual_cloud", step="setup", runs=len(runs),
         seconds=time.perf_counter() - t0)
    return runs


def virtual_cloud(torch, results: list, main_ms: float) -> None:
    """Phase ``virtual_cloud``'s checks (see the module docstring, phase
    16) of the what-ifs' worker results. Raises on any miss."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import summary

    t0 = time.perf_counter()
    for name, (final, telem, run) in zip(A.VIRTUAL_CLOUD_PINNED, results):
        got = summary(final, telem)
        ticks = A.VIRTUAL_CLOUD_TICKS
        emit("virtual_cloud", scenario=name, ticks=ticks,
             scheduler=A.VIRTUAL_CLOUD_SCHEDULER, wall_s=run["wall_s"],
             ms_per_tick=1e3 * run["wall_s"] / ticks,
             replay_tx_gaia_1h_ms_per_tick=main_ms,
             launches=run["launches"], completed=got["completed"],
             energy_kwh=got["energy_kwh"], carbon_kg=got["carbon_kg"],
             avg_pue=got["avg_pue"],
             pins=A.check_virtual_cloud(name, got))
        if run["launches"] != no_launches(power_scatter=ticks):
            raise AssertionError(f"virtual cloud {name}: launches "
                                 f"{run['launches']}")
        for field, v in final._asdict().items():
            ok = (~torch.isnan(v) if field in INF_CLOCKS
                  else torch.isfinite(v))
            if v.is_floating_point() and not bool(ok.all()):
                raise AssertionError(f"virtual cloud {name}: final state "
                                     f"field {field}: bad values")
    emit("virtual_cloud", step="checks", seconds=time.perf_counter() - t0)


def _mesh_fleet_run(torch, mesh, case: str, ticks: int, **kw) -> dict:
    """One rank's ``run_fleet(mesh=)`` of phase ``fleet``'s grid on
    ``case`` for ``ticks`` (the ticks under sync-debug "error"), with this
    rank's launches and counted host reads from 0."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core.fleet import run_fleet
    from repro_torch.utils import device as udev

    jobs, bank = A.workload(A.config())
    cfg = A.config(case)
    statics = build_statics(cfg, bank, device=mesh.device)
    state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
    _, pol, scn = A.fleet_grid(cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    udev.reset_host_reads()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, telem = run_fleet(cfg, statics, state, ticks, policies=pol,
                                 scenarios=scn, summary_only=True, mesh=mesh,
                                 **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(final=final, telem=telem, wall_s=time.perf_counter() - t0,
                launches=dict(kernels.LAUNCHES),
                reads=udev.HOST_READS["count"])


def mesh_fleet_rank(mesh, case: str, snap_dir: str | None) -> dict:
    """A rank of phase ``mesh``'s (a) (the fleet hour with a snapshot
    every MESH_SNAP_S into ``snap_dir``) or (c) (the thermal fleet)."""
    import torch

    from repro_torch.configs import acceptance as A
    from repro_torch.utils.device import exact_matmul

    exact_matmul()
    if snap_dir is None:
        return _mesh_fleet_run(torch, mesh, case, A.FLEET_THERMAL_TICKS)
    return _mesh_fleet_run(torch, mesh, case, A.N_STEPS,
                           snapshot_every_s=MESH_SNAP_S, snapshot_dir=snap_dir)


def mesh_resume_rank(mesh, snap_dir: str) -> dict:
    """A rank of phase ``mesh``'s (b): the fleet hour resumed from the
    newest snapshot in ``snap_dir``."""
    import torch

    from repro_torch.configs import acceptance as A
    from repro_torch.utils.device import exact_matmul

    exact_matmul()
    return _mesh_fleet_run(torch, mesh, "replay_tx_gaia_1h", A.N_STEPS,
                           snapshot_every_s=MESH_SNAP_S, resume_from=snap_dir)


def mesh_ppo_rank(mesh) -> dict:
    """A rank of phase ``mesh``'s (d): ``acceptance.run_ppo_dist`` on
    ``rl_tx_gaia`` twice, the launches and counted host reads of each run
    from 0, one host sync a chunk and none inside it but gloo's."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.envs import SchedEnv
    from repro_torch.utils import device as udev
    from repro_torch.utils.device import exact_matmul

    exact_matmul()
    cfg = A.rl_config("rl_tx_gaia")
    env = SchedEnv(cfg, A.rl_workloads(cfg), **A.rl_env_kwargs(),
                   device=mesh.device)
    runs, drains = [], []
    with counted_drains(torch, drains):
        for _ in range(2):
            torch.cuda.synchronize()
            kernels.reset_launches()
            udev.reset_host_reads()
            t0 = time.perf_counter()
            got, params = A.run_ppo_dist(env, mesh, guard=no_sync(torch))
            torch.cuda.synchronize()
            runs.append(dict(got=got, params=params,
                             wall_s=time.perf_counter() - t0,
                             launches=dict(kernels.LAUNCHES),
                             reads=udev.HOST_READS["count"]))
    return {"runs": runs, "drains": drains}


def mesh_start(torch) -> dict:
    """Start phase ``mesh``'s worlds (``launch.mesh.spawn_world``; every
    rank on cuda:0) in three threads: (a) the fleet hour on a gloo world
    of 2, then (b) an nccl world of 1 resuming (a)'s snapshot at 1,800 s
    as soon as (a) has written it; (d) distributed PPO on a gloo world of
    2, then (c) the thermal fleet on a gloo world of 2; (d) on an nccl
    world of 1. Returns the handle ``mesh`` joins."""
    import shutil
    import threading
    import traceback

    from repro_torch.launch.mesh import spawn_world

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    hour, resume = MESH_DIR / "hour", MESH_DIR / "resume"
    run = {"t0": time.perf_counter(), "results": {}, "errors": {},
           "seconds": {}}

    def world(name, fn, size, backend, args=()):
        t0 = time.perf_counter()
        try:
            run["results"][name] = spawn_world(
                fn, size, backend=backend, devices=["cuda:0"] * size,
                args=args, timeout=MESH_TIMEOUT_S)
        except Exception:    # reported by ``mesh``, which fails the phase
            run["errors"][name] = traceback.format_exc()
        run["seconds"][name] = time.perf_counter() - t0

    def hour_then_resume():
        first = threading.Thread(target=world, args=(
            "hour", mesh_fleet_rank, 2, "gloo",
            ("replay_tx_gaia_1h", str(hour))))
        first.start()
        snap = hour / f"step_{int(MESH_SNAP_S):010d}"
        while not (snap / "manifest.json").exists() and first.is_alive():
            time.sleep(0.2)
        if (snap / "manifest.json").exists():
            shutil.copytree(snap, resume / snap.name)
            world("resume", mesh_resume_rank, 1, "nccl", (str(resume),))
        else:
            run["errors"]["resume"] = "no snapshot at 1,800 s to resume"
        first.join()

    def ppo_then_thermal():
        world("ppo_w2", mesh_ppo_rank, 2, "gloo")
        world("thermal", mesh_fleet_rank, 2, "gloo",
              ("replay_tx_gaia_1h_thermal", None))

    run["threads"] = [threading.Thread(target=fn, args=a, daemon=True)
                      for fn, a in ((hour_then_resume, ()),
                                    (ppo_then_thermal, ()),
                                    (world, ("ppo_w1", mesh_ppo_rank, 1,
                                             "nccl")))]
    for t in run["threads"]:
        t.start()
    return run


def mesh(torch, run: dict, fleet_runs: dict) -> None:
    """Phase ``mesh`` (see the module docstring, phase 15): wait for the
    worlds ``mesh_start`` started and hold them to phase ``fleet``'s runs
    (``fleet_runs``: case -> (final, telemetry), on the card) and to
    ``PINNED_RL_DIST``. Raises on any miss."""
    from repro_torch.configs import acceptance as A

    for t in run["threads"]:
        t.join(timeout=max(1.0, MESH_TIMEOUT_S
                           - (time.perf_counter() - run["t0"])))
    if any(t.is_alive() for t in run["threads"]):
        raise AssertionError("mesh: a world outlived its time limit")
    if run["errors"]:
        raise AssertionError(f"mesh: worlds failed: {run['errors']}")
    res = run["results"]
    want = {case: tuple(type(x)(*(None if v is None else v.cpu()
                                  for v in x)) for x in pair)
            for case, pair in fleet_runs.items()}
    hour_ticks, thermal_ticks = A.N_STEPS, A.FLEET_THERMAL_TICKS
    checks = (  # the launches and reads (MESH_READS) a rank
        ("hour", "replay_tx_gaia_1h", "gloo", no_launches(
            power_scatter=hour_ticks)),
        ("thermal", "replay_tx_gaia_1h_thermal", "gloo",
         no_launches(power_scatter=thermal_ticks,
                     rack_thermal=thermal_ticks)),
        ("resume", "replay_tx_gaia_1h", "nccl", no_launches(
            power_scatter=hour_ticks - int(MESH_SNAP_S))))
    for name, case, backend, launches in checks:
        ranks = res[name]
        for r, got in enumerate(ranks):
            differ = _bitwise(torch, want[case],
                              (got["final"], got["telem"]))
            emit("mesh", step=name, case=case, backend=backend,
                 world=len(ranks), rank=r,
                 replicas=int(got["final"].t.shape[0]),
                 wall_s=got["wall_s"], launches=got["launches"],
                 host_reads=got["reads"], fields_differing=differ,
                 world_s=run["seconds"][name])
            if differ:
                raise AssertionError(f"mesh {name} rank {r}: differs from "
                                     f"phase fleet's run in {differ}")
            if got["launches"] != launches:
                raise AssertionError(f"mesh {name} rank {r}: launches "
                                     f"{got['launches']}, expected "
                                     f"{launches}")
            if got["reads"] != MESH_READS[name]:
                raise AssertionError(f"mesh {name} rank {r}: {got['reads']} "
                                     f"counted host reads, expected "
                                     f"{MESH_READS[name]}")
    ticks = A.RL_ITERATIONS * A.RL_ROLLOUT * A.RL_SIM_STEPS
    for name, backend in (("ppo_w1", "nccl"), ("ppo_w2", "gloo")):
        ranks = res[name]
        for r, got in enumerate(ranks):
            (a, b) = got["runs"]
            report = A.check_ppo_dist(a["got"], len(ranks), r)
            # gloo: two all-reduces a parameter tensor and one of the
            # stats a iteration, each a counted host round trip
            reads = (A.RL_ITERATIONS * (2 * len(a["params"]) + 1)
                     if backend == "gloo" else 0)
            same = a["got"] == b["got"] and all(
                torch.equal(a["params"][k], b["params"][k])
                for k in a["params"])
            emit("mesh", step="ppo", backend=backend, world=len(ranks),
                 rank=r, wall_s=[a["wall_s"], b["wall_s"]],
                 launches=a["launches"], drains=got["drains"],
                 host_reads=[a["reads"], b["reads"]],
                 rerun_bitwise=same, history=a["got"]["history"],
                 world_s=run["seconds"][name], **report)
            if not same:
                raise AssertionError(f"mesh ppo W={len(ranks)} rank {r}: "
                                     "the rerun differs")
            if got["drains"] != [A.RL_ITERATIONS] * 2:
                raise AssertionError(f"mesh ppo: host drains "
                                     f"{got['drains']}, expected one a "
                                     "chunk")
            for x in (a, b):
                if x["launches"] != no_launches(power_scatter=ticks):
                    raise AssertionError(f"mesh ppo W={len(ranks)} rank "
                                         f"{r}: launches {x['launches']}")
                if x["reads"] != reads:
                    raise AssertionError(f"mesh ppo W={len(ranks)} rank "
                                         f"{r}: {x['reads']} counted host "
                                         f"reads, expected {reads}")
    emit("mesh", step="done", seconds=time.perf_counter() - run["t0"],
         worlds_s=run["seconds"])


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

        def counted_drain(stats, *keys):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return drain(stats, *keys)
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


def macro(torch, jobs, bank, per_tick: dict, fleet_hour, early: dict):
    """The macro phase's hours (see the module docstring, phase 8): the
    three replay hours and the fleet hour, each run in a worker beside
    phases rl and macro (``early``: ``early_runs``' results by case),
    checked here; the fleet's replicas rerun alone are started in workers.
    Returns a function that waits for them and holds them to the fleet."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import (
        build_statics,
        init_state,
        load_jobs,
        summary,
        summary_columns,
    )
    from repro_torch.core.fleet import _scenario_list
    from repro_torch.utils.device import tree_to

    start = time.perf_counter()
    # (a) the three replay hours
    for case in A.MACRO_CASES:
        base = A.base_case(case)
        cfg = A.config(case)
        (final, telem), wall, launches, (events, fast), reads = early[case]
        got = summary(final, telem)
        _, pt_final, pt_telem, pt_wall = per_tick[base]
        committed = int(got["ticks_simulated"] - got["macro_steps_taken"])
        pins = A.PINNED_MACRO[case]
        rec = dict(
            case=case, in_worker_beside=EARLY_BESIDE,
            ticks_simulated=got["ticks_simulated"],
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
    (final, telem), wall, launches, (events, fast), reads = early[MACRO_FLEET]
    cols = summary_columns(final, telem)
    committed = int((cols["ticks_simulated"]
                     - cols["macro_steps_taken"]).sum())
    rec = dict(replicas=len(names), ticks=A.N_STEPS,
               in_worker_beside=EARLY_BESIDE, wall_s=wall,
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
    handle = start_alone(torch, alone)

    def finish():
        for e, (f1, t1) in zip(MACRO_FLEET_ALONE, join_alone(torch, handle)):
            emit("macro", step="alone", policy=names[e], **_alone_vs_fleet(
                torch, "macro fleet", f1, final, e, t1, telem))
    return handle, finish


def macro_rl(torch) -> None:
    """The macro phase's RL env (see the module docstring, phase 8):
    ``SchedEnv(macro=True)``'s script and one PPO iteration at the pins,
    then its timings and profile."""
    from repro_torch.configs import acceptance as A
    from repro_torch.envs import SchedEnv
    from repro_torch.tools.profile_tick import profile_rl

    start = time.perf_counter()
    cfg = A.rl_config("rl_tx_gaia")
    env = SchedEnv(cfg, A.rl_workloads(cfg), **A.rl_env_kwargs(macro=True))
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


def faults(torch, np, jobs, bank, per_tick: dict, early: dict) -> None:
    """The faults phase (see the module docstring, phase 9). ``early``:
    ``early_runs``' results by case, the two per-tick hours among them."""
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
    # (a) both hours per tick (run in workers beside phases rl and macro),
    # at the JAX package's per-tick values
    for case in A.FAULT_CASES:
        final, telem, run = early[case]
        hours[case] = check_hour(torch, case, A.config(case), final, telem,
                                 run["launches"], run["wall_s"], "faults",
                                 in_worker_beside=EARLY_BESIDE)
        emit("faults", step="hour", case=case,
             ms_per_tick=1e3 * hours[case][3] / A.N_STEPS,
             replay_tx_gaia_1h_ms_per_tick=main_ms,
             at_s=time.perf_counter() - start)

    # (b) both hours macro-stepped (in workers beside phases rl and macro):
    # bitwise equal to per tick, the pinned event ticks, the read gate, one
    # power_tick launch a tick issued
    for case in A.FAULT_MACRO_CASES:
        base = A.base_case(case)
        cfg = A.config(case)
        (final, telem), wall, launches, (events, fast), reads = early[case]
        got = summary(final, telem)
        _, pt_final, pt_telem, pt_wall = hours[base]
        pins = A.PINNED_FAULTS[case]
        diffs = _against_per_tick(torch, case, (final, telem),
                                  (pt_final, pt_telem))
        emit("faults", step="macro hour", case=case,
             in_worker_beside=EARLY_BESIDE, event_ticks=events,
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


def serving_setup(jobs, bank):
    """(config, statics, state) of ``replay_tx_gaia_1h_serving`` on the
    card: the serving scenario, half the pool asleep."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import build_statics, init_state, load_jobs

    cfg = A.config(A.SERVING_CASE)
    statics = build_statics(cfg, bank, A.serving_scenario(cfg))
    state = A.half_asleep(load_jobs(init_state(cfg, statics, seed=A.SEED),
                                    jobs))
    return cfg, statics, state


def serving(torch, np, jobs, bank, per_tick: dict, early: dict) -> dict:
    """The serving phase (see the module docstring, phase 13). ``early``:
    ``early_runs``' results by case, the per-tick hour among them. Returns
    the profiles of the serving tick and the plain tick, by case."""
    from repro_torch import kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.core import run_episode, summary_columns
    from repro_torch.core.fleet import prepare_fleet
    from repro_torch.envs import SchedEnv
    from repro_torch.tools.profile_tick import profile_replay
    from repro_torch.utils.device import tree_to

    start = time.perf_counter()
    main_ms = 1e3 * per_tick["replay_tx_gaia_1h"][3] / A.N_STEPS
    cfg, statics, state = serving_setup(jobs, bank)

    # (a) the hour per tick (run in a worker beside phases rl and macro),
    # at the JAX package's per-tick values
    final, telem, run = early[A.SERVING_CASE]
    wall, launches = run["wall_s"], run["launches"]
    got = A.serving_summary(final, telem)
    emit("serving", step="hour", case=A.SERVING_CASE, ticks=A.N_STEPS,
         in_worker_beside=EARLY_BESIDE,
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

    # (b) macro-stepped (in a worker beside phases rl and macro): bitwise
    # equal to per tick, the read gate, one power_tick launch a tick issued
    case = A.SERVING_MACRO_CASE
    (mf, mt), mwall, launches, (events, fast), reads = early[case]
    gm = A.serving_summary(mf, mt)
    diffs = _against_per_tick(torch, case, (mf, mt), (final, telem))
    pins = A.PINNED_SERVING[case]
    emit("serving", step="macro hour", case=case,
         in_worker_beside=EARLY_BESIDE, event_ticks=events,
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
            profiles: dict, after_hour=None) -> None:
    """The durable phase (see the module docstring, phase 14).
    ``after_hour``: called once the snapshotted hour, which runs alone on
    the card, is done."""
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

    def hour_done():
        chaos_thread.start()
        if after_hour is not None:
            after_hour()
    try:
        _durable_checks(torch, np, jobs, bank, per_tick, ppo_run, profiles,
                        work, start, after_hour=hour_done)
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



def early_runs(jobs, bank) -> tuple:
    """The runs started beside phases rl and macro (``start_alone``):
    both per-tick hours of phase faults and the one of phase serving
    (``hour_run``), and the macro-stepped hours of phases macro (the three
    replay hours and the fleet hour), faults and serving
    (``macro_hour_run``). Returns (their cases, the runs)."""
    from repro_torch.configs import acceptance as A
    from repro_torch.core import build_statics, init_state, load_jobs

    cases, runs = [], []
    for case in A.FAULT_CASES:
        cfg = A.config(case)
        statics = build_statics(cfg, bank, A.fault_scenario(case, cfg))
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        cases.append(case)
        runs.append(hour_run(case, cfg, statics, state))
    serving = serving_setup(jobs, bank)
    cases.append(A.SERVING_CASE)
    runs.append(hour_run(A.SERVING_CASE, *serving))
    for case in A.FAULT_MACRO_CASES:
        cfg = A.config(case)
        statics = build_statics(cfg, bank, A.fault_scenario(case, cfg))
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        cases.append(case)
        runs.append(macro_hour_run(cfg, statics, state))
    cases.append(A.SERVING_MACRO_CASE)
    runs.append(macro_hour_run(*serving))
    for case in A.MACRO_CASES:
        cfg = A.config(case)
        statics = build_statics(cfg, bank)
        state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
        cases.append(case)
        runs.append(macro_hour_run(cfg, statics, state))
    cfg = A.config()
    statics = build_statics(cfg, bank)
    state = load_jobs(init_state(cfg, statics, seed=A.SEED), jobs)
    _, pol, scn = A.fleet_grid(cfg)
    cases.append(MACRO_FLEET)
    runs.append(macro_hour_run(cfg, statics, state, entry="run_fleet",
                               policies=pol, scenarios=scn,
                               summary_only=True))
    return cases, runs


def lm_pins_runs() -> tuple:
    """The runs started beside phase durable (``start_alone``): the pins
    of phases serve_hybrid, serve_moe, serve_xlstm, serve_whisper and
    serve_vlm and phase train's pinned f32 steps, each model's numpy
    weights drawn in its worker. Returns (their cases, the runs)."""
    from repro_torch.configs import acceptance as A

    cases = [A.MIXTRAL_CASE, A.JAMBA_CASE, *A.LAST_CASES]
    return cases + [A.TRAIN_CASE], (
        [{"entry": "lm_case_pins", "case": c} for c in cases]
        + [{"entry": "train_pins"}])


def determinism(torch, jobs, bank) -> None:
    """Phase 10: the same ticks twice, bitwise."""
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs
    from repro_torch.core import run_episode

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


def main() -> int:
    import shutil

    import numpy as np
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics
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
    for case in ATTN_CASES:
        if case[0] in GRAD_ATTN_CASES:
            record["flash_attn", "gradient", case[0]] = check_attention_grad(
                torch, np, *case)
    record["mamba_scan", "gradient"] = check_scan_grad(torch, np,
                                                       *GRAD_SCAN_CASE)
    torch.cuda.empty_cache()
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

    # 22. train_mesh: its worlds run in a worker of their own, started here
    # (after the timed hours of phases main and thermal) and joined before
    # phase durable
    mesh_train = start_alone(torch, [{"entry": "train_mesh",
                                      "timeout_s": TRAIN_MESH_TIMEOUT_S}])
    atexit.register(stop_alone, mesh_train)   # on a failure before its join
    # 23. train_mesh_families: its weights drawn in a worker of its own on
    # the host meanwhile; its cases run in phase train_mesh's gloo world
    families = start_alone(torch, [{"entry": "train_mesh_families"}])
    atexit.register(stop_alone, families)
    # 24. serve_mesh: gemma3-1b served on a gloo (1, 2) world, and 25.
    # dryrun: launch/dryrun.py's cells on the host, each in a worker of its
    # own, joined before phase serve
    mesh_serve = start_alone(torch, [{"entry": "serve_mesh",
                                      "timeout_s": SERVE_MESH_TIMEOUT_S}])
    atexit.register(stop_alone, mesh_serve)
    dry = start_alone(torch, [{"entry": "dryrun",
                               "timeout_s": DRYRUN_TIMEOUT_S}])
    atexit.register(stop_alone, dry)

    # 6. fleet: the replay tick batched over a replica axis; phase 16's
    # what-ifs and phase 15's worlds run in workers beside its hours
    t0 = time.perf_counter()
    vc_runs = virtual_cloud_runs(torch, np)
    fleet_hour, vc_results = fleet(torch, np, jobs, bank, beside=vc_runs)
    emit("fleet", step="done", seconds=time.perf_counter() - t0)

    # 16. virtual_cloud: the perf model's LM jobs through the twin
    virtual_cloud(torch, vc_results, 1e3 * per_tick["replay_tx_gaia_1h"][3]
                  / acceptance.N_STEPS)

    # the per-tick hours of phases faults and serving and the macro-stepped
    # hours of phases macro, faults and serving run in workers beside phase
    # rl and phase macro's RL env, and are checked in their phases
    t0 = time.perf_counter()
    early_cases, early = early_runs(jobs, bank)
    handle = start_alone(torch, early)
    try:
        # 7. rl: SchedEnv batched over the replica axis, PPO end to end
        t1 = time.perf_counter()
        ppo_run = rl(torch, np)
        emit("rl", step="done", seconds=time.perf_counter() - t1)

        # 8. macro: the RL env with quiet ticks fast-forwarded
        t1 = time.perf_counter()
        macro_rl(torch)
        emit("macro", step="env done", seconds=time.perf_counter() - t1)
        t1 = time.perf_counter()
        early = dict(zip(early_cases, join_alone(torch, handle)))
    finally:
        stop_alone(handle)
    emit("early", runs=early_cases, beside=EARLY_BESIDE,
         worker_wall_s=[handle["wall_s"][i]
                        for i in range(len(early_cases))],
         waited_after_macro_s=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0)

    # 8. macro (continued): the replay hours and the fleet hour against the
    # pins and the per-tick runs above; the fleet's replicas rerun alone in
    # workers beside phases faults and serving
    t0 = time.perf_counter()
    macro_handle, macro_alone = macro(torch, jobs, bank, per_tick,
                                      fleet_hour, early)
    try:
        emit("macro", step="hours done", seconds=time.perf_counter() - t0)

        # 9. faults: the resilience twin's hours, fleet and env
        t0 = time.perf_counter()
        faults(torch, np, jobs, bank, per_tick, early)
        emit("faults", step="done", seconds=time.perf_counter() - t0)

        # 13. serving: the serving twin's hour per tick and macro, its fleet
        # and env (run here, before the LM phases, beside the replay phases)
        t0 = time.perf_counter()
        profiles = serving(torch, np, jobs, bank, per_tick, early)
        emit("serving", step="done", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        macro_alone()
        emit("macro", step="done", waited_after_serving_s=(
            time.perf_counter() - t0))
    finally:
        stop_alone(macro_handle)

    # the pins of phases serve_hybrid, serve_moe, serve_xlstm,
    # serve_whisper and serve_vlm (their numpy weights drawn in the
    # workers) run beside phases durable and determinism
    t0 = time.perf_counter()
    try:
        families_drawn = join_alone(torch, families)[0]
        mesh_trained = join_alone(torch, mesh_train)[0]
    finally:
        stop_alone(families)
        stop_alone(mesh_train)
    shutil.rmtree(TRAIN_FAMILIES_WORK, ignore_errors=True)
    emit("train_mesh", step="joined", worker_wall_s=mesh_train["wall_s"][0],
         waited_s=time.perf_counter() - t0,
         families_drawing_worker_wall_s=families["wall_s"][0])

    lm_cases, lm_runs = lm_pins_runs()
    lm = {}
    try:
        # 14. durable: snapshots, kill and resume, the chaos loop, PPO
        # checkpoints and the invariant harness, against the runs above
        t0 = time.perf_counter()
        durable(torch, np, jobs, bank, per_tick, ppo_run, profiles,
                after_hour=lambda: lm.update(handle=start_alone(torch,
                                                                lm_runs)))
        emit("durable", step="done", seconds=time.perf_counter() - t0)
        determinism(torch, jobs, bank)
        t0 = time.perf_counter()
        pins = dict(zip(lm_cases, join_alone(torch, lm["handle"])))
        emit("lm_pins", runs=lm_cases, beside=LM_PINS_BESIDE,
             worker_wall_s=[lm["handle"]["wall_s"][i]
                            for i in range(len(lm_cases))],
             waited_s=time.perf_counter() - t0)
    finally:
        if "handle" in lm:
            stop_alone(lm["handle"])

    # 11. serve: gemma3-1b at full width; the kernels line reports the
    # flash_attn launches of one prefill
    launches["flash_attn"], one_card = serve(torch, np)

    # 24-25. serve_mesh and dryrun (continued): their workers' runs
    t0 = time.perf_counter()
    try:
        served = join_alone(torch, mesh_serve)[0]
        traced = join_alone(torch, dry)[0]
    finally:
        stop_alone(mesh_serve)
        stop_alone(dry)
    emit("serve_mesh", step="joined", waited_s=time.perf_counter() - t0)
    mesh_prefill = serve_mesh(torch, served, mesh_serve["wall_s"][0],
                              one_card)
    dryrun(traced, dry["wall_s"][0])

    # 12. serve_hybrid: the jamba hybrid at full width; the kernels line
    # reports the selective_scan launches of one 8-layer prefill; its pins
    # ran in a worker (above)
    t0 = time.perf_counter()
    launches["selective_scan"] = serve_hybrid(torch, np,
                                              pins[acceptance.JAMBA_CASE])
    emit("serve_hybrid", step="done", seconds=time.perf_counter() - t0)

    # 17. serve_moe: mixtral-8x22b's experts at full width; its pins ran in
    # a worker (above)
    t0 = time.perf_counter()
    moe_prefill = serve_moe(torch, np, pins[acceptance.MIXTRAL_CASE])
    emit("serve_moe", step="done", seconds=time.perf_counter() - t0)

    # 18-20. serve_xlstm, serve_whisper, serve_vlm: the last three LM
    # families at full width (the VLM cut); their pins ran in workers
    last = {}
    for case in acceptance.LAST_CASES:
        t0 = time.perf_counter()
        last[case] = serve_last(torch, np, case, pins[case])
        emit(case, step="done", seconds=time.perf_counter() - t0)

    # 21. train: gemma3-1b at full width trained on the card; its pinned
    # f32 steps ran in a worker beside phase durable (above)
    t0 = time.perf_counter()
    trained = train(torch, np, pins[acceptance.TRAIN_CASE])
    emit("train", step="done", seconds=time.perf_counter() - t0)

    # 22. train_mesh (continued): the worlds' runs against the pins, the
    # bf16 step on (1, 1) beside phase train's
    t0 = time.perf_counter()
    mesh_launches = train_mesh(torch, mesh_trained, trained,
                               mesh_train["wall_s"][0])
    emit("train_mesh", step="done", seconds=time.perf_counter() - t0)

    # 23. train_mesh_families (continued): the worker's runs against the
    # pins, the launches and the refusals
    t0 = time.perf_counter()
    family_launches = train_mesh_families(
        torch, mesh_trained["families"], families_drawn,
        families["wall_s"][0])
    emit("train_mesh_families", step="done",
         seconds=time.perf_counter() - t0)

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
    emit("script", seconds=time.perf_counter() - t_script)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        **{k: record[main][k] for k in keys},
        "library_ms": record[main].get("library_ms"),
        **({"signature_entry": {k: record[sig][k] for k in keys}}
           if sig else {}),
        **({"mixtral": {"launches_per_serve_mixtral_4l_prefill": moe_prefill,
                        **{k: record["flash_attn", MIXTRAL_ATTN][k]
                           for k in keys + ("library_ms",)}},
            "launches_per_prefill": {
                **{c: r["launches_per_pinned_prefill"]
                   for c, r in last.items()},
                **{r["path_case"]: r["launches_per_path_prefill"]
                   for r in last.values()}},
            "unmasked": {c: {k: record["flash_attn", c][k]
                             for k in keys + ("library_ms",)}
                         for c in NEW_ATTN}}
           if name == "flash_attn" else {}),
        # the training path (phase train): the launches of a bf16 step as
        # counted, and the kernels' autograd Functions against the plain
        # versions' autograd (the wiring: the backward is the plain vjp)
        **({"launches_per_serve_mesh_prefill_per_rank": mesh_prefill,
            "launches_per_train_step": trained["launches_per_train_step"],
            "launches_per_train_mesh_step_per_rank": mesh_launches,
            "launches_per_train_mesh_families_step_per_rank": {
                c: v["flash_attn"] for c, v in family_launches.items()},
            "backward": GRAD_BACKWARD,
            "gradient": {c: {k: v for k, v in record[
                "flash_attn", "gradient", c].items() if k in GRAD_KEYS}
                         for c in GRAD_ATTN_CASES}}
           if name == "flash_attn" else {}),
        **({"backward": GRAD_BACKWARD,
            "gradient": {k: v for k, v in record[
                "mamba_scan", "gradient"].items() if k in GRAD_KEYS},
            "launches_per_train_mesh_families_step_per_rank": {
                c: v["selective_scan"] for c, v in family_launches.items()}}
           if name == "selective_scan" else {}),
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
