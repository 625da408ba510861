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
             E=1 and 64, ``rack_tick`` at E=1 and 64) also against the CPU
             plain version: per-node and per-rack values bitwise. An empty
             kernel's back-to-back time is the launch floor.
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
             tick and the device's busy share at E = 1, 72 and 1152.
7. determinism  the first 600 ticks of the main path and the first 900 of
             the thermal stress hour, each twice: every field bitwise equal.
8. serve     gemma3-1b at full width and depth (``serve_gemma3_1b``,
             weights from ``seeded_numpy_params``): the f32 and the bf16
             model held to the JAX package's pins (``check_lm``), 26
             flash_attn launches per prefill and none per decode step, the
             bf16 prefill/decode invariant, and ``generate`` at B = 4,
             prompt 1024, 32 new tokens under sync-debug "error" (prefill
             ms, decode ms per token, tokens/s: median of 5 runs).
9. serve_hybrid  the jamba hybrid without experts at full width:
             ``serve_jamba_1l`` (one Mamba layer, f32) held to
             ``PINNED_JAMBA``; ``serve_jamba_8l`` (one whole 7:1 period,
             random weights from ``init_params`` on the card) in f32 and in
             bf16: the prefill/decode invariant (f32 within 1e-4; in bf16
             the decode step within twice the bf16 prefill's distance from
             the f32 model's answer), 7 selective_scan (the Mamba mixer's
             fused ``mamba_scan``) and 1 flash_attn launches per prefill
             and none per decode step; then ``generate`` in bf16 as in
             ``serve``.

The launch counts are set to 0 just before each path and read just after.
Then the ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. It needs no network, and exits non-zero
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import json
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
DETERMINISM = (("replay_tx_gaia_1h", 600),
               ("replay_tx_gaia_1h_thermal_stress", 900))
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
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_RUNS = 4, 1024, 32, 5
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
FLEET_TIMING = 600
FLEET_PROFILE = (300, 30)


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


def tick_state(torch, np, cfg, n_rep: int, seed: int):
    """Seeded per-tick state of ``n_rep`` replicas at the main path's
    shapes, as ``power_tick`` takes it: ~70% of the jobs running at ages
    across the trace quanta, a third of the slots -1, ~5% nodes down,
    outlet temperatures across the throttle ramp, a wetbulb."""
    rng = np.random.default_rng(seed)
    J, K, N, R = cfg.max_jobs, cfg.max_nodes_per_job, cfg.n_nodes, cfg.n_racks
    place = rng.integers(0, N, (n_rep, J, K))
    place[rng.random((n_rep, J, K)) < 0.33] = -1
    lo, hi = cfg.throttle_start_c - 10.0, cfg.throttle_full_c + 5.0
    arrays = ((rng.choice([1, 2, 2, 2, 3], (n_rep, J)), np.int32),
              (rng.uniform(600, 3600, n_rep), np.float32),
              (rng.uniform(0, 3000, (n_rep, J)), np.float32),
              (place, np.int32),
              (rng.uniform(1, 24, (n_rep, 3, J)), np.float32),
              (rng.random((n_rep, N)) > 0.05, np.float32),
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


def rack_tick_inputs(torch, np, cfg, n_rep: int, seed: int):
    """Seeded inputs of the thermal tail: post-throttle node input power,
    the cap's scale, a wetbulb, outlet temperatures across the throttle
    ramp and a running peak."""
    rng = np.random.default_rng(seed)
    N, R = cfg.n_nodes, cfg.n_racks

    def t(a):
        return torch.tensor(np.array(a, np.float32, order="C"), device="cuda")

    return [t(rng.uniform(150.0, 1400.0, (n_rep, N))),
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


def drive(torch, case: str, cfg, statics, jobs, phase: str) -> dict:
    """One hour of ``case`` on the card, the ticks under sync-debug
    "error": held to the pinned values, one power_scatter launch per tick
    and, with the thermal twin on, one rack_thermal launch per tick."""
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
    pins = acceptance.PINNED[case]
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
    return launches


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
    FLEET_ALONE rerun alone through ``run_episode``; the thermal hour's
    config for FLEET_THERMAL_TICKS at E = 72 (one rack_thermal launch a
    tick) with FLEET_THERMAL_ALONE rerun alone; then ms per tick, us per
    replica-tick, CUDA kernels per tick and the device's busy share at
    E = 1, 72 and 1152 (the grid tiled 16x). Returns the hour's launches."""
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
    from repro_torch.utils.device import tree_to

    def no_launches(**kw):
        return {"power_scatter": 0, "rack_thermal": 0, "node_power": 0,
                "flash_attn": 0, "selective_scan": 0, **kw}

    runs = {}
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
            f1, t1 = run_episode(cfg, st, state._replace(key=final.key[e]),
                                 ticks, sel, placement=place,
                                 summary_only=True)
            emit("fleet", step="alone", case=case, policy=names[e],
                 scenario=e % n_scn,
                 **_alone_vs_fleet(torch, f"fleet {case}", f1, final, e,
                                   t1, telem))
        runs[case] = launches

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
    for n_rep in (1, 64):
        rs = cthermal.rack_tick_statics(tcfg, tstatics)
        a = rack_tick_inputs(torch, np, tcfg, n_rep, seed=n_rep)
        # a multiply and an add per node, ~12 operations per rack
        rt_bound = bound(nbytes(a) + nbytes((rs.rack_ptr, rs.rack_nodes,
                                             rs.r_th)),
                         4 * n_rep * (n_racks + 3),
                         n_rep * (2 * n_nodes + 12 * n_racks))
        record["rack_tick", n_rep] = check_tick_kernel(
            torch, "rack_tick", prt.rack_tick, prt.rack_tick_torch,
            cthermal.rack_tick_statics(tcfg, cpu_bank), rs, a, *rt_bound,
            bitwise=(0, 1, 2, 3), replicas=n_rep, nodes=n_nodes,
            racks=n_racks)
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
    launches = drive(torch, "replay_tx_gaia_1h", cfg, statics, jobs, "main")

    # 5. the thermal twin: both hours; the kernels line reports the first
    # hour's rack_thermal launches
    thermal = []
    for case in THERMAL_CASES:
        tcfg = acceptance.config(case)
        thermal.append(drive(torch, case, tcfg, build_statics(tcfg, bank),
                             jobs, "thermal"))
    launches["rack_thermal"] = thermal[0]["rack_thermal"]

    # 6. fleet: the replay tick batched over a replica axis
    t0 = time.perf_counter()
    fleet(torch, np, jobs, bank)
    emit("fleet", step="done", seconds=time.perf_counter() - t0)

    # 7. determinism: the same ticks twice, bitwise
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

    # 8. serve: gemma3-1b at full width; the kernels line reports the
    # flash_attn launches of one prefill
    launches["flash_attn"] = serve(torch, np)

    # 9. serve_hybrid: the jamba hybrid at full width; the kernels line
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
    sys.exit(main())
