"""The port's acceptance cases: one hour of trace replay on the full
TX-GAIA twin (672 nodes, 21 racks), the JAX package's benches, and one
LM serving case at full width (``serve_gemma3_1b``, at the end).

- ``replay_tx_gaia_1h``: thermals off (``benchmarks/bench_sim.py:44-60``).
- ``replay_tx_gaia_1h_thermal``: the rack thermal twin on
  (``bench_thermal``, ``benchmarks/bench_sim.py:303-341``). At TX-GAIA's
  default thresholds no rack reaches the throttle or the trip, so it
  drives the RC loop and the dynamic COP.
- ``replay_tx_gaia_1h_thermal_stress``: the same with a short rack time
  constant and low thresholds, so racks ride the throttle ramp and cross
  the dispatch trip at full width.

``PINNED[case]`` holds what the JAX package's ``run_episode(...,
"replay", summary_only=True)`` + ``summary(state, telemetry)`` give for
each case on the CPU (jax 0.9.0). ``chip_smoke.py`` holds the port's run
on the card to these values, and ``tests/test_torch_replay.py`` and
``tests/test_torch_thermal.py`` keep them honest against a live
reference run.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, get_arch
from repro_torch.configs.sim import SimConfig, tx_gaia
from repro_torch.data.synth_trace import synth_workload

N_STEPS = 3600
SCHEDULER = "replay"
SEED = 0

# racks ride the throttle ramp and cross the trip within the hour
THERMAL_STRESS = dict(rack_tau_s=120.0, thermal_trip_c=26.0,
                      throttle_start_c=24.0, throttle_full_c=34.0)

CASES = {
    "replay_tx_gaia_1h": {},
    "replay_tx_gaia_1h_thermal": dict(thermal_enabled=True),
    "replay_tx_gaia_1h_thermal_stress": dict(thermal_enabled=True,
                                             **THERMAL_STRESS),
}

PINNED = {
    "replay_tx_gaia_1h": {
        "completed": 103.0,
        "energy_kwh": 264.79302978515625,
        "avg_pue": 1.2523986388179378,
        "mean_wait_s": 0.7530097591066823,
        "carbon_kg": 132.01934814453125,
    },
    "replay_tx_gaia_1h_thermal": {
        "completed": 103.0,
        "energy_kwh": 266.0106201171875,
        "avg_pue": 1.2581575082100478,
        "peak_rack_outlet_c": 28.327625274658203,
        "thermal_throttle_s": 0.0,
        "mean_cop": 5.6555938720703125,
        "carbon_kg": 132.62652587890625,
        "mean_wait_s": 0.7530097591066823,
    },
    "replay_tx_gaia_1h_thermal_stress": {
        "completed": 94.0,
        "energy_kwh": 264.5250549316406,
        "avg_pue": 1.2582372818223801,
        "peak_rack_outlet_c": 27.689422607421875,
        "thermal_throttle_s": 3020.0,
        "mean_cop": 5.653233528137207,
        "carbon_kg": 131.8872528076172,
        "mean_wait_s": 0.7990804631659325,
    },
}
RTOL = 1e-5   # float metrics; "completed" must match exactly


def config(case: str = "replay_tx_gaia_1h") -> SimConfig:
    return tx_gaia(max_jobs=256, max_nodes_per_job=16, **CASES[case])


def workload(cfg: SimConfig):
    """(jobs dict, trace bank): 200 synthetic jobs over one hour."""
    return synth_workload(cfg, 200, 3600.0, seed=SEED)


def check(case: str, got: dict) -> None:
    """Raise unless the summary ``got`` meets ``PINNED[case]``: the
    completion count exactly, every other value to ``RTOL``."""
    pins = PINNED[case]
    if got["completed"] != pins["completed"]:
        raise AssertionError(f"{case}: completed {got['completed']} != "
                             f"pinned {pins['completed']}")
    for k, v in pins.items():
        if abs(got[k] - v) > RTOL * abs(v):
            raise AssertionError(f"{case}: {k} {got[k]!r} vs pinned {v!r} "
                                 f"(rtol {RTOL})")


# ---------------------------------------------------------------------------
# LM serving: gemma3-1b at full width and full depth (26 layers, d_model
# 1152, 4 query heads over 1 KV head of 256, d_ff 6912, vocab 262144, 5
# sliding-window layers of 512 for every global one), weights from
# ``models.seeded_numpy_params(cfg, LM_SEED)``. B = 2 prompts of S = 1024
# token ids, then LM_DECODE decode steps that feed the next seeded ids
# (teacher forcing: the logits' top-1/top-2 margins are small enough that
# free-running greedy tokens of two implementations can part).
#
# ``PINNED_LM`` holds, for the prefill's last-token logits and each decode
# step's logits (9 rows of B), what the JAX package gives on the CPU (jax
# 0.9.0, ``dtype="float32"``, ``ShardCtx(enabled=False,
# attention_impl="pallas")``): the argmax id, the top-1 value, the
# top-1/top-2 margin, the logsumexp and the first 8 logits.
# ``tests/test_torch_lm_pins.py`` re-derives them from the JAX package.
LM_CASE = "serve_gemma3_1b"
LM_ARCH = "gemma3-1b"
LM_SEED = 0
LM_TOKEN_SEED = 1
LM_BATCH, LM_PROMPT, LM_DECODE = 2, 1024, 8
LM_HEAD = 8           # leading logits pinned per row
# f32: the port on the CPU differs from these pins by at most 1.15e-6 on the
# pinned values (2.3e-6 on any logit); 2e-5 is ~17x that
LM_F32_TOL = 2e-5
# bf16: the tolerance of the JAX package's own bf16 kernel sweeps
# (tests/test_kernels.py); argmax ids are reported, not required: the
# pinned margins are below bf16's rounding over 26 layers
LM_BF16_TOL = 2e-2

PINNED_LM = {
    "argmax": [
        [53346, 15498],
        [224323, 59974],
        [245041, 137630],
        [149112, 219208],
        [28960, 164546],
        [134379, 59232],
        [239696, 27198],
        [53346, 142896],
        [78894, 152047],
    ],
    "top1": [
        [0.2892238, 0.30742994],
        [0.27247918, 0.30222762],
        [0.28916112, 0.2963223],
        [0.3018558, 0.2956701],
        [0.28862315, 0.34058672],
        [0.27839446, 0.3025804],
        [0.2786026, 0.29019263],
        [0.30753615, 0.30861902],
        [0.2819583, 0.2843941],
    ],
    "margin": [
        [0.0007875562, 0.0109036565],
        [0.009554148, 0.0047086477],
        [0.0050823987, 0.0035399497],
        [0.0033973157, 0.0027458072],
        [0.0055633187, 0.04702571],
        [0.0013511479, 0.0010898113],
        [0.0041494668, 0.0013379753],
        [0.021882385, 0.015166402],
        [0.0014671385, 0.0022643507],
    ],
    "logsumexp": [
        [12.478757327146198, 12.478797195077595],
        [12.47874174893679, 12.478863904416013],
        [12.47869956116732, 12.478781389751376],
        [12.478765834286781, 12.478795051320926],
        [12.478811153787317, 12.478706575848083],
        [12.478668408530012, 12.478729213103442],
        [12.478800319827966, 12.478711446545246],
        [12.478674219217487, 12.478903188683653],
        [12.478810564643899, 12.478740014167215],
    ],
    "head": [
        [[-0.0910468, -0.08977761, -0.15731438, 0.080099404,
          -0.045366418, -0.051061906, -0.018717963, -0.04126195],
         [-0.0021547936, 0.082319796, -0.08707261, -0.092703655,
          0.07613732, 0.0323464, 0.013750628, 0.041549698]],
        [[-0.052601885, -0.10010053, -0.23429209, 0.104133755,
          -0.07386262, -0.08665863, 0.005427612, -0.08781675],
         [-0.062969536, 0.012521174, -0.09614364, -0.05358362,
          0.027428783, 0.04165875, -0.015954226, 0.029944172]],
        [[-0.08065684, -0.057097394, -0.18706945, 0.08670503,
          -0.024640817, -0.07714461, -0.034007676, -0.030448446],
         [-0.0635296, 0.087770514, -0.1352616, -0.0564529,
          0.032834034, 0.05515341, 0.015082952, 0.065850034]],
        [[-0.014545588, -0.085161425, -0.1883892, 0.04073745,
          0.03854259, -0.075137444, -0.044445775, -0.061561964],
         [-0.06382345, 0.022014946, -0.09162172, -0.09633184,
          0.07975662, 0.14359477, -0.045225378, 0.0017014858]],
        [[-0.041620277, -0.06327879, -0.18569471, 0.02044253,
          -0.09498028, -0.049365945, -0.038978066, -0.023364425],
         [-0.047362793, 0.009653829, -0.06274642, -0.08452208,
          0.072083674, 0.10447545, 0.00883838, 0.07692335]],
        [[-0.04544986, -0.07189448, -0.14737317, 0.056512468,
          -0.08107268, -0.019176854, -0.040500008, 0.017408427],
         [-0.029982876, -0.00017880765, -0.13827626, -0.10798071,
          0.1210044, 0.079678476, 0.0029856786, 0.05828046]],
        [[-0.09194204, -0.1052811, -0.139429, 0.07451099,
          -0.054462645, -0.02891361, -0.14447063, 0.05468204],
         [-0.06295787, 0.029336346, -0.043341834, -0.05759287,
          0.0957381, 0.059240162, -0.022931028, 0.059012618]],
        [[-0.005520685, -0.1011969, -0.2119996, 0.14369048,
          -0.08894695, -0.101595156, -0.02443548, 0.013856152],
         [-0.06854001, -0.009351629, -0.076496564, -0.055651084,
          0.098902166, 0.078961775, -0.03966884, 0.029794684]],
        [[-0.042343035, -0.05846789, -0.1958741, 0.05411911,
          -0.10451644, -0.027528446, -0.066058435, -0.053771123],
         [-0.06802771, 0.060912907, -0.11505783, -0.051831443,
          0.05121908, 0.09020547, -0.027419936, 0.017867472]],
    ],
}


def lm_config(dtype: str = "float32") -> ModelConfig:
    return dataclasses.replace(get_arch(LM_ARCH), dtype=dtype)


def lm_tokens(cfg: ModelConfig) -> np.ndarray:
    """(B, S + LM_DECODE) int32 token ids: the prompt, then the ids the
    decode steps feed."""
    rng = np.random.default_rng(LM_TOKEN_SEED)
    return rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT + LM_DECODE),
                        dtype=np.int32)


def run_lm(model, tokens):
    """The case on the port: prefill ``tokens[:, :S]`` into a cache of
    S + LM_DECODE, then one decode step per fed id. Returns the
    1 + LM_DECODE (B, V) f32 logits."""
    from repro_torch.models.model import decode_step, prefill

    logits, cache = prefill(model, tokens[:, :LM_PROMPT],
                            cache_seq_len=LM_PROMPT + LM_DECODE)
    out = [logits]
    for i in range(LM_DECODE):
        pos = LM_PROMPT + i
        logits, cache = decode_step(model, cache, tokens[:, pos:pos + 1], pos)
        out.append(logits)
    return out


def lm_summary(logits) -> dict:
    """The pinned quantities of a list of (B, V) f32 logits (numpy arrays
    or tensors), as nested lists: one row per logits, one entry per
    prompt."""
    a = np.stack([np.asarray(x, dtype=np.float32) for x in logits])
    top2 = -np.sort(-a, axis=-1)[..., :2].astype(np.float64)
    a64 = a.astype(np.float64)
    mx = a64.max(-1, keepdims=True)
    lse = (mx[..., 0] + np.log(np.exp(a64 - mx).sum(-1)))
    return {
        "argmax": a.argmax(-1).tolist(),
        "top1": top2[..., 0].tolist(),
        "margin": (top2[..., 0] - top2[..., 1]).tolist(),
        "logsumexp": lse.tolist(),
        "head": a[..., :LM_HEAD].astype(np.float64).tolist(),
    }


def check_lm(got: dict, dtype: str, pins: dict | None = None) -> dict:
    """Hold ``lm_summary`` of a run in ``dtype`` to the pins: the top-1
    value, the logsumexp and the leading logits within ``tol + tol *
    |pin|``; in f32 also the margins, and every argmax id equal. Raises on
    a miss; returns the largest errors and how many argmax ids agree."""
    pins = pins or PINNED_LM
    tol = {"float32": LM_F32_TOL, "bfloat16": LM_BF16_TOL}[dtype]
    keys = ["top1", "logsumexp", "head"]
    if dtype == "float32":
        keys.append("margin")
    report = {"dtype": dtype, "tol": tol}
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(pins[k])
        err = np.abs(g - w)
        report[f"max_abs_err_{k}"] = float(err.max())
        if not np.all(err <= tol + tol * np.abs(w)):
            raise AssertionError(
                f"{LM_CASE} ({dtype}): {k} off the pins by up to "
                f"{err.max():.3g} (tol {tol})")
    same = np.asarray(got["argmax"]) == np.asarray(pins["argmax"])
    report["argmax_agree"] = int(same.sum())
    report["argmax_total"] = int(same.size)
    if dtype == "float32" and not same.all():
        raise AssertionError(f"{LM_CASE} (f32): argmax ids differ from the "
                             f"pins at {np.argwhere(~same).tolist()}")
    return report
