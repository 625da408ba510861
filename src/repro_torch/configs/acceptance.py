"""The port's acceptance cases: one hour of trace replay on the full
TX-GAIA twin (672 nodes, 21 racks), the JAX package's benches, and the LM
serving cases at full width (``serve_gemma3_1b``, then the jamba hybrid's
``serve_jamba_1l`` and ``serve_jamba_8l``, at the end).

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

from repro_torch.configs.base import ModelConfig, MoEConfig, get_arch
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


def lm_tokens(cfg: ModelConfig, batch: int = LM_BATCH,
              prompt: int = LM_PROMPT, decode: int = LM_DECODE) -> np.ndarray:
    """(B, S + decode) int32 token ids: the prompt, then the ids the
    decode steps feed."""
    rng = np.random.default_rng(LM_TOKEN_SEED)
    return rng.integers(0, cfg.vocab, (batch, prompt + decode),
                        dtype=np.int32)


def run_lm(model, tokens, prompt: int = LM_PROMPT, decode: int = LM_DECODE):
    """The case on the port: prefill ``tokens[:, :prompt]`` into a cache
    of prompt + decode, then one decode step per fed id. Returns the
    1 + decode (B, V) f32 logits."""
    from repro_torch.models.model import decode_step, prefill

    logits, cache = prefill(model, tokens[:, :prompt],
                            cache_seq_len=prompt + decode)
    out = [logits]
    for i in range(decode):
        pos = prompt + i
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


def check_lm(got: dict, dtype: str, pins: dict | None = None,
             case: str = LM_CASE) -> dict:
    """Hold ``lm_summary`` of a run in ``dtype`` to the pins of ``case``
    (``PINNED_LM`` by default): the top-1 value, the logsumexp and the
    leading logits within ``tol + tol * |pin|``; in f32 also the margins,
    and every argmax id equal. Raises on a miss; returns the largest
    errors and how many argmax ids agree."""
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
                f"{case} ({dtype}): {k} off the pins by up to "
                f"{err.max():.3g} (tol {tol})")
    same = np.asarray(got["argmax"]) == np.asarray(pins["argmax"])
    report["argmax_agree"] = int(same.sum())
    report["argmax_total"] = int(same.size)
    if dtype == "float32" and not same.all():
        raise AssertionError(f"{case} (f32): argmax ids differ from the "
                             f"pins at {np.argwhere(~same).tolist()}")
    return report


# ---------------------------------------------------------------------------
# LM serving: the jamba hybrid (jamba-1.5-large-398b, arXiv:2403.19887) at
# full width without its experts: d_model 8192, 64 query heads over 8 KV
# heads of 128, d_ff 24576, vocab 65536, d_inner 16384, d_state 16, d_conv
# 4, dt_rank 512; per 8 layers 7 Mamba mixers and one attention layer (at
# position 3), each with the dense gated MLP. ``jamba_config`` lists the
# cuts.
#
# - ``serve_jamba_1l`` (correctness, f32): one layer, the pattern's first
#   (a Mamba mixer + the MLP; 2,098,077,696 parameters, 8.4 GB), weights
#   from ``models.seeded_numpy_params(cfg, JAMBA_SEED)``; B = 2 prompts of
#   640 ids (2.5 of the JAX package's 256-step scan chunks: the carried
#   state and a ragged last chunk), then JAMBA_DECODE teacher-forced decode
#   steps. ``PINNED_JAMBA`` holds what the JAX package gives for it on the
#   CPU (jax 0.9.0, ``ShardCtx(enabled=False)``), in ``lm_summary``'s form;
#   ``check_lm(..., pins=PINNED_JAMBA, case=JAMBA_CASE)`` holds a run to
#   them. ``tests/test_torch_lm_pins.py`` re-derives them.
# - ``serve_jamba_8l`` (the path): eight layers, one whole 7:1 period
#   (8,999,034,880 parameters: 36.0 GB of f32 masters, 18.0 GB more for the
#   bf16 copies), weights from the port's ``init_params`` on the card.
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_CASE = "serve_jamba_1l"
JAMBA_PATH_CASE = "serve_jamba_8l"
JAMBA_SEED = 0
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_DECODE = 2, 640, 8
JAMBA_PATH_LAYERS = 8


def jamba_config(n_layers: int, dtype: str = "float32") -> ModelConfig:
    """jamba-1.5-large-398b as the port serves it. Cut from the JAX
    package's config: the experts (16, top-2, on every second layer) become
    the dense gated MLP of d_ff 24576 on every layer (``MoEConfig()``; the
    experts come with the MoE slice), and 72 layers become ``n_layers`` (1
    or 8 here: 16 layers of f32 masters and bf16 copies would not fit on an
    80 GB card). Every width is kept."""
    return dataclasses.replace(get_arch(JAMBA_ARCH), moe=MoEConfig(),
                               n_layers=n_layers, dtype=dtype)


PINNED_JAMBA = {
    "argmax": [
        [6169, 1664],
        [9423, 14279],
        [30804, 24935],
        [17775, 5980],
        [40949, 29627],
        [34539, 2818],
        [34351, 2744],
        [49543, 64177],
        [47788, 1314],
    ],
    "top1": [
        [4.26663, 4.004552],
        [4.313971, 4.137798],
        [4.86158, 4.4081583],
        [4.050841, 4.0174265],
        [4.7239604, 4.330844],
        [3.9554791, 4.0812635],
        [4.2800274, 4.848716],
        [4.5665817, 3.977894],
        [4.125366, 4.3677573],
    ],
    "margin": [
        [0.044883728, 0.08437371],
        [0.14649391, 0.07010889],
        [0.62314653, 0.31644154],
        [0.052912474, 0.07705879],
        [0.35744238, 0.4615929],
        [0.26742172, 0.13928485],
        [0.5080457, 0.6415725],
        [0.47680426, 0.2843945],
        [0.009070396, 0.12563229],
    ],
    "logsumexp": [
        [11.594459117495877, 11.584887817570692],
        [11.587633404206631, 11.586332516444873],
        [11.592753720694796, 11.592056082589277],
        [11.594529502942022, 11.589943471303755],
        [11.589613995359507, 11.584681951580887],
        [11.593039908721398, 11.586396719281742],
        [11.594426989545315, 11.599211989206568],
        [11.583752332872471, 11.589534641273474],
        [11.591181723388935, 11.59577622863796],
    ],
    "head": [
        [[0.0817264, -0.35211003, 0.635935, 0.8664484,
          1.0162818, 0.43057883, 0.24072886, -1.7679887],
         [-0.26660788, 1.092166, -1.2304416, 1.8111213,
          -1.3632638, -0.9346876, -1.4413837, 0.6792925]],
        [[0.04469548, 0.91833425, -0.020644277, 0.48844755,
          0.86563575, 0.39050645, -2.0817142, -0.018901039],
         [1.618506, -0.26093176, 0.2516619, 0.74933255,
          -1.1518176, -0.91874075, 0.42181808, -0.7737146]],
        [[0.68887854, -0.8613727, -1.72057, -1.6259968,
          -0.49318868, -1.1485087, -0.029513977, 0.23372434],
         [-0.15281923, 0.6988482, -0.111050606, 1.0338627,
          1.8752282, -0.3216526, -0.5558152, -1.6755627]],
        [[-0.48146337, 0.80798423, -1.7016534, 0.2099821,
          -0.78266746, 1.920819, 2.4883657, 0.31472078],
         [-0.078014016, -1.0893685, -0.63491285, -1.7761304,
          0.11694802, -0.66514254, 0.072054446, 0.8201549]],
        [[0.18427956, -0.8236083, -0.5973642, -1.5327412,
          -1.1012139, 1.2691613, 1.2901788, 1.4178624],
         [0.104516, -0.6681217, 1.3065315, 1.0089612,
          -0.82871276, 0.7232224, 1.1564684, 0.11401411]],
        [[1.2973205, -1.2428178, 0.5726751, 0.33562186,
          -0.64264095, 0.54941845, -0.2494053, -0.111297876],
         [0.8355464, 1.0573403, -1.8426775, -0.70718604,
          0.36842513, 0.43562812, 1.7699851, 0.78844666]],
        [[0.028212717, -0.20451023, -0.67776304, 1.2666166,
          -0.37048873, -0.013444811, 1.6659143, -0.40289617],
         [-0.83483094, 1.2301255, 0.4311179, 0.054315507,
          1.1685724, 0.60264343, -0.46326095, 0.41428027]],
        [[-0.763685, -0.9356588, 1.1465094, -1.1462969,
          -0.03198898, -2.4039068, 0.44922674, -0.14201684],
         [1.1865574, 0.5259769, 1.580555, -0.5041403,
          -0.45831692, -0.5059694, 0.76897234, -0.040527984]],
        [[0.03003712, -0.51256895, -0.47901925, -0.9542707,
          -0.48987547, -0.104789436, 1.0377724, -1.3557949],
         [0.6841691, -1.5831501, 0.824024, -0.2982995,
          0.19363382, 0.59195757, 0.9863852, 0.19702941]],
    ],
}
