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
- ``fleet_tx_gaia_1h``: ``replay_tx_gaia_1h`` as a fleet of 72 replicas
  (8 policies x 9 grid scenarios, ``fleet_grid``), pinned per replica in
  ``PINNED_FLEET``.

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


# ---------------------------------------------------------------------------
# The fleet case: ``replay_tx_gaia_1h``'s config, workload and 3600 ticks
# (``summary_only``) over a policy x scenario grid in one batched run,
# ``policy_scenario_grid(policy_grid(FLEET_SELECTS, FLEET_PLACES)[1],
# fleet_scenarios(cfg))``: 8 policies x 9 scenarios = 72 replicas, replica
# i = policy i // 9 with scenario i % 9. The scenarios are the default grid,
# ``sample_scenarios(cfg, 7, seed=SEED)`` and one ``demand_response`` whose
# cap binds inside the hour (the one demand-response window the sampler
# draws opens after 8 h). Replica 0 (replay + first_fit, default grid) is
# ``replay_tx_gaia_1h``.
FLEET_CASE = "fleet_tx_gaia_1h"
FLEET_SELECTS = ("replay", "fcfs", "sjf", "easy")
FLEET_PLACES = ("first_fit", "best_fit")
FLEET_SAMPLED = 7
# facility cap: 35% of the IT nameplate from 30 min on
FLEET_DR = dict(cap_frac=0.35, event_start_s=1800.0, event_len_s=3600.0)
FLEET_KEYS = ("energy_kwh", "carbon_kg", "elec_cost_usd", "avg_pue")
# replicas the card reruns alone through run_episode: the first, one of
# each other policy family, the demand-response replica and the last
FLEET_ALONE = (0, 9, 27, 63, 71)
FLEET_THERMAL_TICKS = 600
FLEET_THERMAL_ALONE = (0, 71)


# ``PINNED_FLEET``: what the JAX package's vmapped ``run_fleet`` gives for
# the fleet case on the CPU (jax 0.9.0), per replica, made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fleet_pins.py
# (72 replicas in 67 s on 8 cores). The demand-response replicas (every
# ninth, from 8) run at a mean DVFS throttle of 0.65 and complete 63 jobs.
PINNED_FLEET = {
    "completed": [
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0,
        104.0, 104.0, 104.0, 104.0, 104.0, 104.0, 104.0, 104.0, 63.0,
        104.0, 104.0, 104.0, 104.0, 104.0, 104.0, 104.0, 104.0, 63.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0,
    ],
    "energy_kwh": [
        264.79302978515625, 267.3382873535156, 266.855224609375,
        268.6934814453125, 267.1015319824219, 268.2316589355469,
        269.00689697265625, 265.34088134765625, 254.84127807617188,
        264.8257141113281, 267.3713684082031, 266.88787841796875,
        268.7263488769531, 267.1347961425781, 268.2645568847656,
        269.0401306152344, 265.3737487792969, 254.8614501953125,
        264.79302978515625, 267.3382873535156, 266.855224609375,
        268.6934814453125, 267.1015319824219, 268.2316589355469,
        269.00689697265625, 265.34088134765625, 254.84127807617188,
        264.8257141113281, 267.3713684082031, 266.88787841796875,
        268.7263488769531, 267.1347961425781, 268.2645568847656,
        269.0401306152344, 265.3737487792969, 254.8614501953125,
        264.79730224609375, 267.3423156738281, 266.8589782714844,
        268.6976318359375, 267.1056823730469, 268.2356872558594,
        269.0105895996094, 265.344970703125, 254.84408569335938,
        264.8282470703125, 267.3741149902344, 266.89056396484375,
        268.729248046875, 267.1372375488281, 268.26708984375,
        269.04229736328125, 265.37652587890625, 254.86317443847656,
        264.79302978515625, 267.3382873535156, 266.855224609375,
        268.6934814453125, 267.1015319824219, 268.2316589355469,
        269.00689697265625, 265.34088134765625, 254.84127807617188,
        264.8257141113281, 267.3713684082031, 266.88787841796875,
        268.7263488769531, 267.1347961425781, 268.2645568847656,
        269.0401306152344, 265.3737487792969, 254.8614501953125,
    ],
    "carbon_kg": [
        132.01934814453125, 136.42376708984375, 135.14389038085938,
        95.38638305664062, 143.74264526367188, 134.1333770751953,
        143.54153442382812, 132.9582061767578, 127.0703353881836,
        132.03536987304688, 136.44029235839844, 135.16050720214844,
        95.3981704711914, 143.76036071777344, 134.1495361328125,
        143.55897521972656, 132.97434997558594, 127.08051300048828,
        132.01934814453125, 136.42376708984375, 135.14389038085938,
        95.38638305664062, 143.74264526367188, 134.1333770751953,
        143.54153442382812, 132.9582061767578, 127.0703353881836,
        132.03536987304688, 136.44029235839844, 135.16050720214844,
        95.3981704711914, 143.76036071777344, 134.1495361328125,
        143.55897521972656, 132.97434997558594, 127.08051300048828,
        132.02122497558594, 136.4258575439453, 135.14588928222656,
        95.38777923583984, 143.74493408203125, 134.13516235351562,
        143.54336547851562, 132.95985412597656, 127.0713882446289,
        132.03659057617188, 136.4416046142578, 135.162109375,
        95.39906311035156, 143.7616424560547, 134.15109252929688,
        143.5606231689453, 132.9757537841797, 127.0811538696289,
        132.01934814453125, 136.42376708984375, 135.14389038085938,
        95.38638305664062, 143.74264526367188, 134.1333770751953,
        143.54153442382812, 132.9582061767578, 127.0703353881836,
        132.03536987304688, 136.44029235839844, 135.16050720214844,
        95.3981704711914, 143.76036071777344, 134.1495361328125,
        143.55897521972656, 132.97434997558594, 127.08051300048828,
    ],
    "elec_cost_usd": [
        27.710453033447266, 36.79965591430664, 35.15105056762695,
        29.11516761779785, 31.829038619995117, 31.964967727661133,
        27.040409088134766, 47.86032485961914, 26.69858169555664,
        27.713825225830078, 36.80421447753906, 35.15534210205078,
        29.118696212768555, 31.83289909362793, 31.968875885009766,
        27.043704986572266, 47.86611557006836, 26.700754165649414,
        27.710453033447266, 36.79965591430664, 35.15105056762695,
        29.11516761779785, 31.829038619995117, 31.964967727661133,
        27.040409088134766, 47.86032485961914, 26.69858169555664,
        27.713825225830078, 36.80421447753906, 35.15534210205078,
        29.118696212768555, 31.83289909362793, 31.968875885009766,
        27.043704986572266, 47.86611557006836, 26.700754165649414,
        27.710851669311523, 36.80022430419922, 35.15156936645508,
        29.115570068359375, 31.829471588134766, 31.965402603149414,
        27.040788650512695, 47.86094665527344, 26.698801040649414,
        27.714082717895508, 36.80455017089844, 35.155677795410156,
        29.11899185180664, 31.833192825317383, 31.969158172607422,
        27.04398536682129, 47.866607666015625, 26.700910568237305,
        27.710453033447266, 36.79965591430664, 35.15105056762695,
        29.11516761779785, 31.829038619995117, 31.964967727661133,
        27.040409088134766, 47.86032485961914, 26.69858169555664,
        27.713825225830078, 36.80421447753906, 35.15534210205078,
        29.118696212768555, 31.83289909362793, 31.968875885009766,
        27.043704986572266, 47.86611557006836, 26.700754165649414,
    ],
    "avg_pue": [
        1.2523986388179378, 1.2644370112654328, 1.2621522565507175,
        1.2708467088215867, 1.263317223086978, 1.2686624146085737,
        1.2723290785808972, 1.2549898269308046, 1.2523694216085732,
        1.252490404230041, 1.2645300492094653, 1.2622433884320483,
        1.2709384149556824, 1.2634111831899906, 1.2687543746297418,
        1.272422442356642, 1.2550823283757744, 1.2524131444218478,
        1.2523986388179378, 1.2644370112654328, 1.2621522565507175,
        1.2708467088215867, 1.263317223086978, 1.2686624146085737,
        1.2723290785808972, 1.2549898269308046, 1.2523694216085732,
        1.252490404230041, 1.2645300492094653, 1.2622433884320483,
        1.2709384149556824, 1.2634111831899906, 1.2687543746297418,
        1.272422442356642, 1.2550823283757744, 1.2524131444218478,
        1.252403571182939, 1.2644406420993217, 1.262154616208397,
        1.2708508388313497, 1.263321444930599, 1.2686659939070584,
        1.2723310254402291, 1.254993861663968, 1.2523711046138486,
        1.2524862045111136, 1.264526704282133, 1.2622397843814845,
        1.2709357089011484, 1.263406409408745, 1.2687499648193925,
        1.2724162531953012, 1.255079249820994, 1.2524080945509002,
        1.2523986388179378, 1.2644370112654328, 1.2621522565507175,
        1.2708467088215867, 1.263317223086978, 1.2686624146085737,
        1.2723290785808972, 1.2549898269308046, 1.2523694216085732,
        1.252490404230041, 1.2645300492094653, 1.2622433884320483,
        1.2709384149556824, 1.2634111831899906, 1.2687543746297418,
        1.272422442356642, 1.2550823283757744, 1.2524131444218478,
    ],
}


def fleet_scenarios(cfg: SimConfig) -> list:
    """The fleet case's 9 scenarios, unbatched, on the CPU."""
    from repro_torch.core.fleet import _scenario_list
    from repro_torch.scenarios.scenario import (
        default_scenario,
        demand_response,
        sample_scenarios,
    )

    dr = demand_response(
        cfg, cap_w=FLEET_DR["cap_frac"] * cfg.nameplate_it_w,
        event_start_s=FLEET_DR["event_start_s"],
        event_len_s=FLEET_DR["event_len_s"])
    return ([default_scenario(cfg)]
            + _scenario_list(sample_scenarios(cfg, FLEET_SAMPLED, seed=SEED))
            + [dr])


def fleet_grid(cfg: SimConfig, replicas: int | None = None):
    """(policy names, batched Policy, batched Scenario) of the fleet case:
    ``policy_scenario_grid`` of ``policy_grid(FLEET_SELECTS,
    FLEET_PLACES)`` and ``fleet_scenarios``, the names one per replica;
    with ``replicas``, the grid tiled (or cut) to that many replicas,
    replica i being the grid's i mod 72."""
    import torch

    from repro_torch.core.fleet import policy_scenario_grid
    from repro_torch.core.placement import Policy, policy_grid

    names, pols = policy_grid(FLEET_SELECTS, FLEET_PLACES)
    scns = fleet_scenarios(cfg)
    pol, scn = policy_scenario_grid(pols, scns)
    names = [n for n in names for _ in scns]
    if replicas is None:
        return names, pol, scn
    idx = torch.arange(replicas) % len(names)

    def tile(tree):
        if isinstance(tree, torch.Tensor):
            return tree[idx]
        return type(tree)(*(tile(v) for v in tree))

    return ([names[i] for i in idx.tolist()], Policy(*tile(pol)),
            tile(scn))


def check_fleet(cols: dict, replicas=None) -> dict:
    """Hold ``summary_columns`` of the fleet case (all replicas, or the
    ``replicas`` they are) to ``PINNED_FLEET``: ``completed`` exactly,
    ``FLEET_KEYS`` to ``RTOL``. Returns the largest relative error."""
    idx = np.arange(len(PINNED_FLEET["completed"])) if replicas is None \
        else np.asarray(replicas)
    want = np.asarray(PINNED_FLEET["completed"])[idx]
    got = np.asarray(cols["completed"])
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(
            f"{FLEET_CASE}: completed differs at replicas {idx[bad].tolist()}"
            f": {got[bad].tolist()} vs pinned {want[bad].tolist()}")
    worst = 0.0
    for k in FLEET_KEYS:
        w = np.asarray(PINNED_FLEET[k])[idx]
        rel = np.abs(np.asarray(cols[k]) - w) / np.abs(w)
        worst = max(worst, float(rel.max()))
        if not np.all(rel <= RTOL):
            bad = np.flatnonzero(rel > RTOL)
            raise AssertionError(
                f"{FLEET_CASE}: {k} off the pins at replicas "
                f"{idx[bad].tolist()} (largest rel err {rel.max():.3g})")
    return {"max_rel_err": worst, "replicas": len(idx)}


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
