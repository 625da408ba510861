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
- ``MACRO_CASES`` (``<hour>_macro``): each hour macro-stepped
  (``run_episode(..., macro=True)``), pinned in ``PINNED_MACRO``; the
  fleet hour macro-stepped in ``PINNED_FLEET_MACRO``, the RL cases'
  ``SchedEnv(macro=True)`` in ``PINNED_RL_MACRO``.
- ``FAULT_CASES``: the resilience twin on the same hour, per tick and
  macro-stepped (``replay_tx_gaia_1h_faults``: random node and rack
  faults with checkpoint-restart and retries; ``replay_tx_gaia_1h_drill``:
  a rack's maintenance window and an evicting brownout, thermals on),
  their fleet (``fleet_tx_gaia_faults``) and the RL env with the ladder's
  actions (``rl_tx_gaia_faults``), pinned in ``PINNED_FAULTS``,
  ``PINNED_FLEET_FAULTS`` and ``PINNED_RL_FAULTS``.
- The serving twin on the same hour (``replay_tx_gaia_1h_serving``: a
  pool of 32 inference nodes under diurnal traffic and a flash crowd, per
  tick and macro-stepped), its fleet (``fleet_tx_gaia_serving``) and the
  RL env with the serving actions (``rl_tx_gaia_serving``), pinned in
  ``PINNED_SERVING``, ``PINNED_FLEET_SERVING`` and ``PINNED_RL_SERVING``
  (at the end).
- Distributed PPO on ``rl_tx_gaia`` over a fleet mesh of 1 or 2 ranks
  (``rl.distributed.distributed_ppo_train``, ``compress=True``), pinned
  per world size in ``PINNED_RL_DIST``.
- The virtual cloud (``repro_torch.examples.virtual_cloud``): LM jobs of
  four archs from the perf model run through a smaller TX-GAIA job table
  under five what-ifs (``virtual_cloud_config``,
  ``virtual_cloud_workload``), two of them pinned in
  ``PINNED_VIRTUAL_CLOUD`` with the workload's digest (at the end).

``PINNED[case]`` holds what the JAX package's ``run_episode(...,
"replay", summary_only=True)`` + ``summary(state, telemetry)`` give for
each case on the CPU (jax 0.9.0). ``chip_smoke.py`` holds the port's run
on the card to these values, and ``tests/test_torch_replay.py`` and
``tests/test_torch_thermal.py`` keep them honest against a live
reference run.
"""

from __future__ import annotations

import dataclasses
import hashlib

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

# the serving pool of the serving cases (``replay_tx_gaia_1h_serving``,
# ``rl_tx_gaia_serving``, at the end)
SERVING = dict(serving_enabled=True, serving_nodes=32)

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

# The macro-stepped hours: each replay hour's config, workload and ticks
# through ``run_episode(..., macro=True)``. ``PINNED_MACRO[case]`` holds
# what the JAX package's macro path gives on the CPU (jax 0.9.0), made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_macro_pins.py replay
# ``macro_steps_taken`` (the event ticks) is held exactly with thermals
# off; with thermals on the thermal horizon floors a difference of rack
# temperatures, which agree to ~1e-6, so it is reported, not held.
MACRO_CASES = tuple(f"{case}_macro" for case in CASES)
MACRO_KEYS = ("completed", "energy_kwh", "avg_pue", "carbon_kg",
              "mean_wait_s", "macro_steps_taken")
MACRO_THERMAL_KEYS = ("peak_rack_outlet_c", "thermal_throttle_s",
                      "mean_cop")
PINNED_MACRO = {
    "replay_tx_gaia_1h_macro": {
        "completed": 103.0,
        "energy_kwh": 264.79302978515625,
        "avg_pue": 1.2523986388179378,
        "carbon_kg": 132.01934814453125,
        "mean_wait_s": 0.7530097591066823,
        "macro_steps_taken": 271.0
    },
    "replay_tx_gaia_1h_thermal_macro": {
        "completed": 103.0,
        "energy_kwh": 266.0106201171875,
        "avg_pue": 1.2581575082100478,
        "carbon_kg": 132.62652587890625,
        "mean_wait_s": 0.7530097591066823,
        "macro_steps_taken": 271.0,
        "peak_rack_outlet_c": 28.327625274658203,
        "thermal_throttle_s": 0.0,
        "mean_cop": 5.6555938720703125
    },
    "replay_tx_gaia_1h_thermal_stress_macro": {
        "completed": 94.0,
        "energy_kwh": 264.5250549316406,
        "avg_pue": 1.2582372818223801,
        "carbon_kg": 131.8872528076172,
        "mean_wait_s": 0.7990804631659325,
        "macro_steps_taken": 2517.0,
        "peak_rack_outlet_c": 27.689422607421875,
        "thermal_throttle_s": 3020.0,
        "mean_cop": 5.653233528137207
    }
}


def base_case(case: str) -> str:
    """The replay hour a case runs: a macro case's per-tick twin."""
    return case[:-len("_macro")] if case.endswith("_macro") else case


def config(case: str = "replay_tx_gaia_1h") -> SimConfig:
    base = base_case(case)
    flags = {**CASES, **FAULT_CASES, SERVING_CASE: SERVING}[base]
    return tx_gaia(max_jobs=256, max_nodes_per_job=16, **flags)


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


# ``PINNED_FLEET_MACRO``: the JAX package's vmapped ``run_fleet(...,
# macro=True)`` over the fleet case on the CPU (jax 0.9.0), per replica,
# made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_macro_pins.py fleet
# (19 s on 8 cores). Its ``completed`` and ``FLEET_KEYS`` come out equal to
# ``PINNED_FLEET``'s in every replica; ``macro_steps_taken`` is each
# replica's event ticks (the demand-response replicas' cap edges and
# throttled progress move theirs).
PINNED_FLEET_MACRO = {
    "completed": [
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0, 103.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0, 103.0, 103.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 63.0, 103.0, 103.0, 103.0,
        103.0, 103.0, 103.0, 103.0, 103.0, 63.0, 104.0, 104.0, 104.0, 104.0,
        104.0, 104.0, 104.0, 104.0, 63.0, 104.0, 104.0, 104.0, 104.0, 104.0,
        104.0, 104.0, 104.0, 63.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0,
        103.0, 103.0, 63.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0, 103.0,
        103.0, 63.0,
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
    "macro_steps_taken": [
        271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 232.0, 271.0,
        271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 232.0, 271.0, 271.0,
        271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 232.0, 271.0, 271.0, 271.0,
        271.0, 271.0, 271.0, 271.0, 271.0, 232.0, 272.0, 272.0, 272.0, 272.0,
        272.0, 272.0, 272.0, 272.0, 232.0, 272.0, 272.0, 272.0, 272.0, 272.0,
        272.0, 272.0, 272.0, 232.0, 271.0, 271.0, 271.0, 271.0, 271.0, 271.0,
        271.0, 271.0, 232.0, 271.0, 271.0, 271.0, 271.0, 271.0, 271.0, 271.0,
        271.0, 232.0,
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


def check_fleet(cols: dict, replicas=None, pins: dict | None = None
                ) -> dict:
    """Hold ``summary_columns`` of the fleet case (all replicas, or the
    ``replicas`` they are) to ``PINNED_FLEET`` (or ``pins``, e.g.
    ``PINNED_FLEET_MACRO``): ``completed`` (and ``macro_steps_taken``
    where pinned) exactly, ``FLEET_KEYS`` to ``RTOL``. Returns the largest
    relative error."""
    pins = PINNED_FLEET if pins is None else pins
    idx = np.arange(len(pins["completed"])) if replicas is None \
        else np.asarray(replicas)
    if "macro_steps_taken" in pins:
        got, want = (np.asarray(cols["macro_steps_taken"]),
                     np.asarray(pins["macro_steps_taken"])[idx])
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(
                f"{FLEET_CASE}: macro_steps_taken differs at replicas "
                f"{idx[bad].tolist()}: {got[bad].tolist()} vs pinned "
                f"{want[bad].tolist()}")
    want = np.asarray(pins["completed"])[idx]
    got = np.asarray(cols["completed"])
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(
            f"{FLEET_CASE}: completed differs at replicas {idx[bad].tolist()}"
            f": {got[bad].tolist()} vs pinned {want[bad].tolist()}")
    worst = 0.0
    for k in FLEET_KEYS:
        w = np.asarray(pins[k])[idx]
        rel = np.abs(np.asarray(cols[k]) - w) / np.abs(w)
        worst = max(worst, float(rel.max()))
        if not np.all(rel <= RTOL):
            bad = np.flatnonzero(rel > RTOL)
            raise AssertionError(
                f"{FLEET_CASE}: {k} off the pins at replicas "
                f"{idx[bad].tolist()} (largest rel err {rel.max():.3g})")
    return {"max_rel_err": worst, "replicas": len(idx)}


def check(case: str, got: dict) -> None:
    """Raise unless the summary ``got`` meets ``PINNED[case]`` (a macro
    case: ``PINNED_MACRO[case]``; a fault case: ``PINNED_FAULTS[case]``):
    the counts (completions, kills, terminal failures) exactly, with
    thermals off or on a fault hour the event-tick count
    (``macro_steps_taken``) exactly, every other value to ``RTOL``; a
    thermal replay hour's event-tick count is only reported."""
    if case in PINNED_FAULTS:
        pins = dict(PINNED_FAULTS[case])
    else:
        pins = dict(PINNED_MACRO[case] if case in PINNED_MACRO
                    else PINNED[case])
        if case in PINNED_MACRO and config(case).thermal_enabled:
            pins.pop("macro_steps_taken")
    # the JAX package's own event ticks on a fault hour: reported only
    pins.pop("reference_macro_steps_taken", None)
    for k in ("completed", "macro_steps_taken") + FAULT_COUNTS:
        if k in pins and got[k] != pins[k]:
            raise AssertionError(f"{case}: {k} {got[k]} != pinned "
                                 f"{pins[k]}")
    for k, v in pins.items():
        if abs(got[k] - v) > RTOL * abs(v):
            raise AssertionError(f"{case}: {k} {got[k]!r} vs pinned {v!r} "
                                 f"(rtol {RTOL})")


# ---------------------------------------------------------------------------
# The resilience twin (``core.faults``) on the replay hour's job table and
# workload, 3600 ticks of "replay", per tick and macro-stepped:
# - ``replay_tx_gaia_1h_faults``: the JAX package's faults bench
#   (``benchmarks/bench_sim.py:386-430``): node MTBF 6 h (repair 0.5 h),
#   rack MTBF 48 h (repair 1 h), checkpoints every 900 s at 30 s each, 4
#   retries; the clocks drawn from key ``SEED``;
# - ``replay_tx_gaia_1h_drill``: thermals and outages on, no random
#   faults; ``resilience_drill`` squeezed into the hour (``DRILL``): rack
#   0 down for maintenance from 600 s to 1500 s, then from 2100 s to 2700 s
#   a brownout at level 4 (throttle to the floor, no new dispatch, every
#   running job checkpoint-evicted), so it runs every rung, the mass
#   release and ``rack_tick`` with a downed rack.
# ``PINNED_FAULTS`` holds what the JAX package gives for each hour and its
# ``_macro`` twin on the CPU (jax 0.9.0), made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fault_pins.py
FAULTS = dict(node_mtbf_hours=6.0, node_repair_hours=0.5,
              rack_mtbf_hours=48.0, rack_repair_hours=1.0,
              ckpt_interval_s=900.0, ckpt_overhead_s=30.0, max_job_retries=4)
DRILL = dict(maint_rack=0, maint_start_s=600.0, maint_len_s=900.0,
             brownout_start_s=2100.0, brownout_len_s=600.0,
             brownout_level=4)
FAULT_CASES = {
    "replay_tx_gaia_1h_faults": FAULTS,
    "replay_tx_gaia_1h_drill": dict(thermal_enabled=True,
                                    outages_enabled=True),
}
FAULT_MACRO_CASES = tuple(f"{case}_macro" for case in FAULT_CASES)
FAULT_KEYS = ("completed", "killed_by_failures", "lost_node_seconds",
              "jobs_failed_terminal", "goodput_frac", "energy_kwh",
              "avg_pue", "carbon_kg")
FAULT_THERMAL_KEYS = ("peak_rack_outlet_c", "thermal_throttle_s")
# held exactly (``check``)
FAULT_COUNTS = ("killed_by_failures", "jobs_failed_terminal")


def fault_scenario(case: str, cfg: SimConfig):
    """The scenario a fault case runs under: the drill's outages for the
    drill hours, else ``None`` (the default grid)."""
    if "drill" not in case:
        return None
    from repro_torch.scenarios.scenario import resilience_drill

    return resilience_drill(cfg, **DRILL)


def fault_keys(case: str) -> tuple:
    """The summary keys ``PINNED_FAULTS[case]`` holds."""
    keys = FAULT_KEYS + (FAULT_THERMAL_KEYS if config(case).thermal_enabled
                         else ())
    return keys + (("macro_steps_taken",) if case.endswith("_macro")
                   else ())


# The fleet: the faults hour's config with outages on, FLEET_FAULTS_E
# replicas whose state comes from keys 0..E-1 (each with its own clocks),
# the even ones under the default grid and the odd ones under the drill,
# FLEET_FAULTS_TICKS ticks of "fcfs" per tick, against the JAX package's
# vmapped ``run_fleet`` (``PINNED_FLEET_FAULTS``, per replica); replicas
# FLEET_FAULTS_ALONE rerun alone (integers equal, floats 1e-5).
FLEET_FAULTS_CASE = "fleet_tx_gaia_faults"
FLEET_FAULTS_E = 8
FLEET_FAULTS_TICKS = 1200
FLEET_FAULTS_SCHEDULER = "fcfs"
FLEET_FAULTS_ALONE = (0, 1)
FLEET_FAULTS_KEYS = ("completed", "killed_by_failures",
                     "jobs_failed_terminal", "lost_node_seconds",
                     "energy_kwh", "carbon_kg", "avg_pue")


def fleet_faults_config() -> SimConfig:
    return tx_gaia(max_jobs=256, max_nodes_per_job=16, outages_enabled=True,
                   **FAULTS)


def fleet_faults_scenarios(cfg: SimConfig) -> list:
    """The fleet's scenarios, unbatched: default grid and drill, alternating."""
    from repro_torch.scenarios.scenario import (
        default_scenario,
        resilience_drill,
    )

    return [default_scenario(cfg) if e % 2 == 0
            else resilience_drill(cfg, **DRILL)
            for e in range(FLEET_FAULTS_E)]


def check_fleet_faults(cols: dict, replicas=None) -> dict:
    """Hold ``summary_columns`` of the fault fleet (all replicas, or the
    ``replicas`` they are) to ``PINNED_FLEET_FAULTS``: the counts exactly,
    the rest to ``RTOL``. Returns the largest relative error."""
    idx = (np.arange(FLEET_FAULTS_E) if replicas is None
           else np.asarray(replicas))
    worst = 0.0
    for k in FLEET_FAULTS_KEYS:
        want = np.asarray(PINNED_FLEET_FAULTS[k])[idx]
        got = np.asarray(cols[k])
        if k in ("completed",) + FAULT_COUNTS:
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{FLEET_FAULTS_CASE}: {k} {got.tolist()} vs pinned "
                    f"{want.tolist()}")
            continue
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        rel = np.where(got == want, 0.0, rel)
        worst = max(worst, float(rel.max()))
        if not np.all(rel <= RTOL):
            raise AssertionError(
                f"{FLEET_FAULTS_CASE}: {k} off the pins by rel "
                f"{rel.max():.3g} at replicas "
                f"{idx[rel > RTOL].tolist()}")
    return {"max_rel_err": worst, "replicas": len(idx)}


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


def run_lm(model, tokens, prompt: int = LM_PROMPT, decode: int = LM_DECODE,
           dropped: list | None = None, extras: dict | None = None):
    """The case on the port: prefill ``tokens[:, :prompt]`` (with the
    memory of ``extras``, tensors, where the model attends to one) into a
    cache of prompt + decode, then one decode step per fed id. Returns the
    1 + decode (B, V) f32 logits. ``dropped``, if given, receives for the
    prefill and each decode step the slots each MoE layer dropped (ints,
    read after the run)."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.moe import record_routing

    counts = []
    with record_routing() as rec:
        logits, cache = prefill(model, tokens[:, :prompt],
                                cache_seq_len=prompt + decode, extras=extras)
    counts.append([(~r.keep).sum() for r in rec])
    out = [logits]
    for i in range(decode):
        pos = prompt + i
        with record_routing() as rec:
            logits, cache = decode_step(model, cache,
                                        tokens[:, pos:pos + 1], pos)
        counts.append([(~r.keep).sum() for r in rec])
        out.append(logits)
    if dropped is not None:
        dropped.extend([int(c) for c in step] for step in counts)
    return out


def lm_summary(logits, dropped: list | None = None) -> dict:
    """The pinned quantities of a list of (B, V) f32 logits (numpy arrays
    or tensors), as nested lists: one row per logits, one entry per
    prompt; with ``dropped`` (an MoE model's slots dropped per layer, one
    row per logits) that too."""
    a = np.stack([np.asarray(x, dtype=np.float32) for x in logits])
    top2 = -np.sort(-a, axis=-1)[..., :2].astype(np.float64)
    a64 = a.astype(np.float64)
    mx = a64.max(-1, keepdims=True)
    lse = (mx[..., 0] + np.log(np.exp(a64 - mx).sum(-1)))
    out = {
        "argmax": a.argmax(-1).tolist(),
        "top1": top2[..., 0].tolist(),
        "margin": (top2[..., 0] - top2[..., 1]).tolist(),
        "logsumexp": lse.tolist(),
        "head": a[..., :LM_HEAD].astype(np.float64).tolist(),
    }
    if dropped is not None:
        out["dropped"] = [list(step) for step in dropped]
    return out


def check_lm(got: dict, dtype: str, pins: dict | None = None,
             case: str = LM_CASE) -> dict:
    """Hold ``lm_summary`` of a run in ``dtype`` to the pins of ``case``
    (``PINNED_LM`` by default): the top-1 value, the logsumexp and the
    leading logits within ``tol + tol * |pin|`` (``tol`` the case's in
    ``F32_TOLS`` in f32, else LM_F32_TOL / LM_BF16_TOL); in f32 also the
    margins, and every argmax id equal; where the pins hold ``dropped``,
    in f32 those too. Raises on a miss; returns the largest errors and
    how many argmax ids agree."""
    pins = pins or PINNED_LM
    tol = {"float32": F32_TOLS.get(case, LM_F32_TOL),
           "bfloat16": LM_BF16_TOL}[dtype]
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
    if "dropped" in pins:
        report["dropped"] = got["dropped"]
        if dtype == "float32" and got["dropped"] != pins["dropped"]:
            raise AssertionError(f"{case} (f32): dropped slots "
                                 f"{got['dropped']}, pinned "
                                 f"{pins['dropped']}")
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
    """jamba-1.5-large-398b as the port serves it on the card. Cut from
    the JAX package's config: the experts (16, top-2, on every second
    layer) become the dense gated MLP of d_ff 24576 on every layer
    (``MoEConfig()``), and 72 layers become ``n_layers`` (1 or 8 here: 16
    layers of f32 masters and bf16 copies would not fit on an 80 GB card).
    Every width is kept. The port runs the experts (``models/moe.py``;
    jamba with them is held to the JAX package on the CPU, at reduced
    widths), but one MoE layer of jamba holds 9.66e9 expert parameters,
    38.7 GB of f32 masters and 19.3 GB of bf16 copies: with the rest of a
    cut it does not fit on one 80 GB card, so the card's cases keep the
    dense MLP."""
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


# ---------------------------------------------------------------------------
# LM serving: mixtral-8x22b (arXiv:2401.04088) at full width: d_model
# 6144, 48 query heads over 8 KV heads of 128, a sliding window of 4096 on
# every layer, 8 experts of d_ff 16384 on every layer, top-2, capacity
# factor 1.25, vocab 32768. Only depth is cut (56 layers).
#
# - ``serve_mixtral_1l`` (correctness, f32): one layer (2,906,720,256
#   parameters, 11.6 GB), weights from ``models.seeded_numpy_params(cfg,
#   MIXTRAL_SEED)``; B = 2 prompts of 640 ids, then MIXTRAL_DECODE
#   teacher-forced decode steps. The prefill routes 2,560 (token, k) slots
#   into C = 400 slots an expert, so slots may drop. ``PINNED_MIXTRAL``
#   holds what the JAX package gives for it on the CPU (jax 0.9.0,
#   ``ShardCtx(enabled=False, attention_impl="pallas", block_q=640,
#   block_k=640)``: its kernel's blocks must divide the prompt), in
#   ``lm_summary``'s form with the slots each layer dropped at the prefill
#   and at each decode step (``dropped``; the JAX package's recounted from
#   its own routing); ``check_lm(..., pins=PINNED_MIXTRAL,
#   case=MIXTRAL_CASE)`` holds a run to them. ``tests/test_torch_lm_
#   pins.py`` re-derives them.
# - ``serve_mixtral_4l`` (the path): four layers (10,418,903,040
#   parameters: 41.7 GB of f32 masters, 20.8 GB more for the bf16 copies;
#   eight layers would not fit on an 80 GB card), weights from the port's
#   ``init_params`` on the card.
MIXTRAL_ARCH = "mixtral-8x22b"
MIXTRAL_CASE = "serve_mixtral_1l"
MIXTRAL_PATH_CASE = "serve_mixtral_4l"
MIXTRAL_SEED = 0
MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_DECODE = 2, 640, 8
MIXTRAL_PATH_LAYERS = 4
MIXTRAL_BLOCK = 640       # the JAX reference's flash-attention blocks
# f32: mixtral's pinned logits are of order 4 (gemma3-1b's of order 0.3),
# and the port differs from these pins by up to 2.29e-5 on the CPU and
# 2.55e-5 on the card (the margin, a difference of two such logits);
# 1e-4 is ~4x that. A routing choice or a dropped slot that differed
# would move them by tenths, and ``dropped`` is held exactly.
MIXTRAL_F32_TOL = 1e-4


def mixtral_config(n_layers: int, dtype: str = "float32",
                   capacity_factor: float | None = None) -> ModelConfig:
    """mixtral-8x22b with ``n_layers`` of its 56 layers, every width kept;
    ``capacity_factor`` replaces the published 1.25 where given."""
    cfg = get_arch(MIXTRAL_ARCH)
    moe = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor)
    return dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype, moe=moe)


PINNED_MIXTRAL = {
    "argmax": [
        [26042, 4261],
        [2508, 7968],
        [9523, 22243],
        [18733, 28382],
        [30307, 32586],
        [23114, 1779],
        [24124, 1329],
        [7652, 23224],
        [2179, 454],
    ],
    "top1": [
        [3.7937326, 3.707828],
        [4.1494126, 3.8454192],
        [3.7076044, 4.0624475],
        [3.9756098, 3.89833],
        [4.6929326, 4.102417],
        [4.073421, 3.7483647],
        [4.4685965, 3.9094596],
        [4.397553, 4.1536236],
        [4.194524, 3.8534365],
    ],
    "margin": [
        [0.05596447, 0.16181278],
        [0.022021294, 0.07357621],
        [0.09567523, 0.2518263],
        [0.08243775, 0.07125926],
        [0.72054625, 0.09617329],
        [0.108938456, 0.07504177],
        [0.37159252, 0.058166027],
        [0.5556822, 0.21893811],
        [0.48670387, 0.06456494],
    ],
    "logsumexp": [
        [10.896030865351289, 10.88031190591435],
        [10.913311938288306, 10.89772612446503],
        [10.892588684444277, 10.888083994237167],
        [10.902209142271595, 10.899299928198182],
        [10.904813442552733, 10.898046696896376],
        [10.891474249791056, 10.897871857178597],
        [10.901791941652228, 10.901320983726176],
        [10.901416172453171, 10.89876522054847],
        [10.90237521697028, 10.893889186106447],
    ],
    "head": [
        [[-0.65867156, -0.26245365, 0.36293688, 0.4145167,
          0.025125667, -1.2179765, 0.14853129, -1.0656054],
         [-1.1124192, 0.87470967, 0.74432623, 2.4048598,
          0.485763, 0.6653832, 1.4187073, 0.43990046]],
        [[-0.8884985, 1.9894534, 0.8392769, -1.5285091,
          0.6669834, 1.1767055, -0.013709933, -2.5715039],
         [-0.8660205, 1.504355, 0.10908024, 0.2580544,
          -0.31495163, -0.5644036, -1.7720062, 0.92123187]],
        [[0.7488822, -1.6876845, -0.20871043, 1.6100273,
          0.07494682, 0.932979, 2.322104, -0.86643684],
         [0.19885457, 2.0118036, -1.1585503, -1.0109825,
          0.5364771, -1.4585638, -2.08268, 0.13527903]],
        [[-0.9624099, 0.70020556, 0.4187667, -1.8486693,
          -0.27031362, -0.9754453, 0.3547714, 0.31341076],
         [-0.34192774, 0.5711461, 0.51979315, -0.34817207,
          1.6215872, -0.14565511, -0.023616172, 1.6350102]],
        [[0.5265645, 1.9162886, -0.0661217, -2.3110704,
          -0.07162775, -0.9965198, -1.9012207, 0.6499871],
         [0.11585899, 0.9297696, 0.4897261, 0.11697516,
          2.662236, 0.7803153, -0.41138577, 0.8525015]],
        [[0.32038957, 0.4018912, 0.59089696, -0.6975758,
          -0.100836724, -1.8325675, 0.5574705, 0.6649428],
         [-0.65748847, 0.8824292, 2.6235964, -1.4080769,
          -0.35941288, 0.3494804, 0.42015174, 0.29904523]],
        [[-0.16088176, 0.6983708, 0.8626495, -2.2134416,
          -0.3106822, 0.26657027, 2.3374834, -3.4911668],
         [-1.0183893, 1.4541664, 0.7148731, 0.13992119,
          0.27906942, 0.037602603, 1.029594, 0.18081072]],
        [[-0.044290677, -1.6459041, 0.30894506, -0.46781835,
          0.86734325, 0.5297034, 1.1672, 0.006995648],
         [-0.3652611, 1.7723432, 0.27253848, -0.29813203,
          -0.028906375, -0.34538615, 0.6176441, -0.6660107]],
        [[-0.3969093, 0.859247, 0.864967, 1.8416158,
          -1.053157, 0.0076794624, 1.3929716, 1.0759542],
         [-1.7683054, 1.6065661, -0.68122894, -0.7384005,
          -0.41204098, -1.4943402, -1.6902305, -0.32226604]],
    ],
    "dropped": [
        [129],
        [0],
        [0],
        [0],
        [0],
        [0],
        [0],
        [0],
        [0],
    ],
}


# ---------------------------------------------------------------------------
# LM serving: the last three families, at full width, each with weights
# from ``models.seeded_numpy_params(cfg, LAST_SEED)`` and, where the model
# attends to a memory, the memory of ``lm_memory`` (the same numpy arrays
# in both packages). Each pin holds what the JAX package gives on the CPU
# (jax 0.9.0, ``dtype="float32"``, ``ShardCtx(enabled=False)``: its
# ``attention`` picks ``attention_full`` at these lengths, since its Pallas
# kernel needs block multiples that 1,601 and 1,500 are not), in
# ``lm_summary``'s form; ``tests/test_torch_lm_pins.py`` re-derives them.
#
# - ``serve_xlstm``: the whole xlstm-125m (arXiv:2405.04517; 12 layers, M
#   M M S x 3, d_model 768, 4 heads, d_inner 1536, vocab 50304;
#   188,958,720 parameters); B = 2 prompts of 600 ids (not a multiple of
#   the mLSTM's 256-step chunk: the padded last chunk), then 4
#   teacher-forced decode steps.
# - ``serve_whisper``: the whole whisper-small (arXiv:2212.04356; 12
#   encoder and 12 decoder layers, d_model 768, 12 heads of 64, d_ff 3072,
#   vocab 51865, tied embeddings; 238,060,800 parameters); B = 2, 1,500
#   audio frames, prompts of 64 ids, 4 decode steps.
# - ``serve_vlm``: llama-3.2-vision-11b (hf:meta-llama/Llama-3.2-11B-Vision)
#   at full width (d_model 4096, 32 heads over 8 KV heads of 128, d_ff
#   14336, vocab 128256, 1,601 vision tokens) cut to one period of its
#   cross-attention, 5 of 40 layers (4 self-attention layers and the
#   ``CROSS`` layer; 2,183,184,385 parameters: the whole model's 10.11e9
#   would be 40.4 GB of f32 masters and 20.2 GB of bf16 copies); B = 1, a
#   prompt of 1,632 ids (longer than the memory: the cross-attention's Sq >
#   Sk), 4 decode steps. ``xgate`` is zero at init, and ``tanh(0)`` would
#   remove the whole cross path from the logits, so the pinned tree sets
#   every ``xgate`` to VLM_XGATE (``open_xgate``), in both packages.
#   ``serve_vlm_10l`` (two periods, 3,315,691,522 parameters, ``init_params``
#   on the card with the gate opened the same way) is the card's path case.
XLSTM_ARCH, XLSTM_CASE = "xlstm-125m", "serve_xlstm"
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_DECODE = 2, 600, 4
WHISPER_ARCH, WHISPER_CASE = "whisper-small", "serve_whisper"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE = 2, 64, 4
VLM_ARCH, VLM_CASE, VLM_PATH_CASE = ("llama-3.2-vision-11b", "serve_vlm",
                                     "serve_vlm_10l")
VLM_BATCH, VLM_PROMPT, VLM_DECODE = 1, 1632, 4
VLM_LAYERS, VLM_PATH_LAYERS = 5, 10
VLM_XGATE = 1.0
LAST_SEED = 0
MEMORY_SEED, MEMORY_SCALE = 2, 0.02
LAST_CASES = (XLSTM_CASE, WHISPER_CASE, VLM_CASE)


def xlstm_config(dtype: str = "float32") -> ModelConfig:
    return dataclasses.replace(get_arch(XLSTM_ARCH), dtype=dtype)


def whisper_config(dtype: str = "float32") -> ModelConfig:
    return dataclasses.replace(get_arch(WHISPER_ARCH), dtype=dtype)


def vlm_config(n_layers: int = VLM_LAYERS,
               dtype: str = "float32") -> ModelConfig:
    """llama-3.2-vision-11b with ``n_layers`` of its 40 layers (a multiple
    of its cross-attention period, 5), every width kept."""
    return dataclasses.replace(get_arch(VLM_ARCH), n_layers=n_layers,
                               dtype=dtype)


def lm_case(case: str, dtype: str = "float32"):
    """(config, batch, prompt, decode steps, weight seed) of a pinned LM
    case: LM_CASE, JAMBA_CASE, MIXTRAL_CASE or one of LAST_CASES."""
    if case == LM_CASE:
        return lm_config(dtype), LM_BATCH, LM_PROMPT, LM_DECODE, LM_SEED
    if case == JAMBA_CASE:
        return (jamba_config(1, dtype), JAMBA_BATCH, JAMBA_PROMPT,
                JAMBA_DECODE, JAMBA_SEED)
    if case == MIXTRAL_CASE:
        return (mixtral_config(1, dtype), MIXTRAL_BATCH, MIXTRAL_PROMPT,
                MIXTRAL_DECODE, MIXTRAL_SEED)
    if case == XLSTM_CASE:
        return (xlstm_config(dtype), XLSTM_BATCH, XLSTM_PROMPT, XLSTM_DECODE,
                LAST_SEED)
    if case == WHISPER_CASE:
        return (whisper_config(dtype), WHISPER_BATCH, WHISPER_PROMPT,
                WHISPER_DECODE, LAST_SEED)
    if case == VLM_CASE:
        return (vlm_config(VLM_LAYERS, dtype), VLM_BATCH, VLM_PROMPT,
                VLM_DECODE, LAST_SEED)
    raise KeyError(f"no pinned LM case {case!r}")


def lm_case_inputs(case: str):
    """(config, f32 numpy weights, tokens (B, prompt + decode), numpy
    memory) of a pinned LM case: ``seeded_numpy_params`` (the VLM's
    ``xgate`` opened), ``lm_tokens`` and ``lm_memory``, as both packages
    take them."""
    from repro_torch.models import seeded_numpy_params

    cfg, batch, prompt, decode, seed = lm_case(case)
    tree = seeded_numpy_params(cfg, seed)
    if case == VLM_CASE:
        open_xgate(tree)
    return (cfg, tree, lm_tokens(cfg, batch, prompt, decode),
            lm_memory(cfg, batch))


def lm_memory(cfg: ModelConfig, batch: int) -> dict:
    """The memory a VLM's or an encoder-decoder's prompt comes with, as
    the JAX package's serving draws it (``launch/serve.py``): MEMORY_SCALE
    times a standard normal (B, M, D), f32, from
    ``default_rng(MEMORY_SEED)``; {} for the other archs."""
    from repro_torch.models.spec import memory_input

    name, m = memory_input(cfg)
    if name is None:
        return {}
    a = np.random.default_rng(MEMORY_SEED).standard_normal(
        (batch, m, cfg.d_model), np.float32)
    return {name: a * np.float32(MEMORY_SCALE)}


def open_xgate(tree, value: float = VLM_XGATE):
    """Set every ``xgate`` leaf of a parameter tree (numpy arrays or
    tensors, in place) to ``value``; returns the tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "xgate":
                v[...] = value
            else:
                open_xgate(v, value)
    elif isinstance(tree, list):
        for v in tree:
            open_xgate(v, value)
    return tree


PINNED_XLSTM = {
    "argmax": [
        [23836, 46546],
        [38098, 3104],
        [38391, 25994],
        [26022, 38161],
        [38438, 16410],
    ],
    "top1": [
        [4.15868521, 3.93113518],
        [4.45877838, 4.40006924],
        [4.50870705, 4.15893745],
        [4.53417158, 4.19663],
        [5.21120644, 4.27302504],
    ],
    "margin": [
        [0.0997958183, 0.0864546299],
        [0.0129714012, 0.331684589],
        [0.450586796, 0.309036255],
        [0.541198015, 0.15679121],
        [1.21585369, 0.165992737],
    ],
    "logsumexp": [
        [11.325187544831715, 11.32831100318852],
        [11.327026495481011, 11.320503744693404],
        [11.330976399201543, 11.332762737821163],
        [11.32411606544023, 11.321666636958195],
        [11.322943801634155, 11.334701002184843],
    ],
    "head": [
        [[1.5802927, -0.304225236, 2.04692674, 0.00496554375, -0.556787014,
          -1.21501422, 0.242002666, 1.57793033], [-2.36709809, 0.289568156,
          0.190543413, -0.311622441, 0.177727342, -0.0486944914,
          -0.796516836, 0.580599904]],
        [[1.11399412, -0.0396358073, -1.29893053, -0.217176855, -0.278685689,
          0.445117265, -0.451355517, 1.55224466], [-1.3588711, 1.75689054,
          -1.28927445, -1.34452415, 0.5155527, -0.664540529, 1.61497056,
          -0.408022642]],
        [[0.50411278, -0.461446524, 0.981180191, -0.538312078, -1.02048874,
          0.963154256, 0.674229383, -0.681719601], [0.983144224,
          -0.635597587, -1.39665926, 0.968921959, -0.143891454, 0.549624383,
          0.389286876, -1.9952755]],
        [[-1.54481077, 0.446720451, 0.873437405, 0.0728735328, -0.520178497,
          0.304886043, 0.296065301, 0.110007674], [1.80247164, -0.578864038,
          0.357109964, -0.835020542, 1.38360906, -0.857804418, 0.158535287,
          -0.972902]],
        [[1.38626599, -1.85918808, 0.722677946, -0.532862008, -0.106413305,
          0.520178854, 1.16028011, -0.0824943632], [0.950438619,
          -0.180637926, -2.13997126, 0.60846895, 0.333827138, 0.533452272,
          0.0934384763, -0.518165231]],
    ],
}


PINNED_WHISPER = {
    "argmax": [
        [27352, 2435],
        [27352, 2435],
        [27352, 44418],
        [27352, 2435],
        [27352, 44418],
    ],
    "top1": [
        [0.510371804, 0.487759233],
        [0.511341155, 0.481378108],
        [0.513819039, 0.484488904],
        [0.51158309, 0.484754592],
        [0.511737108, 0.486282617],
    ],
    "margin": [
        [0.0195930898, 0.00422090292],
        [0.0235434771, 0.000742465258],
        [0.0253822505, 0.00149795413],
        [0.0216970444, 0.00236168504],
        [0.0192981362, 0.00478622317],
    ],
    "logsumexp": [
        [10.864993299263705, 10.864658276907738],
        [10.865004910865839, 10.864660360392962],
        [10.8649870279845, 10.864662676720608],
        [10.864975026278671, 10.864641540854867],
        [10.864975821765716, 10.864641586848588],
    ],
    "head": [
        [[-0.193964764, 0.135921225, 0.0760403425, -0.0570444874,
          -0.0714765266, 0.0848876834, 0.0309173688, 0.169812709],
          [-0.22766009, 0.238689244, 0.118619159, -0.137488782, -0.079578355,
          0.0432742834, -0.136264801, -0.0763971284]],
        [[-0.197268695, 0.139194295, 0.0768708289, -0.0544060022,
          -0.0818191692, 0.0822541937, 0.0364039093, 0.169316486],
          [-0.225792557, 0.240161777, 0.116802432, -0.141409308,
          -0.0801755041, 0.0401028357, -0.137502193, -0.0705175996]],
        [[-0.205810443, 0.134702474, 0.0722618699, -0.0491714738,
          -0.0742077455, 0.0856844932, 0.0339599699, 0.172619477],
          [-0.228418872, 0.238942564, 0.120996788, -0.140186742,
          -0.0814413875, 0.0425134264, -0.145967409, -0.0723709688]],
        [[-0.203162566, 0.136728242, 0.0774272382, -0.0553093925,
          -0.0772240758, 0.0890664682, 0.0302268863, 0.175579101],
          [-0.23130995, 0.238747776, 0.115582854, -0.138332859,
          -0.0822934434, 0.0415644497, -0.143607885, -0.0747193992]],
        [[-0.201948851, 0.13865082, 0.0835562646, -0.0551957786,
          -0.0775201693, 0.0802007839, 0.0377547368, 0.17072463],
          [-0.228545517, 0.236103624, 0.116604075, -0.138311014,
          -0.0818924755, 0.0424611345, -0.146905482, -0.0701826662]],
    ],
}


PINNED_VLM = {
    "argmax": [
        [39175],
        [110111],
        [92934],
        [92934],
        [89972],
    ],
    "top1": [
        [4.41994858],
        [4.07832384],
        [4.34104109],
        [4.54370117],
        [4.35321569],
    ],
    "margin": [
        [0.393536568],
        [0.0252285004],
        [0.0454831123],
        [0.126139164],
        [0.167137623],
    ],
    "logsumexp": [
        [12.25836060163615],
        [12.257891086752288],
        [12.2583676518622],
        [12.26000558172079],
        [12.25920278332941],
    ],
    "head": [
        [[0.498911232, -1.29114497, 0.379309803, -0.201326251, -0.575151503,
          0.573218226, -0.433087677, -0.134677708]],
        [[1.03295696, -0.591406345, -0.367100149, 0.996119142, -0.820320189,
          0.570675194, -0.339324981, -0.246831611]],
        [[0.108062334, -0.624996483, 0.0349525809, 0.671384454, -1.6370374,
          0.679733217, -0.320067316, -0.116578206]],
        [[0.793995976, -0.770176709, 0.575751126, 0.227776334, -0.745958447,
          1.06234491, -0.163732678, -0.105194174]],
        [[0.899786353, -0.877779543, 0.496444553, 0.433481306, -1.09384227,
          0.292800277, -0.645039856, -0.501761019]],
    ],
}


# f32: xlstm-125m's logits are of order 5, and 12 layers of exp-stabilised
# recurrences (600 sLSTM steps, 256-step mLSTM chunks summed in another
# order) carry the port's one-layer differences of ~1e-5 to up to 1.08e-4
# on the pinned values on the CPU (2.65e-4 on any logit; every argmax
# agrees); 5e-4 is ~4.6x that. A wrong gate, state or padded step moves
# them by tenths. The VLM's logits are also of order 4: the port differs
# by up to 1.64e-5 on the CPU, within LM_F32_TOL only by 1.2x, so it takes
# mixtral's 1e-4 (~6x). whisper-small's (order 0.5, 5.7e-7 off) keep
# LM_F32_TOL.
XLSTM_F32_TOL = 5e-4
VLM_F32_TOL = 1e-4


# f32 tolerances of the LM cases whose logits are not of gemma3-1b's order
F32_TOLS = {MIXTRAL_CASE: MIXTRAL_F32_TOL, XLSTM_CASE: XLSTM_F32_TOL,
            VLM_CASE: VLM_F32_TOL}

# every pinned LM case's pins
PINNED_CASES = {LM_CASE: PINNED_LM, JAMBA_CASE: PINNED_JAMBA,
                MIXTRAL_CASE: PINNED_MIXTRAL, XLSTM_CASE: PINNED_XLSTM,
                WHISPER_CASE: PINNED_WHISPER, VLM_CASE: PINNED_VLM}


# ---------------------------------------------------------------------------
# LM training: gemma3-1b at full width and depth in f32 (``lm_config``:
# 26 layers, d_model 1152, d_ff 6912, vocab 262144, tied embeddings),
# weights ``models.seeded_numpy_params(cfg, LM_SEED)``; TRAIN_STEPS steps
# of ``make_train_step(cfg, AdamW(lr=cosine_warmup(TRAIN_LR, TRAIN_WARMUP,
# TRAIN_STEPS)))`` (the defaults: remat "block", a logit chunk of 1024,
# clipping at 1.0) on ``lm_batch_at(step, batch=TRAIN_BATCH,
# seq_len=TRAIN_SEQ, seed=TRAIN_DATA_SEED)``. The first step's learning
# rate is 0 (warm-up), the second's TRAIN_LR, the third's TRAIN_LR / 2.
#
# ``PINNED_TRAIN`` holds what the JAX package gives on the CPU (jax 0.9.0,
# ``ShardCtx(enabled=False, attention_impl="pallas")``, the kernel in
# interpret mode): per step the loss, the grad norm, ``skipped`` and the
# batch's tokens (``int_digest`` per row); after the last step, for each
# of TRAIN_LEAVES (JAX names under ``params``: the embedding, the first
# body position's stacked wq and ln1 (R = 4 repeats), and the tail's first
# ln1, a vector), the leaf's sum and the sum and absolute sum of its change
# from the initial weights (float64 over the f32 values). The body norm is
# (4, 1152), so AdamW decays it; the tail norm is (1152,) and is not: a
# wrong rule moves their changes' sums by ~0.02 and ~0.005.
# ``tests/torch_train_pins.py`` makes them.
TRAIN_CASE = "train_gemma3_1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 3
TRAIN_LR, TRAIN_WARMUP, TRAIN_DATA_SEED = 3e-4, 1, 0
TRAIN_LEAVES = ("emb", "body/0/wq", "body/0/ln1", "tail/0/ln1")
TRAIN_METRICS = ("loss", "grad_norm")
# ``train_distance`` of the port on the CPU from these pins (``python
# tests/torch_train_pins.py --port``): loss 7.6e-8, grad norm 5.7e-7,
# the leaves' sums 5.3e-7, their changes' sums 7.1e-7 and absolute sums
# 7.5e-7. The tolerances are 13-19x those.
TRAIN_TOLS = {"loss": 1e-6, "grad_norm": 1e-5, "sum": 1e-5,
              "delta_sum": 1e-5, "delta_abs_sum": 1e-5}

PINNED_TRAIN = {
    "loss": [
        12.484514236450195,
        12.480220794677734,
        12.339107513427734
    ],
    "grad_norm": [
        8.32602310180664,
        8.423545837402344,
        13.353535652160645
    ],
    "skipped": [
        0.0,
        0.0,
        0.0
    ],
    "tokens_digest": [
        [
            5149475079,
            4286259773
        ],
        [
            4784503251,
            5156841370
        ],
        [
            4637950657,
            5486022126
        ]
    ],
    "leaves": {
        "emb": {
            "sum": -2677.5074614937516,
            "delta_sum": -2609.312648400443,
            "delta_abs_sum": 85723.84984956095
        },
        "body/0/wq": {
            "sum": 38.6708164789491,
            "delta_sum": -0.5585014199507361,
            "delta_abs_sum": 1153.4542784277944
        },
        "body/0/ln1": {
            "sum": 4607.966053187847,
            "delta_sum": -0.03394681215286255,
            "delta_abs_sum": 1.25739985704422
        },
        "tail/0/ln1": {
            "sum": 1151.9932535290718,
            "delta_sum": -0.006746470928192139,
            "delta_abs_sum": 0.3185543417930603
        }
    }
}


# LM training of the other families on a mesh (``chip_smoke.py`` phase
# train_mesh_families): each case's config at full width (depth cut as
# named), f32, weights ``seeded_numpy_params(cfg, LM_SEED)``, TRAIN_STEPS
# steps of ``train_optimizer(name="adafactor")`` at TRAIN_BATCH x
# TRAIN_SEQ, with ``train_extras``, on a (1, 2) mesh: one data rank, so an
# MoE layer routes one group. ``PINNED_TRAIN_FAMILIES`` holds the JAX
# package's unsharded run on the CPU (jax 0.9.0, ``ShardCtx(enabled=False,
# dp_size=TRAIN_FAMILY_DP, attention_impl="pallas")``, the attention kernel
# in interpret mode, the Mamba scan its jnp oracle; whisper's attention
# ``attention_impl="xla"``, as the kernel's blocks do not divide its 1,500
# frames), made by ``python
# tests/torch_train_pins.py --family CASE``; each case's ``train_summary``
# of its own four leaves. No batch or length was cut.
# - ``train_mixtral_1l``: ``mixtral_config(1)`` (2.91e9 parameters: d 6144,
#   48 q and 8 KV heads, 8 experts of d_ff 16384, top-2, capacity factor
#   1.25, vocab 32768);
# - ``train_jamba_1l``: ``jamba_config(1)`` (2.10e9: its first layer, a
#   Mamba mixer of di 16384 and d_state 16 with the dense MLP of d_ff
#   24576, d 8192, vocab 65536);
# - ``train_whisper``: whisper-small whole (2.38e8: 12 encoder layers over
#   1500 audio frames, 12 decoder layers with their cross-attentions).
# Each case pins four leaves of its family's own layers. ``check_train``
# holds a leaf's sum relative to the sum itself, which for a zero-mean
# matrix is ~1e-4 of its absolute sum at these sizes, so the sum's
# distance there is its change's distance scaled up to ~1e4-fold: jamba's
# leaves are its mixer's per-channel parameters and its conv, whisper's
# three attention matrices and the cross-attention's norm scale (a first
# set with whisper's embedding and jamba's in_proj and x_proj read sum
# distances of 1.2e-5 to 3.0e-5 on the card, with every change's sum
# within 6.5e-7; ``CHANGES.md``).
TRAIN_FAMILY_OPTIMIZER = "adafactor"
TRAIN_FAMILY_DP = 1
TRAIN_FAMILY_LEAVES = {
    "train_mixtral_1l": ("emb", "body/0/e_wg", "body/0/router", "body/0/wq"),
    "train_jamba_1l": ("tail/0/A_log", "tail/0/D_skip", "tail/0/dt_b",
                       "tail/0/conv_w"),
    "train_whisper": ("encoder/layers/wq", "xattn_body/0/xk", "body/0/wq",
                      "xattn_body/0/lnx"),
}


PINNED_TRAIN_FAMILIES = {
    "train_mixtral_1l": {
    "loss": [
        10.956647872924805,
        10.914239883422852,
        21.027956008911133
    ],
    "grad_norm": [
        25.64605712890625,
        28.554584503173828,
        121.2332992553711
    ],
    "skipped": [
        0.0,
        0.0,
        0.0
    ],
    "tokens_digest": [
        [
            960466452,
            1022023967
        ],
        [
            890132525,
            1083798405
        ],
        [
            1076960589,
            1020592031
        ]
    ],
    "leaves": {
        "emb": {
            "sum": 80.00801155362318,
            "delta_sum": -8.480368311282032,
            "delta_abs_sum": 2728.177724581472
        },
        "body/0/e_wg": {
            "sum": 89.49895303966679,
            "delta_sum": -11.958017283203475,
            "delta_abs_sum": 191770.5344013727
        },
        "body/0/router": {
            "sum": -0.2656930252716876,
            "delta_sum": -0.016002834676640987,
            "delta_abs_sum": 12.702779543619158
        },
        "body/0/wq": {
            "sum": -41.27707090805042,
            "delta_sum": -1.2357408248140516,
            "delta_abs_sum": 9326.581128134143
        }
    }
},
    "train_jamba_1l": {
    "loss": [
        11.651474952697754,
        11.624408721923828,
        16.87472915649414
    ],
    "grad_norm": [
        14.809321403503418,
        15.000675201416016,
        92.18247985839844
    ],
    "skipped": [
        0.0,
        0.0,
        0.0
    ],
    "tokens_digest": [
        [
            1664304130,
            1673042962
        ],
        [
            1839440692,
            1428278125
        ],
        [
            1587489361,
            1679425407
        ]
    ],
    "leaves": {
        "tail/0/A_log": {
            "sum": 502526.9038301483,
            "delta_sum": -0.8578886017000737,
            "delta_abs_sum": 67.57149539799946
        },
        "tail/0/D_skip": {
            "sum": 16384.106711030006,
            "delta_sum": 0.10671103000640869,
            "delta_abs_sum": 4.444393515586853
        },
        "tail/0/dt_b": {
            "sum": -52995.06026339531,
            "delta_sum": 0.21325063705444336,
            "delta_abs_sum": 4.435896873474121
        },
        "tail/0/conv_w": {
            "sum": 87.80546497523574,
            "delta_sum": 0.11569453303491173,
            "delta_abs_sum": 17.727151722534472
        }
    }
},
    "train_whisper": {
    "loss": [
        10.892653465270996,
        10.88173770904541,
        10.430627822875977
    ],
    "grad_norm": [
        4.748666286468506,
        4.829595565795898,
        5.359583854675293
    ],
    "skipped": [
        0.0,
        0.0,
        0.0
    ],
    "tokens_digest": [
        [
            1665704405,
            1294067303
        ],
        [
            1385501297,
            1605207833
        ],
        [
            1381718212,
            1484343106
        ]
    ],
    "leaves": {
        "encoder/layers/wq": {
            "sum": 20.40046588660699,
            "delta_sum": 0.3971104955647653,
            "delta_abs_sum": 1725.5862845879892
        },
        "xattn_body/0/xk": {
            "sum": -29.90493801951451,
            "delta_sum": -0.04381653427316956,
            "delta_abs_sum": 1634.5898362493388
        },
        "body/0/wq": {
            "sum": 72.11827497068757,
            "delta_sum": 0.1031630523096485,
            "delta_abs_sum": 1809.5691951723315
        },
        "xattn_body/0/lnx": {
            "sum": 9215.941991329193,
            "delta_sum": -0.058008670806884766,
            "delta_abs_sum": 2.0136783123016357
        }
    }
},
}


def train_family_config(case: str, dtype: str = "float32") -> ModelConfig:
    """The config of a case of TRAIN_FAMILY_LEAVES."""
    return {"train_mixtral_1l": lambda: mixtral_config(1, dtype),
            "train_jamba_1l": lambda: jamba_config(1, dtype),
            "train_whisper": lambda: whisper_config(dtype)}[case]()


def train_config(dtype: str = "float32") -> ModelConfig:
    return lm_config(dtype)


# The training case on DTensor meshes (``chip_smoke.py`` phase
# train_mesh): the case above with gemma3-1b cut to its first
# TRAIN_MESH_LAYERS layers (one whole 5:1 period of window and global
# layers and two more: R = 1 and a tail of 2, so every leaf of
# TRAIN_LEAVES exists), every width kept; the weights
# ``seeded_numpy_params`` of that config. ``PINNED_TRAIN_MESH`` holds the
# JAX package's run of it on the CPU as ``PINNED_TRAIN`` holds the whole
# model's (``python tests/torch_train_pins.py --mesh``). The cut keeps the
# gloo worlds' steps and their 12 GB checkpoint of the whole depth out of
# the script's time.
TRAIN_MESH_LAYERS = 8


def train_mesh_config(dtype: str = "float32") -> ModelConfig:
    return dataclasses.replace(train_config(dtype),
                               n_layers=TRAIN_MESH_LAYERS)


PINNED_TRAIN_MESH = {
    "loss": [
        12.482345581054688,
        12.469634056091309,
        12.305341720581055
    ],
    "grad_norm": [
        8.067793846130371,
        8.288565635681152,
        7.882528781890869
    ],
    "skipped": [
        0.0,
        0.0,
        0.0
    ],
    "tokens_digest": [
        [
            5149475079,
            4286259773
        ],
        [
            4784503251,
            5156841370
        ],
        [
            4637950657,
            5486022126
        ]
    ],
    "leaves": {
        "emb": {
            "sum": -1225.5531690942018,
            "delta_sum": -1254.0137851021898,
            "delta_abs_sum": 89949.2515506757
        },
        "body/0/wq": {
            "sum": 33.08813924176366,
            "delta_sum": 0.19729888078545343,
            "delta_abs_sum": 326.72699219272374
        },
        "body/0/ln1": {
            "sum": 1151.9932775497437,
            "delta_sum": -0.006722450256347656,
            "delta_abs_sum": 0.3423745632171631
        },
        "tail/0/ln1": {
            "sum": 1151.9905844926834,
            "delta_sum": -0.009415507316589355,
            "delta_abs_sum": 0.33675944805145264
        }
    }
}


def train_optimizer(steps: int = TRAIN_STEPS, name: str = "adamw"):
    """The port's optimizer of the training case (``repro_torch.optim``):
    AdamW, or ``name`` ("adafactor"), on its schedule."""
    from repro_torch.optim import cosine_warmup, get_optimizer

    return get_optimizer(name, lr=cosine_warmup(TRAIN_LR, TRAIN_WARMUP,
                                                steps))


SUMMARY_BLOCK = 1 << 24   # values a leaf's sums read at a time


def train_summary(metrics: list, tokens: list, params0: dict,
                  params: dict, leaves=TRAIN_LEAVES) -> dict:
    """The pinned form of a training run: ``metrics`` one dict of floats a
    step, ``tokens`` each step's (B, S) token ids, ``params0`` and
    ``params`` the ``leaves`` (name -> f32 array; TRAIN_LEAVES by
    default) before the first and after the last step."""
    names, leaves = leaves, {}
    for name in names:
        p0 = np.asarray(params0[name]).reshape(-1)
        p = np.asarray(params[name]).reshape(-1)
        sums = np.zeros(3)
        for lo in range(0, p.size, SUMMARY_BLOCK):    # float64 a block
            b0 = p0[lo:lo + SUMMARY_BLOCK].astype(np.float64)
            b = p[lo:lo + SUMMARY_BLOCK].astype(np.float64)
            sums += (b.sum(), (b - b0).sum(), np.abs(b - b0).sum())
        leaves[name] = {"sum": float(sums[0]), "delta_sum": float(sums[1]),
                        "delta_abs_sum": float(sums[2])}
    return {**{k: [float(m[k]) for m in metrics] for k in TRAIN_METRICS},
            "skipped": [float(m["skipped"]) for m in metrics],
            "tokens_digest": [int_digest(t) for t in tokens],
            "leaves": leaves}


def train_distance(got: dict, pins: dict) -> dict:
    """How far a run's ``train_summary`` lies from ``pins``, per kind:
    the metrics relative to the pin, a leaf's sum relative to it, its
    change's sums relative to the change's absolute sum."""
    out = {k: max(abs(g - w) / abs(w) for g, w in zip(got[k], pins[k]))
           for k in TRAIN_METRICS}
    for kind in ("sum", "delta_sum", "delta_abs_sum"):
        out[kind] = max(
            abs(got["leaves"][n][kind] - pins["leaves"][n][kind])
            / abs(pins["leaves"][n]["sum" if kind == "sum"
                                    else "delta_abs_sum"])
            for n in pins["leaves"])
    return out


def check_train(got: dict, pins: dict | None = None,
                tols: dict | None = None) -> dict:
    """Hold a ``train_summary`` to the pins (``PINNED_TRAIN`` by default):
    ``skipped`` and the token digests equal, every distance of
    ``train_distance`` within ``tols`` (TRAIN_TOLS). Raises on a miss;
    returns the distances beside their tolerances."""
    pins = pins or PINNED_TRAIN
    tols = tols or TRAIN_TOLS
    if got["tokens_digest"] != pins["tokens_digest"]:
        raise AssertionError(f"{TRAIN_CASE}: the batches' tokens differ "
                             "from the pinned ones")
    if got["skipped"] != pins["skipped"]:
        raise AssertionError(f"{TRAIN_CASE}: skipped {got['skipped']}, "
                             f"pinned {pins['skipped']}")
    dist = train_distance(got, pins)
    report = {f"dist_{k}": v for k, v in dist.items()}
    report.update({f"tol_{k}": tols[k] for k in dist})
    off = [k for k, v in dist.items() if not v <= tols[k]]
    if off:
        raise AssertionError(f"{TRAIN_CASE}: {off} off the pins: "
                             f"{ {k: dist[k] for k in off} } (tolerances "
                             f"{ {k: tols[k] for k in off} })")
    return report


def train_extras(cfg: ModelConfig, step: int, batch: int) -> dict:
    """The memory input of step ``step``'s training batch, where the model
    attends to one (the VLM's ``vision`` tokens, whisper's ``audio``
    frames), as f32 numpy: ``0.02 *`` a standard normal from numpy's
    generator seeded with (TRAIN_DATA_SEED, step), the same in every
    process and in both packages (``lm_batch_at``'s own extras are keyed
    by a hash that Python salts per process)."""
    from repro_torch.models.spec import memory_input

    name, m = memory_input(cfg)
    if name is None:
        return {}
    rng = np.random.default_rng([TRAIN_DATA_SEED, step])
    return {name: np.float32(0.02) * rng.standard_normal(
        (batch, m, cfg.d_model), dtype=np.float32)}


def run_train(cfg: ModelConfig, tree: dict, device, *,
              steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
              seq: int = TRAIN_SEQ, optimizer: str = "adamw", mesh=None,
              leaves=TRAIN_LEAVES) -> tuple:
    """The training case on the port: the f32 numpy weights ``tree`` (the
    JAX layout) as a train state on ``device``, ``steps`` steps of
    ``train_optimizer``'s ``make_train_step`` on ``lm_batch_at``. With a
    (data, model) ``mesh`` (``launch.mesh.make_mesh_for``) the state and
    the batches are DTensors on it, by ``train_state_pspecs`` and
    ``batch_pspecs``, and the step runs sharded; an MoE model routes
    groups of its data-parallel degree. A model with a memory reads
    ``train_extras``. Returns
    (``train_summary`` of ``leaves``, the kernel launches of each step,
    each step's seconds up to its metrics on the host)."""
    import time

    import torch

    from repro_torch import kernels
    from repro_torch.data.synth_lm import lm_batch_at
    from repro_torch.interop import tree_from_numpy
    from repro_torch.optim.base import plain
    from repro_torch.sharding.ctx import UNSHARDED
    from repro_torch.train import make_train_step
    from repro_torch.utils.tree import tree_leaves_with_names

    opt = train_optimizer(steps, optimizer)
    # the initial leaves, not copied: a step makes new tensors, so
    # nothing writes into the arrays of ``tree``
    named = dict(tree_leaves_with_names(tree))
    params0 = {n: named[n] for n in leaves}
    del named
    ctx, put = UNSHARDED, lambda tree, specs: tree
    step0 = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is None:
        params = tree_from_numpy(tree, device)
        state = {"params": params, "opt": opt.init(params), "step": step0}
    else:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.sharding.ctx import make_ctx
        from repro_torch.sharding.specs import (
            batch_pspecs,
            distribute,
            distribute_leaf,
            spec_leaves,
            train_state_pspecs,
        )
        from repro_torch.utils.tree import tree_map_with_path_names

        ctx = make_ctx(False, tp_size=mesh["model"].size(),
                       dp_size=mesh["data"].size())
        specs = train_state_pspecs(cfg, ctx, opt, mesh)
        by = dict(spec_leaves(specs["params"]))
        # each rank's shard of each leaf cut on the host
        params = tree_map_with_path_names(
            lambda n, x: distribute_leaf(tree_from_numpy(x, "cpu"), by[n],
                                         mesh), tree)
        state = {"params": params,
                 "opt": distribute(opt.init(params), specs["opt"], mesh),
                 "step": distribute(step0, specs["step"], mesh)}
        batch_ps = batch_pspecs(cfg, ShapeConfig("train", seq, batch,
                                                 "train"), ctx)
        put = lambda tree, specs: distribute(tree, specs, mesh)  # noqa: E731
    del params
    step = make_train_step(cfg, opt, ctx)
    metrics, tokens, launches, seconds = [], [], [], []
    for i in range(steps):
        b = lm_batch_at(i, vocab=cfg.vocab, batch=batch, seq_len=seq,
                        seed=TRAIN_DATA_SEED, device=device)
        b.update({k: torch.from_numpy(v).to(device)
                  for k, v in train_extras(cfg, i, batch).items()})
        tokens.append(b["tokens"].cpu().numpy())
        if mesh is not None:
            b = put(b, batch_ps)
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(kernels.LAUNCHES))
    named = dict(tree_leaves_with_names(state["params"]))
    return (train_summary(metrics, tokens, params0,
                          {n: plain(named[n]).cpu().numpy() for n in leaves},
                          leaves),
            launches, seconds)


# ---------------------------------------------------------------------------
# The RL cases: the paper's experiment (Fig. 2), ``launch/rl_train.py
# --cluster tx-gaia``'s setting at full width: ``tx_gaia(max_jobs=256,
# max_nodes_per_job=16)`` (672 nodes, the whole job table), a bank of
# RL_WORKLOADS ``synth_workload(cfg, 40, 1800.0, seed=s)``, episodes of 32
# decisions of 15 ticks each, per-tick stepping (``macro=False``; the
# macro env, the JAX package's default, in ``PINNED_RL_MACRO``).
#
# - ``rl_tx_gaia``: RL_ENVS environments reset from ``split(key(0), 8)``,
#   then ``RL_SCRIPT_STEPS`` decisions of ``rl_script`` (every candidate
#   index, the no-op k, and indices past the queued candidates).
# - ``rl_tx_gaia_thermal_stress``: the same on the stress hour's config
#   with the thermal observation block, for fewer decisions.
# - ``ppo``: ``ppo_train(seed=0, n_iterations=RL_ITERATIONS)`` with
#   ``PPOConfig(n_envs=8, rollout_len=32)``: iteration 0's rollout (its
#   sampled actions, mean reward and mean value, before any update) and
#   the stats of every iteration.
RL_CASES = {
    "rl_tx_gaia": {},
    "rl_tx_gaia_thermal_stress": dict(thermal_enabled=True,
                                      **THERMAL_STRESS),
    "rl_tx_gaia_faults": dict(degrade_enabled=True, **FAULTS),
    "rl_tx_gaia_serving": SERVING,
}
RL_SCRIPT_STEPS = {"rl_tx_gaia": 32, "rl_tx_gaia_thermal_stress": 8}
RL_WORKLOADS, RL_JOBS, RL_HORIZON_S = 4, 40, 1800.0
RL_EPISODE_STEPS, RL_SIM_STEPS = 32, 15
RL_ENVS, RL_ROLLOUT, RL_ITERATIONS = 8, 32, 2
RL_SEED = 0
RL_INFO = ("facility_w", "queue_len", "completed", "energy_kwh",
           "carbon_kg")
RL_INT_FIELDS = ("jstate", "placement", "n_nodes", "workload")
RL_STATS_RTOL = 1e-3   # PPO stats after Adam updates


def rl_config(case: str = "rl_tx_gaia") -> SimConfig:
    return tx_gaia(max_jobs=256, max_nodes_per_job=16, **RL_CASES[case])


def rl_workloads(cfg: SimConfig) -> list:
    return [synth_workload(cfg, RL_JOBS, RL_HORIZON_S, seed=s)
            for s in range(RL_WORKLOADS)]


def rl_env_kwargs(macro: bool = False, case: str = "rl_tx_gaia") -> dict:
    """``SchedEnv`` keywords of the RL cases, the same in both packages
    (``PINNED_RL``: per-tick; ``PINNED_RL_MACRO``: ``macro=True``; the
    fault and serving cases add their reward weights, and the serving
    case its scenario, ``rl_scenario``)."""
    kw = dict(episode_steps=RL_EPISODE_STEPS,
              sim_steps_per_action=RL_SIM_STEPS, macro=macro)
    if case == RL_FAULTS_CASE:
        kw["reward_weights"] = RL_FAULTS_WEIGHTS
    if case == RL_SERVING_CASE:
        kw["reward_weights"] = RL_SERVING_WEIGHTS
    return kw


def rl_scenario(case: str, cfg: SimConfig):
    """The port's scenario of an RL case (``None``: the default grid)."""
    if case != RL_SERVING_CASE:
        return None
    return serving_scenario(cfg, RL_SERVING_TRAFFIC)


# ``rl_tx_gaia_faults``: ``rl_tx_gaia`` with the faults hour's MTBFs,
# checkpoints and retries and the degradation ladder schedulable (5 more
# actions), the lost-work reward term on; RL_FAULTS_STEPS decisions of
# ``rl_fault_script``, per tick and macro (``PINNED_RL_FAULTS``, made by
# ``tests/torch_fault_pins.py``): floats to RTOL, dones, the integer
# digests (the ladder level among them) exactly.
RL_FAULTS_CASE = "rl_tx_gaia_faults"
RL_FAULTS_STEPS = 16
RL_FAULTS_WEIGHTS = (1.0, 1.0, 1.0, 0.05, 0.0, 0.5)
RL_FAULTS_INT_FIELDS = RL_INT_FIELDS + ("degrade_level", "n_failures")


def rl_fault_script(k: int, n_envs: int, steps: int) -> np.ndarray:
    """(steps, n_envs) int32 actions over the ladder's action space: env e
    at step t takes (t + 3 e) mod (k + 6), so every dispatch index, the
    no-op k and the five rungs k + 1 + r recur."""
    t = np.arange(steps)[:, None]
    e = np.arange(n_envs)[None, :]
    return ((t + 3 * e) % (k + 6)).astype(np.int32)


def rl_script(k: int, n_envs: int, steps: int) -> np.ndarray:
    """(steps, n_envs) int32 actions: env e at step t takes
    (t + 3 e) mod (k + 1), so every candidate index and the no-op k
    recur in every env."""
    t = np.arange(steps)[:, None]
    e = np.arange(n_envs)[None, :]
    return ((t + 3 * e) % (k + 1)).astype(np.int32)


def int_digest(a) -> list:
    """One exact int per row of an integer array (a leading env axis):
    sum over the row's flat entries of value * (position + 1)."""
    a = np.asarray(a).astype(np.int64)
    a = a.reshape(a.shape[0], -1)
    return (a * np.arange(1, a.shape[1] + 1, dtype=np.int64)).sum(1).tolist()


def rl_record(actions, k: int, n_valid, rewards, dones, infos, obs,
              sim, int_fields=RL_INT_FIELDS) -> dict:
    """The pinned form of a scripted rollout, from numpy: per step the
    (E,) rewards, dones and info fields, the final observations, the
    final integer sim fields as ``int_digest``s and the completions, and
    how many of the (steps, E) ``actions`` pointed past the queued
    candidates (``n_valid``: valid candidates before each step)."""
    actions = np.asarray(actions)
    past = (actions < k) & (actions >= np.asarray(n_valid))
    return {
        "reward": np.asarray(rewards, np.float64).tolist(),
        "done": np.asarray(dones).astype(bool).tolist(),
        **{f: np.asarray(infos[f], np.float64).tolist() for f in RL_INFO},
        "final_obs": np.asarray(obs, np.float64).tolist(),
        **{f"digest_{f}": int_digest(sim[f]) for f in int_fields},
        "n_completed": np.asarray(sim["n_completed"], np.float64).tolist(),
        "past_queued": int(past.sum()),
    }


def run_rl_script(env, case: str, steps: int | None = None,
                  guard=None) -> dict:
    """A scripted rollout of the port's ``SchedEnv`` for ``case``:
    RL_ENVS environments reset from ``split(key(RL_SEED), RL_ENVS)``, then
    ``steps`` decisions of ``rl_script`` (default ``RL_SCRIPT_STEPS``; the
    fault case: ``rl_fault_script``, RL_FAULTS_STEPS, its integer fields
    with the ladder level; the serving case: ``rl_serving_script``,
    RL_SERVING_STEPS), inside the context manager ``guard()`` when
    one is given (the reset and the steps; the results reach the host
    after it). Returns ``rl_record``'s form."""
    import contextlib

    import torch

    from repro_torch.utils import prng
    from repro_torch.utils.device import to_device

    faults = case == RL_FAULTS_CASE
    serving = case == RL_SERVING_CASE
    if steps is None:
        steps = (RL_FAULTS_STEPS if faults else RL_SERVING_STEPS if serving
                 else RL_SCRIPT_STEPS[case])
    dev = env.device
    script = (rl_fault_script if faults else rl_serving_script if serving
              else rl_script)(env.k, RL_ENVS, steps)
    int_fields = RL_FAULTS_INT_FIELDS if faults else RL_INT_FIELDS
    rec = {"reward": [], "done": [], "n_valid": [],
           **{f: [] for f in RL_INFO}}
    # the candidates' "valid" flags open the candidate block, the last
    # 8 k entries of an observation
    valid_at = slice(env.obs_dim - 8 * env.k, env.obs_dim - 7 * env.k)
    with (guard or contextlib.nullcontext)():
        key = to_device(torch.from_numpy(prng.key_words(RL_SEED)), dev)
        st, obs = env.reset(prng.split(key, RL_ENVS))
        acts = to_device(torch.from_numpy(script).long(), dev)
        for t in range(steps):
            rec["n_valid"].append(obs[:, valid_at].sum(-1))
            st, obs, r, d, info = env.step(st, acts[t])
            rec["reward"].append(r)
            rec["done"].append(d)
            for f in RL_INFO:
                rec[f].append(info[f])

    def host(x):
        return torch.stack(x).cpu().numpy()

    sim = {f: getattr(st.sim, f).cpu().numpy()
           for f in int_fields + ("n_completed",)}
    return rl_record(script, env.k, host(rec["n_valid"]), host(rec["reward"]),
                     host(rec["done"]), {f: host(rec[f]) for f in RL_INFO},
                     obs.cpu().numpy(), sim, int_fields)


def check_rl(case: str, got: dict, pins: dict | None = None) -> dict:
    """Hold a scripted rollout (``rl_record``'s form) to ``PINNED_RL[case]``:
    dones, digests and the past-queued count exactly, every float within
    ``RTOL`` of its pin (``completed`` and ``n_completed`` exactly). Raises
    on a miss; returns the largest relative error."""
    pins = PINNED_RL[case] if pins is None else pins
    worst = 0.0
    for f, want in pins.items():
        g, w = np.asarray(got[f]), np.asarray(want)
        if g.shape != w.shape:
            raise AssertionError(f"{case}: {f} shape {g.shape} vs pinned "
                                 f"{w.shape}")
        if f in ("done", "past_queued", "completed", "n_completed") \
                or f.startswith("digest_"):
            if not np.array_equal(g, w):
                raise AssertionError(f"{case}: {f} differs from the pins "
                                     f"at {np.argwhere(g != w).tolist()[:8]}")
            continue
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
        rel = np.where(g == w, 0.0, rel)
        worst = max(worst, float(rel.max()))
        if not np.all(rel <= RTOL):
            raise AssertionError(
                f"{case}: {f} off the pins by rel {rel.max():.3g} at "
                f"{np.argwhere(rel > RTOL).tolist()[:8]} (rtol {RTOL})")
    return {"max_rel_err": worst}


def run_ppo(env, guard=None, n_iterations: int = RL_ITERATIONS) -> dict:
    """The ``ppo`` case on the port: iteration 0's rollout, its keys split
    as ``ppo_train`` splits them (before any update), then
    ``ppo_train(seed=RL_SEED, n_iterations=...)`` with ``PPOConfig(n_envs=
    RL_ENVS, rollout_len=RL_ROLLOUT)``, each inside ``guard()`` when one is
    given. Returns ``check_ppo``'s form and the trained parameters."""
    import contextlib

    import torch

    from repro_torch.rl import ActorCritic, PPOConfig, ppo_train
    from repro_torch.rl.ppo import make_rollout
    from repro_torch.utils import prng
    from repro_torch.utils.device import to_device

    guard = guard or contextlib.nullcontext
    cfg = PPOConfig(n_envs=RL_ENVS, rollout_len=RL_ROLLOUT)
    policy = ActorCritic(env.obs_dim, env.n_actions, device=env.device)
    with guard():
        key = to_device(torch.from_numpy(prng.key_words(RL_SEED)), env.device)
        key, kp, ke = prng.split(key, 3)
        params = policy.init(kp)
        states, _ = env.reset(prng.split(ke, cfg.n_envs))
        _, kroll, _ = prng.split(key, 3)
        _, batch, _, _ = make_rollout(env, policy, cfg)(params, states,
                                                        kroll)
    out = {"actions0": batch.action.cpu().numpy().tolist(),
           "mean_reward0": float(batch.reward.mean()),
           "mean_value0": float(batch.value.mean())}
    with guard():
        params, history = ppo_train(env, cfg=cfg, n_iterations=n_iterations,
                                    seed=RL_SEED)
    out["history"] = history
    return out, params


def check_ppo(got: dict, pins: dict | None = None) -> dict:
    """Hold a PPO run to ``PINNED_RL["ppo"]``: iteration 0's sampled
    actions exactly, its rollout's mean reward and mean value within
    ``RTOL``, every iteration's stats within ``RL_STATS_RTOL``. Raises on
    a miss; returns the largest relative errors."""
    pins = PINNED_RL["ppo"] if pins is None else pins
    a, w = np.asarray(got["actions0"]), np.asarray(pins["actions0"])
    if not np.array_equal(a, w):
        raise AssertionError(f"ppo: iteration 0's actions differ at "
                             f"{np.argwhere(a != w).tolist()[:8]}")
    out = {}
    for f, tol in (("mean_reward0", RTOL), ("mean_value0", RTOL)):
        rel = abs(got[f] - pins[f]) / abs(pins[f])
        out[f"rel_err_{f}"] = rel
        if rel > tol:
            raise AssertionError(f"ppo: {f} {got[f]!r} vs pinned "
                                 f"{pins[f]!r} (rtol {tol})")
    worst = 0.0
    for i, (gs, ws) in enumerate(zip(got["history"], pins["history"])):
        for k, v in ws.items():
            rel = abs(gs[k] - v) / max(abs(v), 1e-30)
            worst = max(worst, rel)
            if rel > RL_STATS_RTOL:
                raise AssertionError(
                    f"ppo: iteration {i} {k} {gs[k]!r} vs pinned {v!r} "
                    f"(rtol {RL_STATS_RTOL})")
    if len(got["history"]) != len(pins["history"]):
        raise AssertionError("ppo: iteration counts differ")
    out["max_rel_err_stats"] = worst
    return out


# ``PINNED_RL``: what the JAX package gives for the RL cases on the CPU (jax
# 0.9.0, ``SchedEnv(macro=False)``), in ``rl_record``'s form, and for
# ``ppo``, iteration 0's rollout and the stats of RL_ITERATIONS iterations
# of ``ppo_train``; made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_rl_pins.py
# (25 s on 8 cores). ``check_rl`` and ``check_ppo`` hold a run to them.
PINNED_RL = {
    "rl_tx_gaia": {
        "reward": [[-3.1442566, -3.151687, -3.151687, -3.1439064, -3.150687,
            -3.153687, -3.1439064, -3.151687], [-3.1510234, -3.1581867,
            -3.1581867, -3.1533337, -3.150687, -3.1581867, -3.1533337,
            -3.1581867], [-3.1513844, -3.1581864, -3.1581864, -3.158251,
            -3.1506855, -3.164686, -3.158251, -3.1581864], [-3.1516461,
            -3.1581843, -3.1507533, -3.1616635, -3.172184, -3.1585217,
            -3.1616635, -3.1581843], [-3.1519957, -3.158183, -3.1510181,
            -3.1643724, -3.1751823, -3.1579285, -3.1643724, -3.158183],
            [-3.151966, -3.15818, -3.1513789, -3.1696324, -3.1806793,
            -3.1620994, -3.1696324, -3.15818], [-3.1520357, -3.1507463,
            -3.151639, -3.1731215, -3.1748374, -3.1640158, -3.1731215,
            -3.1507463], [-3.1520367, -3.1510105, -3.1519866, -3.172401,
            -3.1746058, -3.1671817, -3.172401, -3.1510105], [-3.1520383,
            -3.1513689, -3.1519563, -3.1733036, -3.1771884, -3.1741574,
            -3.1733036, -3.1513689], [-3.1449497, -3.151627, -3.152025,
            -3.1655972, -3.189691, -3.1746476, -3.1655972, -3.151627],
            [-3.1472738, -3.1519744, -3.1520236, -3.1654172, -3.20267,
            -3.1738667, -3.1654172, -3.1519744], [-3.1501267, -3.1519418,
            -3.1520243, -3.165823, -3.2057414, -3.174261, -3.165823,
            -3.1519418], [-3.1526875, -3.152009, -3.1449347, -3.1728818,
            -3.2106519, -3.1759887, -3.1728818, -3.152009], [-3.1546576,
            -3.1520069, -3.1472569, -3.1819475, -3.2103093, -3.1795337,
            -3.1819475, -3.1520069], [-3.1552398, -3.1520061, -3.1501083,
            -3.1872387, -3.2155044, -3.1774893, -3.1872387, -3.1520061],
            [-3.1542397, -3.1449146, -3.1526673, -3.1982167, -3.2084594,
            -3.177203, -3.1982167, -3.1449146], [-3.1542673, -3.147236,
            -3.1546366, -3.2016263, -3.202606, -3.1854641, -3.2016263,
            -3.147236], [-3.1623106, -3.1575856, -3.1627173, -2.1993966,
            -3.1937423, -3.192275, -2.1993966, -3.1575856], [-3.1652377,
            -3.1706433, -3.1722155, -3.1895876, -3.1981633, -3.1946435,
            -3.1895876, -3.1706433], [-3.1627498, -3.1771114, -3.1767416,
            -3.1905813, -3.200392, -3.196644, -3.1905813, -3.1771114],
            [-3.1625803, -3.1776905, -3.177284, -3.1957605, -3.2027535,
            -3.19729, -3.1957605, -3.1776905], [-3.1634877, -3.176687,
            -3.1697097, -3.1965091, -3.2022634, -3.1900158, -3.1965091,
            -3.176687], [-3.1645458, -3.176712, -3.16272, -3.1969995,
            -3.2047267, -3.1925771, -3.1969995, -3.176712], [-3.165065,
            -3.178253, -3.1635492, -3.2044778, -3.2087352, -3.196089,
            -3.2044778, -3.178253], [-3.171016, -3.1771772, -3.1709552,
            -3.2046094, -3.1985748, -3.2035863, -3.2046094, -3.1771772],
            [-3.1771598, -3.1751864, -3.177012, -3.2027555, -3.189743,
            -3.2102177, -3.2027555, -3.1751864], [-3.1794572, -3.1702888,
            -3.1790297, -3.202749, -3.189187, -3.2217498, -3.202749,
            -3.1702888], [-3.1860619, -3.186337, -3.1924791, -3.1950555,
            -3.19331, -3.2241511, -3.1950555, -3.186337], [-3.1806915,
            -3.1899652, -3.1946216, -3.185587, -3.1945577, -3.2248719,
            -3.185587, -3.1899652], [-3.1793108, -3.195372, -3.198918,
            -3.186577, -3.197395, -2.2293715, -3.186577, -3.195372],
            [-3.1854262, -3.198808, -3.194521, -3.1971843, -3.2000272,
            -3.2230248, -3.1971843, -3.198808], [-3.189425, -3.199946,
            -3.1881492, -3.2027102, -3.2001736, -3.2217264, -3.2027102,
            -3.199946]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [True, True, True, True,
            True, True, True, True]],
        "facility_w": [[241412.77, 241396.77, 241396.77, 241562.39, 241396.77,
            241396.77, 241562.39, 241396.77], [241427.56, 241396.78, 241396.78,
            241734.06, 241396.78, 241396.78, 241734.06, 241396.78], [241458.1,
            241396.78, 241396.78, 242136.38, 241396.78, 241396.78, 242136.38,
            241396.78], [241476.92, 241396.8, 241412.8, 242291.8, 241396.8,
            241474.5, 242291.8, 241396.8], [241504.86, 241396.81, 241427.6,
            242431.78, 241396.81, 241571.19, 242431.78, 241396.81], [241490.97,
            241396.83, 241458.14, 242486.7, 241396.83, 241758.34, 242486.7,
            241396.83], [241502.67, 241412.84, 241476.97, 242520.5, 241779.4,
            241889.36, 242520.5, 241412.84], [241500.97, 241427.66, 241504.92,
            242474.02, 242240.75, 242054.1, 242474.02, 241427.66], [241496.39,
            241458.22, 241491.05, 242557.2, 243183.48, 242035.34, 242557.2,
            241458.22], [241613.88, 241477.06, 241502.75, 242539.62, 243787.17,
            242058.03, 242539.62, 241477.06], [241752.05, 241505.03, 241501.06,
            242535.94, 244475.06, 242005.9, 242535.94, 241505.03], [242004.12,
            241491.16, 241496.5, 242517.7, 244168.81, 242004.97, 242517.7,
            241491.16], [242198.48, 241502.88, 241614.0, 242439.53, 244108.22,
            241998.2, 242439.53, 241502.88], [242273.3, 241501.2, 241752.17,
            242525.08, 244264.47, 242079.69, 242525.08, 241501.2], [242359.84,
            241496.64, 242004.25, 242519.16, 244067.8, 242190.38, 242519.16,
            241496.64], [242194.16, 241614.16, 242198.62, 242342.84, 244139.55,
            242470.1, 242342.84, 241614.16], [242283.5, 241752.34, 242273.47,
            242430.56, 244215.08, 242679.52, 242430.56, 241752.34], [242193.38,
            242004.44, 242360.02, 241438.03, 244079.31, 242982.12, 241438.03,
            242004.44], [242339.06, 242198.81, 242194.34, 241433.19, 244579.64,
            243088.6, 241433.19, 242198.81], [242303.34, 242273.66, 242283.69,
            241770.17, 244659.64, 243202.56, 241770.17, 242273.66], [242320.47,
            242360.22, 242193.56, 242096.47, 244849.34, 243293.19, 242096.47,
            242360.22], [242395.03, 242194.56, 242339.28, 242941.78, 244744.23,
            243365.31, 242941.78, 242194.56], [242511.23, 242283.9, 242303.56,
            243385.38, 244742.48, 243565.72, 243385.38, 242283.9], [242365.47,
            242193.81, 242320.7, 243814.28, 244698.86, 244032.72, 243814.28,
            242193.81], [242394.75, 242339.53, 242395.27, 243822.53, 244583.69,
            244455.73, 243822.53, 242339.53], [242515.48, 242303.81, 242511.5,
            243615.94, 244361.31, 244831.94, 243615.94, 242303.81], [242444.67,
            242384.28, 242365.72, 243707.89, 244475.1, 245231.2, 243707.89,
            242384.28], [242570.69, 242527.27, 242395.03, 243615.94, 244786.6,
            245346.73, 243615.94, 242527.27], [242599.25, 242799.25, 242515.77,
            243493.83, 245039.94, 245391.12, 243493.83, 242799.25], [242740.31,
            242726.84, 242444.97, 243504.66, 244922.66, 244762.34, 243504.66,
            242726.84], [243034.66, 242807.72, 242570.98, 243759.61, 245246.17,
            245033.92, 243759.61, 242807.72], [243154.27, 242928.06, 242599.58,
            243731.61, 245178.06, 245395.44, 243731.61, 242928.06]],
        "queue_len": [[1.0, 2.0, 2.0, 0.0, 1.0, 2.0, 0.0, 2.0], [1.0, 2.0, 2.0,
            1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0, 1.0, 1.0, 3.0, 1.0, 2.0],
            [1.0, 2.0, 1.0, 1.0, 4.0, 2.0, 1.0, 2.0], [1.0, 2.0, 1.0, 1.0, 5.0,
            2.0, 1.0, 2.0], [1.0, 2.0, 1.0, 2.0, 5.0, 2.0, 2.0, 2.0], [1.0,
            1.0, 1.0, 2.0, 4.0, 2.0, 2.0, 1.0], [1.0, 1.0, 1.0, 2.0, 3.0, 3.0,
            2.0, 1.0], [1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 2.0, 1.0], [0.0, 1.0,
            1.0, 1.0, 3.0, 3.0, 1.0, 1.0], [0.0, 1.0, 1.0, 1.0, 3.0, 3.0, 1.0,
            1.0], [0.0, 1.0, 1.0, 2.0, 4.0, 4.0, 2.0, 1.0], [0.0, 1.0, 0.0,
            3.0, 4.0, 4.0, 3.0, 1.0], [0.0, 1.0, 0.0, 4.0, 5.0, 4.0, 4.0, 1.0],
            [0.0, 1.0, 0.0, 4.0, 5.0, 4.0, 4.0, 1.0], [0.0, 0.0, 0.0, 6.0, 4.0,
            3.0, 6.0, 0.0], [0.0, 0.0, 0.0, 6.0, 3.0, 4.0, 6.0, 0.0], [1.0,
            1.0, 1.0, 6.0, 2.0, 4.0, 6.0, 1.0], [2.0, 3.0, 3.0, 7.0, 2.0, 4.0,
            7.0, 3.0], [1.0, 3.0, 3.0, 7.0, 2.0, 4.0, 7.0, 3.0], [1.0, 3.0,
            3.0, 6.0, 2.0, 4.0, 6.0, 3.0], [1.0, 3.0, 2.0, 5.0, 2.0, 3.0, 5.0,
            3.0], [1.0, 3.0, 1.0, 4.0, 3.0, 3.0, 4.0, 3.0], [2.0, 4.0, 2.0,
            4.0, 3.0, 3.0, 4.0, 4.0], [2.0, 3.0, 2.0, 4.0, 2.0, 3.0, 4.0, 3.0],
            [3.0, 3.0, 3.0, 4.0, 1.0, 4.0, 4.0, 3.0], [3.0, 2.0, 3.0, 4.0, 1.0,
            4.0, 4.0, 2.0], [4.0, 4.0, 5.0, 3.0, 1.0, 4.0, 3.0, 4.0], [3.0,
            4.0, 5.0, 2.0, 1.0, 4.0, 2.0, 4.0], [3.0, 5.0, 6.0, 3.0, 1.0, 5.0,
            3.0, 5.0], [3.0, 5.0, 5.0, 4.0, 1.0, 5.0, 4.0, 5.0], [3.0, 5.0,
            4.0, 4.0, 1.0, 4.0, 4.0, 5.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 1.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
        "energy_kwh": [[1.0058422, 1.00582, 1.00582, 1.0060499, 1.00582,
            1.00582, 1.0060499, 1.00582], [1.0059277, 1.00582, 1.00582,
            1.0069867, 1.00582, 1.00582, 1.0069867, 1.00582], [1.0060436,
            1.0058202, 1.0058202, 1.0082408, 1.0058202, 1.0058202, 1.0082408,
            1.0058202], [1.0061277, 1.0058202, 1.0058422, 1.0093335, 1.0058202,
            1.005928, 1.0093335, 1.0058202], [1.0062402, 1.0058202, 1.0059277,
            1.0102009, 1.0058202, 1.0063788, 1.0102009, 1.0058202], [1.0062319,
            1.0058202, 1.0060438, 1.010285, 1.0058202, 1.0070745, 1.010285,
            1.0058202], [1.0062551, 1.0058423, 1.0061278, 1.0106024, 1.0063516,
            1.0076886, 1.0106024, 1.0058423], [1.0062563, 1.0059279, 1.0062406,
            1.010373, 1.0086786, 1.0085429, 1.010373, 1.0059279], [1.0062584,
            1.006044, 1.006232, 1.0106632, 1.0119061, 1.0085361, 1.0106632,
            1.006044], [1.0063914, 1.0061283, 1.0062554, 1.0105987, 1.0149488,
            1.0086948, 1.0105987, 1.0061283], [1.0071367, 1.006241, 1.0062569,
            1.0105426, 1.0176636, 1.0084465, 1.0105426, 1.006241], [1.0080515,
            1.0062323, 1.0062586, 1.0105143, 1.0178483, 1.0084145, 1.0105143,
            1.0062323], [1.0088729, 1.006256, 1.006392, 1.010375, 1.0178217,
            1.0083293, 1.010375, 1.006256], [1.0095055, 1.0062573, 1.0071373,
            1.0103983, 1.0175542, 1.0083458, 1.0103983, 1.0062573], [1.0096942,
            1.0062593, 1.0080522, 1.0103337, 1.0169789, 1.0089741, 1.0103337,
            1.0062593], [1.0093766, 1.0063927, 1.0088733, 1.0100092, 1.017127,
            1.009525, 1.0100092, 1.0063927], [1.009388, 1.007138, 1.0095062,
            1.0101429, 1.0176567, 1.0108911, 1.0101429, 1.007138], [1.0095649,
            1.0080527, 1.0096948, 1.0094321, 1.017223, 1.0119534, 1.0094321,
            1.0080527], [1.0095445, 1.008874, 1.0093771, 1.0059762, 1.0186409,
            1.0127143, 1.0059762, 1.008874], [1.0097114, 1.0095072, 1.0093888,
            1.0064574, 1.0193572, 1.0133576, 1.0064574, 1.0095072], [1.0096604,
            1.0096956, 1.0095657, 1.008278, 1.0201163, 1.0135674, 1.008278,
            1.0096956], [1.0099543, 1.0093781, 1.0095453, 1.0109214, 1.0199629,
            1.0136435, 1.0109214, 1.0093781], [1.0102966, 1.0093896, 1.0097122,
            1.0134819, 1.0193149, 1.0144666, 1.0134819, 1.0093896], [1.0101464,
            1.0095667, 1.0096612, 1.0158788, 1.0196415, 1.0157543, 1.0158788,
            1.0095667], [1.0099746, 1.0095463, 1.0099553, 1.0159247, 1.0187941,
            1.0179976, 1.0159247, 1.0095463], [1.0103449, 1.0097134, 1.0102975,
            1.0153358, 1.0183719, 1.0198036, 1.0153358, 1.0097134], [1.0102844,
            1.0097505, 1.0101476, 1.0153381, 1.0181984, 1.0214186, 1.0153381,
            1.0097505], [1.0103222, 1.0104103, 1.0099758, 1.0152806, 1.0195222,
            1.0221916, 1.0152806, 1.0104103], [1.0106883, 1.0112559, 1.0103459,
            1.0146551, 1.0199263, 1.022427, 1.0146551, 1.0112559], [1.0112114,
            1.0115511, 1.0102855, 1.0148169, 1.0208391, 1.0216317, 1.0148169,
            1.0115511], [1.0122135, 1.0116956, 1.0103235, 1.0153362, 1.0216866,
            1.0204058, 1.0153362, 1.0116956], [1.0134983, 1.0120648, 1.0106897,
            1.0153497, 1.0217384, 1.0214354, 1.0153497, 1.0120648]],
        "carbon_kg": [[0.5029211, 0.50290996, 0.50290996, 0.50302494,
            0.50290996, 0.50290996, 0.50302494, 0.50290996], [0.50296366,
            0.50290984, 0.50290984, 0.50349325, 0.50290984, 0.50290984,
            0.50349325, 0.50290984], [0.50302136, 0.5029095, 0.5029095,
            0.50412005, 0.5029095, 0.5029095, 0.50412005, 0.5029095],
            [0.503063, 0.5029091, 0.50292027, 0.5046658, 0.5029091, 0.50296307,
            0.5046658, 0.5029091], [0.5031187, 0.5029085, 0.5029624, 0.5050988,
            0.5029085, 0.503188, 0.5050988, 0.5029085], [0.5031136, 0.5029079,
            0.5030197, 0.5051403, 0.5029079, 0.503535, 0.5051403, 0.5029079],
            [0.50312454, 0.5029182, 0.5030609, 0.5052982, 0.50317276,
            0.50384134, 0.5052982, 0.5029182], [0.5031242, 0.50295997,
            0.5031162, 0.5051824, 0.50433517, 0.50426733, 0.5051824,
            0.50295997], [0.50312394, 0.50301677, 0.50311077, 0.50532633,
            0.5059479, 0.5042629, 0.50532633, 0.50301677], [0.5031892,
            0.5030576, 0.50312126, 0.5052927, 0.5074678, 0.5043408, 0.5052927,
            0.5030576], [0.5035604, 0.5031125, 0.5031204, 0.5052633, 0.5088238,
            0.5042153, 0.5052633, 0.5031125], [0.50401616, 0.5031067,
            0.5031199, 0.50524765, 0.5089145, 0.5041977, 0.50524765,
            0.5031067], [0.5044251, 0.50311667, 0.5031847, 0.5051762,
            0.5088994, 0.50415343, 0.5051762, 0.50311667], [0.50473964,
            0.50311553, 0.5035555, 0.50518596, 0.5087638, 0.50415975,
            0.50518596, 0.50311553], [0.5048319, 0.50311446, 0.50401086,
            0.5051517, 0.50847423, 0.5044718, 0.5051517, 0.50311446],
            [0.5046709, 0.50317895, 0.5044194, 0.50498724, 0.50854605,
            0.50474507, 0.50498724, 0.50317895], [0.50467426, 0.50354934,
            0.50473344, 0.5050518, 0.50880843, 0.5054259, 0.5050518,
            0.50354934], [0.50476027, 0.5040043, 0.5048253, 0.5046939,
            0.50858915, 0.5059545, 0.5046939, 0.5040043], [0.50474745,
            0.5044124, 0.5046639, 0.5029635, 0.5092954, 0.5063323, 0.5029635,
            0.5044124], [0.5048283, 0.50472605, 0.5046669, 0.50320125,
            0.5096508, 0.5066513, 0.50320125, 0.50472605], [0.5047999,
            0.5048174, 0.50475246, 0.5041087, 0.5100274, 0.5067533, 0.5041087,
            0.5048174], [0.5049437, 0.50465566, 0.5047393, 0.5054271,
            0.50994766, 0.5067882, 0.5054271, 0.50465566], [0.5051117,
            0.5046582, 0.50481963, 0.5067042, 0.5096205, 0.50719655, 0.5067042,
            0.5046582], [0.5050333, 0.5047434, 0.5047908, 0.5078993,
            0.50978047, 0.50783706, 0.5078993, 0.5047434], [0.5049439,
            0.50472975, 0.5049343, 0.5079188, 0.50935316, 0.5089551, 0.5079188,
            0.50472975], [0.50512546, 0.5048097, 0.50510186, 0.50762063,
            0.50913864, 0.5098545, 0.50762063, 0.5048097], [0.5050914,
            0.50482446, 0.505023, 0.50761807, 0.509048, 0.510658, 0.50761807,
            0.50482446], [0.50510645, 0.50515044, 0.50493324, 0.50758535,
            0.50970596, 0.51104045, 0.50758535, 0.50515044], [0.50528544,
            0.5055692, 0.5051143, 0.5072687, 0.5099039, 0.5111541, 0.5072687,
            0.5055692], [0.50554276, 0.50571257, 0.50508, 0.50734526, 0.510356,
            0.5107522, 0.50734526, 0.50571257], [0.5060394, 0.5057805,
            0.5050945, 0.50760055, 0.5107753, 0.51013494, 0.50760055,
            0.5057805], [0.50667727, 0.5059606, 0.5052731, 0.5076028,
            0.5107968, 0.51064515, 0.5076028, 0.5059606]],
        "final_obs": [[0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0,
            0.01171875, 0.02734375, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.99118304, 0.99107146, 0.99329907, 1.0, 0.0, 1.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.033764876, 0.020639123,
            0.010716875, 0.0, 0.0, 0.0, 0.0, 0.0, 0.344182, 0.5, 0.44492534,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.125, 0.125, 0.0625, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.25, 0.16666667, 0.20833334, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0,
            1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.04302275, 0.0625, 0.027807834,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.6592262, 0.6592262, 0.66071427, 0.0,
            0.0, 0.0, 0.0, 0.0], [0.034899496, 0.99939084, 1.3155972,
            0.9873093, 1.0, 0.01953125, 0.01953125, 1.0, 0.0055555557, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.99347097, 0.9933036, 0.99515736, 1.0,
            0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.057704367,
            0.033764876, 0.020639123, 0.020267708, 0.010716875, 0.0, 0.0, 0.0,
            0.30511844, 0.344182, 0.5, 0.5, 0.44492534, 0.0, 0.0, 0.0, 0.125,
            0.125, 0.125, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.3125, 0.25,
            0.16666667, 0.22916667, 0.20833334, 0.0, 0.0, 0.0, 0.5, 1.0, 1.0,
            0.0, 0.5, 0.0, 0.0, 0.0, 0.038139805, 0.04302275, 0.0625, 0.03125,
            0.027807834, 0.0, 0.0, 0.0, 0.6622024, 0.66071427, 0.66071427,
            0.9970238, 0.6622024, 0.0, 0.0, 0.0], [0.034899496, 0.99939084,
            1.3155972, 0.9873093, 1.0, 0.015625, 0.0234375, 1.0, 0.0055555557,
            1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99179685, 0.99107146, 0.9934729,
            1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.033764876,
            0.020639123, 0.020267708, 0.010716875, 0.0, 0.0, 0.0, 0.0,
            0.344182, 0.5, 0.5, 0.44492534, 0.0, 0.0, 0.0, 0.0, 0.125, 0.125,
            0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.25, 0.16666667, 0.22916667,
            0.20833334, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.04302275, 0.0625, 0.03125, 0.027807834, 0.0, 0.0, 0.0, 0.0,
            0.6592262, 0.6592262, 0.9970238, 0.66071427, 0.0, 0.0, 0.0, 0.0],
            [0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0, 0.015625,
            0.03125, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.99229914, 0.9899554, 0.99520224, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.07594989, 0.055894777, 0.008408543,
            0.005076896, 0.0, 0.0, 0.0, 0.0, 0.34126368, 0.39685744,
            0.27704287, 0.1448695, 0.0, 0.0, 0.0, 0.0, 0.25, 0.125, 0.0625,
            0.0625, 0.0, 0.0, 0.0, 0.0, 0.39583334, 0.083333336, 0.16666667,
            0.125, 0.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.08531592, 0.04960718, 0.01731518, 0.009054344, 0.0, 0.0, 0.0,
            0.0, 0.6592262, 0.66071427, 0.99553573, 0.99553573, 0.0, 0.0, 0.0,
            0.0], [0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0,
            0.00390625, 0.03125, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.99084824, 0.9866072, 0.995553, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.084639095, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.4375, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.99404764, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0, 0.015625,
            0.0390625, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.9852679, 0.97544646, 0.9912549, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.064638324, 0.025492428, 0.012137205,
            0.006608963, 0.0, 0.0, 0.0, 0.0, 0.5, 0.38274416, 0.5, 0.36078066,
            0.0, 0.0, 0.0, 0.0, 0.0625, 0.25, 0.125, 0.125, 0.0, 0.0, 0.0, 0.0,
            0.4166667, 0.10416667, 0.3125, 0.20833334, 0.0, 0.0, 0.0, 0.0, 0.0,
            1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.09568604, 0.0625,
            0.045097582, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.64880955,
            0.64880955, 0.64880955, 0.0, 0.0, 0.0, 0.0], [0.034899496,
            0.99939084, 1.3155972, 0.9873093, 1.0, 0.015625, 0.03125, 1.0,
            0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99229914, 0.9899554,
            0.99520224, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.07594989, 0.055894777, 0.008408543, 0.005076896, 0.0, 0.0, 0.0,
            0.0, 0.34126368, 0.39685744, 0.27704287, 0.1448695, 0.0, 0.0, 0.0,
            0.0, 0.25, 0.125, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.39583334,
            0.083333336, 0.16666667, 0.125, 0.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.08531592, 0.04960718, 0.01731518,
            0.009054344, 0.0, 0.0, 0.0, 0.0, 0.6592262, 0.66071427, 0.99553573,
            0.99553573, 0.0, 0.0, 0.0, 0.0], [0.034899496, 0.99939084,
            1.3155972, 0.9873093, 1.0, 0.01953125, 0.01953125, 1.0,
            0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99347097, 0.9933036,
            0.99515736, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.057704367, 0.033764876, 0.020639123, 0.020267708, 0.010716875,
            0.0, 0.0, 0.0, 0.30511844, 0.344182, 0.5, 0.5, 0.44492534, 0.0,
            0.0, 0.0, 0.125, 0.125, 0.125, 0.0625, 0.0625, 0.0, 0.0, 0.0,
            0.3125, 0.25, 0.16666667, 0.22916667, 0.20833334, 0.0, 0.0, 0.0,
            0.5, 1.0, 1.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.038139805, 0.04302275,
            0.0625, 0.03125, 0.027807834, 0.0, 0.0, 0.0, 0.6622024, 0.66071427,
            0.66071427, 0.9970238, 0.6622024, 0.0, 0.0, 0.0]],
        "digest_jstate": [851, 838, 842, 871, 858, 897, 871, 838],
        "digest_placement": [-8388821, -8389846, -8389208, -8388547, -8388716,
            -8377680, -8388547, -8389846],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "n_completed": [0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0],
        "past_queued": 170,
    },
    "rl_tx_gaia_thermal_stress": {
        "reward": [[-3.1619353, -3.1693664, -3.1693664, -3.1615815, -3.168366,
            -3.171367, -3.1615815, -3.1693664], [-3.1687012, -3.1758657,
            -3.1758657, -3.170994, -3.1683657, -3.1758657, -3.170994,
            -3.1758657], [-3.16906, -3.1758647, -3.1758647, -3.1758928,
            -3.1683648, -3.1823647, -3.1758928, -3.1758647], [-3.1693208,
            -3.1758642, -3.1684322, -3.1792881, -3.1898634, -3.1761992,
            -3.1792881, -3.1758642], [-3.1696677, -3.1758618, -3.1686962,
            -3.181984, -3.192862, -3.1755998, -3.181984, -3.1758618],
            [-3.1696386, -3.175859, -3.1690543, -3.187243, -3.1983595,
            -3.1797593, -3.187243, -3.175859], [-3.169709, -3.1684253,
            -3.1693134, -3.1907268, -3.192509, -3.1816673, -3.1907268,
            -3.1684253], [-3.1697097, -3.1686883, -3.1696599, -3.19001,
            -3.1922407, -3.184821, -3.19001, -3.1686883]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False]],
        "facility_w": [[242770.47, 242754.55, 242754.55, 242919.34, 242754.55,
            242754.55, 242919.34, 242754.55], [242785.19, 242754.56, 242754.56,
            243090.16, 242754.56, 242754.56, 243090.16, 242754.56], [242815.56,
            242754.56, 242754.56, 243490.5, 242754.56, 242754.56, 243490.5,
            242754.56], [242834.3, 242754.58, 242770.5, 243645.14, 242754.58,
            242831.89, 243645.14, 242754.58], [242862.11, 242754.6, 242785.22,
            243784.44, 242754.6, 242928.1, 243784.44, 242754.6], [242848.28,
            242754.61, 242815.62, 243839.08, 242754.61, 243114.34, 243839.08,
            242754.61], [242859.94, 242770.56, 242834.36, 243872.72, 243135.3,
            243244.75, 243872.72, 242770.56], [242858.25, 242785.3, 242862.19,
            243826.47, 243594.36, 243408.75, 243826.47, 242785.3]],
        "queue_len": [[1.0, 2.0, 2.0, 0.0, 1.0, 2.0, 0.0, 2.0], [1.0, 2.0, 2.0,
            1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0, 1.0, 1.0, 3.0, 1.0, 2.0],
            [1.0, 2.0, 1.0, 1.0, 4.0, 2.0, 1.0, 2.0], [1.0, 2.0, 1.0, 1.0, 5.0,
            2.0, 1.0, 2.0], [1.0, 2.0, 1.0, 2.0, 5.0, 2.0, 2.0, 2.0], [1.0,
            1.0, 1.0, 2.0, 4.0, 2.0, 2.0, 1.0], [1.0, 1.0, 1.0, 2.0, 3.0, 3.0,
            2.0, 1.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0]],
        "energy_kwh": [[1.0114993, 1.0114772, 1.0114772, 1.0117061, 1.0114772,
            1.0114772, 1.0117061, 1.0114772], [1.0115845, 1.0114772, 1.0114772,
            1.0126384, 1.0114772, 1.0114772, 1.0126384, 1.0114772], [1.0116999,
            1.0114774, 1.0114774, 1.0138863, 1.0114774, 1.0114774, 1.0138863,
            1.0114774], [1.0117836, 1.0114774, 1.0114995, 1.0149734, 1.0114774,
            1.0115849, 1.0149734, 1.0114774], [1.0118954, 1.0114774, 1.0115846,
            1.0158365, 1.0114774, 1.0120336, 1.0158365, 1.0114774], [1.0118871,
            1.0114777, 1.0117002, 1.0159204, 1.0114777, 1.0127256, 1.0159204,
            1.0114777], [1.0119103, 1.0114999, 1.0117838, 1.0162362, 1.0120065,
            1.0133371, 1.0162362, 1.0114999], [1.0119116, 1.0115849, 1.0118959,
            1.0160079, 1.0143217, 1.0141873, 1.0160079, 1.0115849]],
        "carbon_kg": [[0.5057497, 0.5057387, 0.5057387, 0.5058531, 0.5057387,
            0.5057387, 0.5058531, 0.5057387], [0.50579214, 0.50573856,
            0.50573856, 0.5063191, 0.50573856, 0.50573856, 0.5063191,
            0.50573856], [0.5058494, 0.5057382, 0.5057382, 0.5069428,
            0.5057382, 0.5057382, 0.5069428, 0.5057382], [0.5058909, 0.5057378,
            0.50574887, 0.5074858, 0.5057378, 0.5057915, 0.5074858, 0.5057378],
            [0.50594634, 0.50573736, 0.5057909, 0.50791675, 0.50573736,
            0.50601524, 0.50791675, 0.50573736], [0.50594133, 0.50573653,
            0.5058478, 0.5079579, 0.50573653, 0.5063606, 0.5079579,
            0.50573653], [0.5059521, 0.50574684, 0.5058889, 0.50811505,
            0.5060001, 0.5066654, 0.50811505, 0.50574684], [0.5059518,
            0.5057884, 0.50594383, 0.50799984, 0.5071568, 0.50708956,
            0.50799984, 0.5057884]],
        "final_obs": [[0.008726535, 0.9999619, 1.3157775, 0.99682677, 1.0,
            0.00390625, 0.00390625, 1.0, 0.0013888889, 0.25, 0.7082702,
            0.70547366, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0,
            0.99996334, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.029477669, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.6666667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.008726535,
            0.9999619, 1.3157775, 0.99682677, 1.0, 0.00390625, 0.00390625, 1.0,
            0.0013888889, 0.25, 0.7082702, 0.7054319, 1.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.99905133, 1.0, 0.99996334, 1.0, 0.0, 1.0, 1.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.029477669, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0781015, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6666667, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.008726535, 0.9999619, 1.3157775, 0.99682677, 1.0,
            0.00390625, 0.00390625, 1.0, 0.0013888889, 0.25, 0.7082702,
            0.70545256, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0,
            0.99996334, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.029477669, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.6666667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.008726535,
            0.9999619, 1.3157775, 0.99682677, 1.0, 0.0078125, 0.00390625, 1.0,
            0.0013888889, 0.25, 0.7141907, 0.70591354, 1.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.9991071, 0.99553573, 0.99951744, 1.0, 0.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.028462622, 0.010968361, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.42749566, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.22916667,
            0.0625, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.026718479, 0.03125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.008726535, 0.9999619,
            1.3157775, 0.99682677, 1.0, 0.01171875, 0.0078125, 1.0,
            0.0013888889, 0.25, 0.7082702, 0.7055131, 1.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.9955915, 0.99107146, 0.99707717, 1.0, 0.0, 1.0, 1.0,
            1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.02058837, 0.02031242,
            0.013433134, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.25129122, 0.5, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0625, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.3541667, 0.083333336, 0.39583334, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.015705701,
            0.03125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.9985119, 1.0, 0.66071427, 0.0,
            0.0, 0.0, 0.0, 0.0], [0.008726535, 0.9999619, 1.3157775,
            0.99682677, 1.0, 0.01171875, 0.0078125, 1.0, 0.0013888889, 0.25,
            0.7082702, 0.7055743, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.99810266, 0.9977679, 0.99947387, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.030598547, 0.015336463, 0.00017203226,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.12621523, 0.20077494, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0625, 0.125, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.4375, 0.125, 0.375, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.03125, 0.015776904, 0.012548434, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.9985119, 0.6651786, 0.6651786, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.008726535, 0.9999619, 1.3157775, 0.99682677, 1.0,
            0.0078125, 0.00390625, 1.0, 0.0013888889, 0.25, 0.7141907,
            0.70591354, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.9991071,
            0.99553573, 0.99951744, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.028462622, 0.010968361, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.42749566, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.0625,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.22916667, 0.0625, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.026718479,
            0.03125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.008726535, 0.9999619, 1.3157775, 0.99682677,
            1.0, 0.00390625, 0.00390625, 1.0, 0.0013888889, 0.25, 0.7082702,
            0.7054319, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0,
            0.99996334, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.029477669, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.6666667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
        "digest_jstate": [821, 821, 821, 821, 824, 824, 821, 821],
        "digest_placement": [-8390655, -8390655, -8390655, -8390626, -8390593,
            -8390622, -8390626, -8390655],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "n_completed": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        "past_queued": 49,
    },
    "ppo": {
        "actions0": [[3, 6, 8, 6, 2, 6, 7, 1], [5, 2, 2, 4, 2, 6, 2, 8], [7, 4,
            4, 4, 5, 7, 5, 7], [2, 2, 8, 2, 3, 3, 6, 3], [3, 4, 2, 0, 1, 8, 0,
            2], [2, 1, 1, 1, 2, 3, 8, 7], [1, 2, 0, 6, 2, 3, 6, 0], [1, 6, 1,
            3, 5, 0, 1, 4], [2, 0, 8, 8, 4, 8, 7, 6], [8, 1, 8, 8, 4, 6, 2, 3],
            [0, 1, 7, 8, 6, 3, 3, 5], [8, 1, 2, 8, 0, 1, 1, 5], [2, 3, 1, 3, 7,
            4, 8, 3], [5, 6, 0, 2, 0, 7, 1, 6], [7, 4, 5, 2, 3, 7, 5, 4], [4,
            4, 1, 0, 4, 5, 1, 7], [4, 8, 8, 2, 7, 8, 8, 7], [7, 4, 0, 7, 6, 7,
            0, 1], [5, 5, 2, 1, 8, 0, 4, 0], [5, 7, 6, 1, 6, 7, 3, 5], [1, 2,
            1, 2, 4, 2, 6, 8], [0, 4, 0, 7, 6, 4, 4, 2], [4, 0, 0, 3, 5, 1, 1,
            5], [0, 8, 7, 7, 2, 3, 0, 5], [5, 8, 7, 8, 6, 2, 1, 5], [2, 0, 0,
            0, 2, 2, 6, 3], [4, 7, 6, 0, 7, 8, 0, 7], [0, 4, 6, 6, 1, 7, 5, 7],
            [1, 1, 3, 1, 3, 2, 2, 7], [5, 0, 7, 0, 2, 0, 5, 5], [7, 7, 6, 0, 8,
            5, 4, 5], [6, 3, 7, 8, 0, 8, 1, 5]],
        "mean_reward0": -3.1819003,
        "mean_value0": -0.12771964,
        "history": [{"approx_kl": 0.0031227982, "entropy": 2.187633,
            "mean_episode_len": 32.0, "mean_episode_return": -101.82082,
            "mean_reward": -3.1819003, "mean_value": -0.12771964, "pg_loss":
            -0.023924114, "v_loss": 543.9121}, {"approx_kl": 0.0047107073,
            "entropy": 2.1713538, "mean_episode_len": 32.0,
            "mean_episode_return": -101.63076, "mean_reward": -3.175961,
            "mean_value": -2.1037676, "pg_loss": -0.0011547555, "v_loss":
            515.5}],
    },
}


# ``PINNED_RL_MACRO``: the JAX package's ``SchedEnv(macro=True)`` (its
# default) on ``rl_tx_gaia`` and one ``ppo_train`` iteration with it, on
# the CPU (jax 0.9.0), made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_macro_pins.py rl
# (22 s on 8 cores): the scripted rollout, iteration 0's actions and
# rollout stats, and the first iteration's stats. The values come out
# equal to ``PINNED_RL``'s (the JAX package's macro idle advance is exact
# on these cases).
PINNED_RL_MACRO = {
    "rl_tx_gaia": {
        "reward": [[-3.1442566, -3.151687, -3.151687, -3.1439064, -3.150687,
            -3.153687, -3.1439064, -3.151687], [-3.1510234, -3.1581867,
            -3.1581867, -3.1533337, -3.150687, -3.1581867, -3.1533337,
            -3.1581867], [-3.1513844, -3.1581864, -3.1581864, -3.158251,
            -3.1506855, -3.164686, -3.158251, -3.1581864], [-3.1516461,
            -3.1581843, -3.1507533, -3.1616635, -3.172184, -3.1585217,
            -3.1616635, -3.1581843], [-3.1519957, -3.158183, -3.1510181,
            -3.1643724, -3.1751823, -3.1579285, -3.1643724, -3.158183],
            [-3.151966, -3.15818, -3.1513789, -3.1696324, -3.1806793,
            -3.1620994, -3.1696324, -3.15818], [-3.1520357, -3.1507463,
            -3.151639, -3.1731215, -3.1748374, -3.1640158, -3.1731215,
            -3.1507463], [-3.1520367, -3.1510105, -3.1519866, -3.172401,
            -3.1746058, -3.1671817, -3.172401, -3.1510105], [-3.1520383,
            -3.1513689, -3.1519563, -3.1733036, -3.1771884, -3.1741574,
            -3.1733036, -3.1513689], [-3.1449497, -3.151627, -3.152025,
            -3.1655972, -3.189691, -3.1746476, -3.1655972, -3.151627],
            [-3.1472738, -3.1519744, -3.1520236, -3.1654172, -3.20267,
            -3.1738667, -3.1654172, -3.1519744], [-3.1501267, -3.1519418,
            -3.1520243, -3.165823, -3.2057414, -3.174261, -3.165823,
            -3.1519418], [-3.1526875, -3.152009, -3.1449347, -3.1728818,
            -3.2106519, -3.1759887, -3.1728818, -3.152009], [-3.1546576,
            -3.1520069, -3.1472569, -3.1819475, -3.2103093, -3.1795337,
            -3.1819475, -3.1520069], [-3.1552398, -3.1520061, -3.1501083,
            -3.1872387, -3.2155044, -3.1774893, -3.1872387, -3.1520061],
            [-3.1542397, -3.1449146, -3.1526673, -3.1982167, -3.2084594,
            -3.177203, -3.1982167, -3.1449146], [-3.1542673, -3.147236,
            -3.1546366, -3.2016263, -3.202606, -3.1854641, -3.2016263,
            -3.147236], [-3.1623106, -3.1575856, -3.1627173, -2.1993966,
            -3.1937423, -3.192275, -2.1993966, -3.1575856], [-3.1652377,
            -3.1706433, -3.1722155, -3.1895876, -3.1981633, -3.1946435,
            -3.1895876, -3.1706433], [-3.1627498, -3.1771114, -3.1767416,
            -3.1905813, -3.200392, -3.196644, -3.1905813, -3.1771114],
            [-3.1625803, -3.1776905, -3.177284, -3.1957605, -3.2027535,
            -3.19729, -3.1957605, -3.1776905], [-3.1634877, -3.176687,
            -3.1697097, -3.1965091, -3.2022634, -3.1900158, -3.1965091,
            -3.176687], [-3.1645458, -3.176712, -3.16272, -3.1969995,
            -3.2047267, -3.1925771, -3.1969995, -3.176712], [-3.165065,
            -3.178253, -3.1635492, -3.2044778, -3.2087352, -3.196089,
            -3.2044778, -3.178253], [-3.171016, -3.1771772, -3.1709552,
            -3.2046094, -3.1985748, -3.2035863, -3.2046094, -3.1771772],
            [-3.1771598, -3.1751864, -3.177012, -3.2027555, -3.189743,
            -3.2102177, -3.2027555, -3.1751864], [-3.1794572, -3.1702888,
            -3.1790297, -3.202749, -3.189187, -3.2217498, -3.202749,
            -3.1702888], [-3.1860619, -3.186337, -3.1924791, -3.1950555,
            -3.19331, -3.2241511, -3.1950555, -3.186337], [-3.1806915,
            -3.1899652, -3.1946216, -3.185587, -3.1945577, -3.2248719,
            -3.185587, -3.1899652], [-3.1793108, -3.195372, -3.198918,
            -3.186577, -3.197395, -2.2293715, -3.186577, -3.195372],
            [-3.1854262, -3.198808, -3.194521, -3.1971843, -3.2000272,
            -3.2230248, -3.1971843, -3.198808], [-3.189425, -3.199946,
            -3.1881492, -3.2027102, -3.2001736, -3.2217264, -3.2027102,
            -3.199946]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [True, True, True, True,
            True, True, True, True]],
        "facility_w": [[241412.77, 241396.77, 241396.77, 241562.39, 241396.77,
            241396.77, 241562.39, 241396.77], [241427.56, 241396.78, 241396.78,
            241734.06, 241396.78, 241396.78, 241734.06, 241396.78], [241458.1,
            241396.78, 241396.78, 242136.38, 241396.78, 241396.78, 242136.38,
            241396.78], [241476.92, 241396.8, 241412.8, 242291.8, 241396.8,
            241474.5, 242291.8, 241396.8], [241504.86, 241396.81, 241427.6,
            242431.78, 241396.81, 241571.19, 242431.78, 241396.81], [241490.97,
            241396.83, 241458.14, 242486.7, 241396.83, 241758.34, 242486.7,
            241396.83], [241502.67, 241412.84, 241476.97, 242520.5, 241779.4,
            241889.36, 242520.5, 241412.84], [241500.97, 241427.66, 241504.92,
            242474.02, 242240.75, 242054.1, 242474.02, 241427.66], [241496.39,
            241458.22, 241491.05, 242557.2, 243183.48, 242035.34, 242557.2,
            241458.22], [241613.88, 241477.06, 241502.75, 242539.62, 243787.17,
            242058.03, 242539.62, 241477.06], [241752.05, 241505.03, 241501.06,
            242535.94, 244475.06, 242005.9, 242535.94, 241505.03], [242004.12,
            241491.16, 241496.5, 242517.7, 244168.81, 242004.97, 242517.7,
            241491.16], [242198.48, 241502.88, 241614.0, 242439.53, 244108.22,
            241998.2, 242439.53, 241502.88], [242273.3, 241501.2, 241752.17,
            242525.08, 244264.47, 242079.69, 242525.08, 241501.2], [242359.84,
            241496.64, 242004.25, 242519.16, 244067.8, 242190.38, 242519.16,
            241496.64], [242194.16, 241614.16, 242198.62, 242342.84, 244139.55,
            242470.1, 242342.84, 241614.16], [242283.5, 241752.34, 242273.47,
            242430.56, 244215.08, 242679.52, 242430.56, 241752.34], [242193.38,
            242004.44, 242360.02, 241438.03, 244079.31, 242982.12, 241438.03,
            242004.44], [242339.06, 242198.81, 242194.34, 241433.19, 244579.64,
            243088.6, 241433.19, 242198.81], [242303.34, 242273.66, 242283.69,
            241770.17, 244659.64, 243202.56, 241770.17, 242273.66], [242320.47,
            242360.22, 242193.56, 242096.47, 244849.34, 243293.19, 242096.47,
            242360.22], [242395.03, 242194.56, 242339.28, 242941.78, 244744.23,
            243365.31, 242941.78, 242194.56], [242511.23, 242283.9, 242303.56,
            243385.38, 244742.48, 243565.72, 243385.38, 242283.9], [242365.47,
            242193.81, 242320.7, 243814.28, 244698.86, 244032.72, 243814.28,
            242193.81], [242394.75, 242339.53, 242395.27, 243822.53, 244583.69,
            244455.73, 243822.53, 242339.53], [242515.48, 242303.81, 242511.5,
            243615.94, 244361.31, 244831.94, 243615.94, 242303.81], [242444.67,
            242384.28, 242365.72, 243707.89, 244475.1, 245231.2, 243707.89,
            242384.28], [242570.69, 242527.27, 242395.03, 243615.94, 244786.6,
            245346.73, 243615.94, 242527.27], [242599.25, 242799.25, 242515.77,
            243493.83, 245039.94, 245391.12, 243493.83, 242799.25], [242740.31,
            242726.84, 242444.97, 243504.66, 244922.66, 244762.34, 243504.66,
            242726.84], [243034.66, 242807.72, 242570.98, 243759.61, 245246.17,
            245033.92, 243759.61, 242807.72], [243154.27, 242928.06, 242599.58,
            243731.61, 245178.06, 245395.44, 243731.61, 242928.06]],
        "queue_len": [[1.0, 2.0, 2.0, 0.0, 1.0, 2.0, 0.0, 2.0], [1.0, 2.0, 2.0,
            1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0, 1.0, 1.0, 3.0, 1.0, 2.0],
            [1.0, 2.0, 1.0, 1.0, 4.0, 2.0, 1.0, 2.0], [1.0, 2.0, 1.0, 1.0, 5.0,
            2.0, 1.0, 2.0], [1.0, 2.0, 1.0, 2.0, 5.0, 2.0, 2.0, 2.0], [1.0,
            1.0, 1.0, 2.0, 4.0, 2.0, 2.0, 1.0], [1.0, 1.0, 1.0, 2.0, 3.0, 3.0,
            2.0, 1.0], [1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 2.0, 1.0], [0.0, 1.0,
            1.0, 1.0, 3.0, 3.0, 1.0, 1.0], [0.0, 1.0, 1.0, 1.0, 3.0, 3.0, 1.0,
            1.0], [0.0, 1.0, 1.0, 2.0, 4.0, 4.0, 2.0, 1.0], [0.0, 1.0, 0.0,
            3.0, 4.0, 4.0, 3.0, 1.0], [0.0, 1.0, 0.0, 4.0, 5.0, 4.0, 4.0, 1.0],
            [0.0, 1.0, 0.0, 4.0, 5.0, 4.0, 4.0, 1.0], [0.0, 0.0, 0.0, 6.0, 4.0,
            3.0, 6.0, 0.0], [0.0, 0.0, 0.0, 6.0, 3.0, 4.0, 6.0, 0.0], [1.0,
            1.0, 1.0, 6.0, 2.0, 4.0, 6.0, 1.0], [2.0, 3.0, 3.0, 7.0, 2.0, 4.0,
            7.0, 3.0], [1.0, 3.0, 3.0, 7.0, 2.0, 4.0, 7.0, 3.0], [1.0, 3.0,
            3.0, 6.0, 2.0, 4.0, 6.0, 3.0], [1.0, 3.0, 2.0, 5.0, 2.0, 3.0, 5.0,
            3.0], [1.0, 3.0, 1.0, 4.0, 3.0, 3.0, 4.0, 3.0], [2.0, 4.0, 2.0,
            4.0, 3.0, 3.0, 4.0, 4.0], [2.0, 3.0, 2.0, 4.0, 2.0, 3.0, 4.0, 3.0],
            [3.0, 3.0, 3.0, 4.0, 1.0, 4.0, 4.0, 3.0], [3.0, 2.0, 3.0, 4.0, 1.0,
            4.0, 4.0, 2.0], [4.0, 4.0, 5.0, 3.0, 1.0, 4.0, 3.0, 4.0], [3.0,
            4.0, 5.0, 2.0, 1.0, 4.0, 2.0, 4.0], [3.0, 5.0, 6.0, 3.0, 1.0, 5.0,
            3.0, 5.0], [3.0, 5.0, 5.0, 4.0, 1.0, 5.0, 4.0, 5.0], [3.0, 5.0,
            4.0, 4.0, 1.0, 4.0, 4.0, 5.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 1.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
        "energy_kwh": [[1.0058422, 1.00582, 1.00582, 1.0060499, 1.00582,
            1.00582, 1.0060499, 1.00582], [1.0059277, 1.00582, 1.00582,
            1.0069867, 1.00582, 1.00582, 1.0069867, 1.00582], [1.0060436,
            1.0058202, 1.0058202, 1.0082408, 1.0058202, 1.0058202, 1.0082408,
            1.0058202], [1.0061277, 1.0058202, 1.0058422, 1.0093335, 1.0058202,
            1.005928, 1.0093335, 1.0058202], [1.0062402, 1.0058202, 1.0059277,
            1.0102009, 1.0058202, 1.0063788, 1.0102009, 1.0058202], [1.0062319,
            1.0058202, 1.0060438, 1.010285, 1.0058202, 1.0070745, 1.010285,
            1.0058202], [1.0062551, 1.0058423, 1.0061278, 1.0106024, 1.0063516,
            1.0076886, 1.0106024, 1.0058423], [1.0062563, 1.0059279, 1.0062406,
            1.010373, 1.0086786, 1.0085429, 1.010373, 1.0059279], [1.0062584,
            1.006044, 1.006232, 1.0106632, 1.0119061, 1.0085361, 1.0106632,
            1.006044], [1.0063914, 1.0061283, 1.0062554, 1.0105987, 1.0149488,
            1.0086948, 1.0105987, 1.0061283], [1.0071367, 1.006241, 1.0062569,
            1.0105426, 1.0176636, 1.0084465, 1.0105426, 1.006241], [1.0080515,
            1.0062323, 1.0062586, 1.0105143, 1.0178483, 1.0084145, 1.0105143,
            1.0062323], [1.0088729, 1.006256, 1.006392, 1.010375, 1.0178217,
            1.0083293, 1.010375, 1.006256], [1.0095055, 1.0062573, 1.0071373,
            1.0103983, 1.0175542, 1.0083458, 1.0103983, 1.0062573], [1.0096942,
            1.0062593, 1.0080522, 1.0103337, 1.0169789, 1.0089741, 1.0103337,
            1.0062593], [1.0093766, 1.0063927, 1.0088733, 1.0100092, 1.017127,
            1.009525, 1.0100092, 1.0063927], [1.009388, 1.007138, 1.0095062,
            1.0101429, 1.0176567, 1.0108911, 1.0101429, 1.007138], [1.0095649,
            1.0080527, 1.0096948, 1.0094321, 1.017223, 1.0119534, 1.0094321,
            1.0080527], [1.0095445, 1.008874, 1.0093771, 1.0059762, 1.0186409,
            1.0127143, 1.0059762, 1.008874], [1.0097114, 1.0095072, 1.0093888,
            1.0064574, 1.0193572, 1.0133576, 1.0064574, 1.0095072], [1.0096604,
            1.0096956, 1.0095657, 1.008278, 1.0201163, 1.0135674, 1.008278,
            1.0096956], [1.0099543, 1.0093781, 1.0095453, 1.0109214, 1.0199629,
            1.0136435, 1.0109214, 1.0093781], [1.0102966, 1.0093896, 1.0097122,
            1.0134819, 1.0193149, 1.0144666, 1.0134819, 1.0093896], [1.0101464,
            1.0095667, 1.0096612, 1.0158788, 1.0196415, 1.0157543, 1.0158788,
            1.0095667], [1.0099746, 1.0095463, 1.0099553, 1.0159247, 1.0187941,
            1.0179976, 1.0159247, 1.0095463], [1.0103449, 1.0097134, 1.0102975,
            1.0153358, 1.0183719, 1.0198036, 1.0153358, 1.0097134], [1.0102844,
            1.0097505, 1.0101476, 1.0153381, 1.0181984, 1.0214186, 1.0153381,
            1.0097505], [1.0103222, 1.0104103, 1.0099758, 1.0152806, 1.0195222,
            1.0221916, 1.0152806, 1.0104103], [1.0106883, 1.0112559, 1.0103459,
            1.0146551, 1.0199263, 1.022427, 1.0146551, 1.0112559], [1.0112114,
            1.0115511, 1.0102855, 1.0148169, 1.0208391, 1.0216317, 1.0148169,
            1.0115511], [1.0122135, 1.0116956, 1.0103235, 1.0153362, 1.0216866,
            1.0204058, 1.0153362, 1.0116956], [1.0134983, 1.0120648, 1.0106897,
            1.0153497, 1.0217384, 1.0214354, 1.0153497, 1.0120648]],
        "carbon_kg": [[0.5029211, 0.50290996, 0.50290996, 0.50302494,
            0.50290996, 0.50290996, 0.50302494, 0.50290996], [0.50296366,
            0.50290984, 0.50290984, 0.50349325, 0.50290984, 0.50290984,
            0.50349325, 0.50290984], [0.50302136, 0.5029095, 0.5029095,
            0.50412005, 0.5029095, 0.5029095, 0.50412005, 0.5029095],
            [0.503063, 0.5029091, 0.50292027, 0.5046658, 0.5029091, 0.50296307,
            0.5046658, 0.5029091], [0.5031187, 0.5029085, 0.5029624, 0.5050988,
            0.5029085, 0.503188, 0.5050988, 0.5029085], [0.5031136, 0.5029079,
            0.5030197, 0.5051403, 0.5029079, 0.503535, 0.5051403, 0.5029079],
            [0.50312454, 0.5029182, 0.5030609, 0.5052982, 0.50317276,
            0.50384134, 0.5052982, 0.5029182], [0.5031242, 0.50295997,
            0.5031162, 0.5051824, 0.50433517, 0.50426733, 0.5051824,
            0.50295997], [0.50312394, 0.50301677, 0.50311077, 0.50532633,
            0.5059479, 0.5042629, 0.50532633, 0.50301677], [0.5031892,
            0.5030576, 0.50312126, 0.5052927, 0.5074678, 0.5043408, 0.5052927,
            0.5030576], [0.5035604, 0.5031125, 0.5031204, 0.5052633, 0.5088238,
            0.5042153, 0.5052633, 0.5031125], [0.50401616, 0.5031067,
            0.5031199, 0.50524765, 0.5089145, 0.5041977, 0.50524765,
            0.5031067], [0.5044251, 0.50311667, 0.5031847, 0.5051762,
            0.5088994, 0.50415343, 0.5051762, 0.50311667], [0.50473964,
            0.50311553, 0.5035555, 0.50518596, 0.5087638, 0.50415975,
            0.50518596, 0.50311553], [0.5048319, 0.50311446, 0.50401086,
            0.5051517, 0.50847423, 0.5044718, 0.5051517, 0.50311446],
            [0.5046709, 0.50317895, 0.5044194, 0.50498724, 0.50854605,
            0.50474507, 0.50498724, 0.50317895], [0.50467426, 0.50354934,
            0.50473344, 0.5050518, 0.50880843, 0.5054259, 0.5050518,
            0.50354934], [0.50476027, 0.5040043, 0.5048253, 0.5046939,
            0.50858915, 0.5059545, 0.5046939, 0.5040043], [0.50474745,
            0.5044124, 0.5046639, 0.5029635, 0.5092954, 0.5063323, 0.5029635,
            0.5044124], [0.5048283, 0.50472605, 0.5046669, 0.50320125,
            0.5096508, 0.5066513, 0.50320125, 0.50472605], [0.5047999,
            0.5048174, 0.50475246, 0.5041087, 0.5100274, 0.5067533, 0.5041087,
            0.5048174], [0.5049437, 0.50465566, 0.5047393, 0.5054271,
            0.50994766, 0.5067882, 0.5054271, 0.50465566], [0.5051117,
            0.5046582, 0.50481963, 0.5067042, 0.5096205, 0.50719655, 0.5067042,
            0.5046582], [0.5050333, 0.5047434, 0.5047908, 0.5078993,
            0.50978047, 0.50783706, 0.5078993, 0.5047434], [0.5049439,
            0.50472975, 0.5049343, 0.5079188, 0.50935316, 0.5089551, 0.5079188,
            0.50472975], [0.50512546, 0.5048097, 0.50510186, 0.50762063,
            0.50913864, 0.5098545, 0.50762063, 0.5048097], [0.5050914,
            0.50482446, 0.505023, 0.50761807, 0.509048, 0.510658, 0.50761807,
            0.50482446], [0.50510645, 0.50515044, 0.50493324, 0.50758535,
            0.50970596, 0.51104045, 0.50758535, 0.50515044], [0.50528544,
            0.5055692, 0.5051143, 0.5072687, 0.5099039, 0.5111541, 0.5072687,
            0.5055692], [0.50554276, 0.50571257, 0.50508, 0.50734526, 0.510356,
            0.5107522, 0.50734526, 0.50571257], [0.5060394, 0.5057805,
            0.5050945, 0.50760055, 0.5107753, 0.51013494, 0.50760055,
            0.5057805], [0.50667727, 0.5059606, 0.5052731, 0.5076028,
            0.5107968, 0.51064515, 0.5076028, 0.5059606]],
        "final_obs": [[0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0,
            0.01171875, 0.02734375, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.99118304, 0.99107146, 0.99329907, 1.0, 0.0, 1.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.033764876, 0.020639123,
            0.010716875, 0.0, 0.0, 0.0, 0.0, 0.0, 0.344182, 0.5, 0.44492534,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.125, 0.125, 0.0625, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.25, 0.16666667, 0.20833334, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0,
            1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.04302275, 0.0625, 0.027807834,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.6592262, 0.6592262, 0.66071427, 0.0,
            0.0, 0.0, 0.0, 0.0], [0.034899496, 0.99939084, 1.3155972,
            0.9873093, 1.0, 0.01953125, 0.01953125, 1.0, 0.0055555557, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.99347097, 0.9933036, 0.99515736, 1.0,
            0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.057704367,
            0.033764876, 0.020639123, 0.020267708, 0.010716875, 0.0, 0.0, 0.0,
            0.30511844, 0.344182, 0.5, 0.5, 0.44492534, 0.0, 0.0, 0.0, 0.125,
            0.125, 0.125, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.3125, 0.25,
            0.16666667, 0.22916667, 0.20833334, 0.0, 0.0, 0.0, 0.5, 1.0, 1.0,
            0.0, 0.5, 0.0, 0.0, 0.0, 0.038139805, 0.04302275, 0.0625, 0.03125,
            0.027807834, 0.0, 0.0, 0.0, 0.6622024, 0.66071427, 0.66071427,
            0.9970238, 0.6622024, 0.0, 0.0, 0.0], [0.034899496, 0.99939084,
            1.3155972, 0.9873093, 1.0, 0.015625, 0.0234375, 1.0, 0.0055555557,
            1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99179685, 0.99107146, 0.9934729,
            1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.033764876,
            0.020639123, 0.020267708, 0.010716875, 0.0, 0.0, 0.0, 0.0,
            0.344182, 0.5, 0.5, 0.44492534, 0.0, 0.0, 0.0, 0.0, 0.125, 0.125,
            0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.25, 0.16666667, 0.22916667,
            0.20833334, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.04302275, 0.0625, 0.03125, 0.027807834, 0.0, 0.0, 0.0, 0.0,
            0.6592262, 0.6592262, 0.9970238, 0.66071427, 0.0, 0.0, 0.0, 0.0],
            [0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0, 0.015625,
            0.03125, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.99229914, 0.9899554, 0.99520224, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.07594989, 0.055894777, 0.008408543,
            0.005076896, 0.0, 0.0, 0.0, 0.0, 0.34126368, 0.39685744,
            0.27704287, 0.1448695, 0.0, 0.0, 0.0, 0.0, 0.25, 0.125, 0.0625,
            0.0625, 0.0, 0.0, 0.0, 0.0, 0.39583334, 0.083333336, 0.16666667,
            0.125, 0.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.08531592, 0.04960718, 0.01731518, 0.009054344, 0.0, 0.0, 0.0,
            0.0, 0.6592262, 0.66071427, 0.99553573, 0.99553573, 0.0, 0.0, 0.0,
            0.0], [0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0,
            0.00390625, 0.03125, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.99084824, 0.9866072, 0.995553, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.084639095, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.4375, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.99404764, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.034899496, 0.99939084, 1.3155972, 0.9873093, 1.0, 0.015625,
            0.0390625, 1.0, 0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.9852679, 0.97544646, 0.9912549, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.064638324, 0.025492428, 0.012137205,
            0.006608963, 0.0, 0.0, 0.0, 0.0, 0.5, 0.38274416, 0.5, 0.36078066,
            0.0, 0.0, 0.0, 0.0, 0.0625, 0.25, 0.125, 0.125, 0.0, 0.0, 0.0, 0.0,
            0.4166667, 0.10416667, 0.3125, 0.20833334, 0.0, 0.0, 0.0, 0.0, 0.0,
            1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.09568604, 0.0625,
            0.045097582, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.64880955,
            0.64880955, 0.64880955, 0.0, 0.0, 0.0, 0.0], [0.034899496,
            0.99939084, 1.3155972, 0.9873093, 1.0, 0.015625, 0.03125, 1.0,
            0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99229914, 0.9899554,
            0.99520224, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.07594989, 0.055894777, 0.008408543, 0.005076896, 0.0, 0.0, 0.0,
            0.0, 0.34126368, 0.39685744, 0.27704287, 0.1448695, 0.0, 0.0, 0.0,
            0.0, 0.25, 0.125, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.39583334,
            0.083333336, 0.16666667, 0.125, 0.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.08531592, 0.04960718, 0.01731518,
            0.009054344, 0.0, 0.0, 0.0, 0.0, 0.6592262, 0.66071427, 0.99553573,
            0.99553573, 0.0, 0.0, 0.0, 0.0], [0.034899496, 0.99939084,
            1.3155972, 0.9873093, 1.0, 0.01953125, 0.01953125, 1.0,
            0.0055555557, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99347097, 0.9933036,
            0.99515736, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.057704367, 0.033764876, 0.020639123, 0.020267708, 0.010716875,
            0.0, 0.0, 0.0, 0.30511844, 0.344182, 0.5, 0.5, 0.44492534, 0.0,
            0.0, 0.0, 0.125, 0.125, 0.125, 0.0625, 0.0625, 0.0, 0.0, 0.0,
            0.3125, 0.25, 0.16666667, 0.22916667, 0.20833334, 0.0, 0.0, 0.0,
            0.5, 1.0, 1.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.038139805, 0.04302275,
            0.0625, 0.03125, 0.027807834, 0.0, 0.0, 0.0, 0.6622024, 0.66071427,
            0.66071427, 0.9970238, 0.6622024, 0.0, 0.0, 0.0]],
        "digest_jstate": [851, 838, 842, 871, 858, 897, 871, 838],
        "digest_placement": [-8388821, -8389846, -8389208, -8388547, -8388716,
            -8377680, -8388547, -8389846],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "n_completed": [0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0],
        "past_queued": 170,
    },
    "ppo": {
        "actions0": [[3, 6, 8, 6, 2, 6, 7, 1], [5, 2, 2, 4, 2, 6, 2, 8], [7, 4,
            4, 4, 5, 7, 5, 7], [2, 2, 8, 2, 3, 3, 6, 3], [3, 4, 2, 0, 1, 8, 0,
            2], [2, 1, 1, 1, 2, 3, 8, 7], [1, 2, 0, 6, 2, 3, 6, 0], [1, 6, 1,
            3, 5, 0, 1, 4], [2, 0, 8, 8, 4, 8, 7, 6], [8, 1, 8, 8, 4, 6, 2, 3],
            [0, 1, 7, 8, 6, 3, 3, 5], [8, 1, 2, 8, 0, 1, 1, 5], [2, 3, 1, 3, 7,
            4, 8, 3], [5, 6, 0, 2, 0, 7, 1, 6], [7, 4, 5, 2, 3, 7, 5, 4], [4,
            4, 1, 0, 4, 5, 1, 7], [4, 8, 8, 2, 7, 8, 8, 7], [7, 4, 0, 7, 6, 7,
            0, 1], [5, 5, 2, 1, 8, 0, 4, 0], [5, 7, 6, 1, 6, 7, 3, 5], [1, 2,
            1, 2, 4, 2, 6, 8], [0, 4, 0, 7, 6, 4, 4, 2], [4, 0, 0, 3, 5, 1, 1,
            5], [0, 8, 7, 7, 2, 3, 0, 5], [5, 8, 7, 8, 6, 2, 1, 5], [2, 0, 0,
            0, 2, 2, 6, 3], [4, 7, 6, 0, 7, 8, 0, 7], [0, 4, 6, 6, 1, 7, 5, 7],
            [1, 1, 3, 1, 3, 2, 2, 7], [5, 0, 7, 0, 2, 0, 5, 5], [7, 7, 6, 0, 8,
            5, 4, 5], [6, 3, 7, 8, 0, 8, 1, 5]],
        "mean_reward0": -3.1819003,
        "mean_value0": -0.12771964,
        "history": [{"approx_kl": 0.0031227982, "entropy": 2.187633,
            "mean_episode_len": 32.0, "mean_episode_return": -101.82082,
            "mean_reward": -3.1819003, "mean_value": -0.12771964, "pg_loss":
            -0.023924114, "v_loss": 543.9121}],
    },
}


# ``PINNED_FAULTS``, ``PINNED_FLEET_FAULTS``, ``PINNED_RL_FAULTS``: what the
# JAX package gives for the fault cases on the CPU (jax 0.9.0), made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fault_pins.py
PINNED_FAULTS = {
    "replay_tx_gaia_1h_faults": {
        "completed": 97.0,
        "killed_by_failures": 42.0,
        "lost_node_seconds": 31359.83984375,
        "jobs_failed_terminal": 1.0,
        "goodput_frac": 0.8024425418423966,
        "energy_kwh": 246.7763214111328,
        "avg_pue": 1.2522939743788486,
        "carbon_kg": 123.04259490966797,
    },
    "replay_tx_gaia_1h_faults_macro": {
        "completed": 97.0,
        "killed_by_failures": 42.0,
        "lost_node_seconds": 31359.83984375,
        "jobs_failed_terminal": 1.0,
        "goodput_frac": 0.8024425418423966,
        "energy_kwh": 246.7763214111328,
        "avg_pue": 1.2522939743788486,
        "carbon_kg": 123.04259490966797,
        "macro_steps_taken": 463.0,
        "reference_macro_steps_taken": 457.0,
    },
    "replay_tx_gaia_1h_drill": {
        "completed": 88.0,
        "killed_by_failures": 27.0,
        "lost_node_seconds": 13345.0,
        "jobs_failed_terminal": 0.0,
        "goodput_frac": 0.8941479480751121,
        "energy_kwh": 260.3149719238281,
        "avg_pue": 1.258488953293615,
        "carbon_kg": 129.783203125,
        "peak_rack_outlet_c": 27.00355339050293,
        "thermal_throttle_s": 0.0,
    },
    "replay_tx_gaia_1h_drill_macro": {
        "completed": 88.0,
        "killed_by_failures": 27.0,
        "lost_node_seconds": 13345.0,
        "jobs_failed_terminal": 0.0,
        "goodput_frac": 0.8941479480751121,
        "energy_kwh": 260.3149719238281,
        "avg_pue": 1.258488953293615,
        "carbon_kg": 129.783203125,
        "peak_rack_outlet_c": 27.00355339050293,
        "thermal_throttle_s": 0.0,
        "macro_steps_taken": 315.0,
        "reference_macro_steps_taken": 311.0,
    },
}
PINNED_FLEET_FAULTS = {
    "completed": [
        16.0, 11.0, 15.0, 11.0, 16.0, 11.0, 16.0, 11.0,
    ],
    "killed_by_failures": [
        14.0, 28.0, 9.0, 36.0, 1.0, 32.0, 7.0, 27.0,
    ],
    "jobs_failed_terminal": [
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    ],
    "lost_node_seconds": [
        4588.083984375, 13189.46875, 6158.7333984375, 13227.2080078125,
        681.3125, 15331.1484375, 3097.828857421875, 12914.6298828125,
    ],
    "energy_kwh": [
        80.88875579833984, 79.26609802246094, 80.29265594482422,
        77.50067138671875, 81.92184448242188, 79.00578308105469,
        81.88793182373047, 79.97368621826172,
    ],
    "carbon_kg": [
        40.432003021240234, 39.621063232421875, 40.134002685546875,
        38.738826751708984, 40.94832229614258, 39.49091720581055,
        40.93133544921875, 39.974708557128906,
    ],
    "avg_pue": [
        1.2526018163832233, 1.2525639753580595, 1.2526216799175973,
        1.252560968858012, 1.252617041100742, 1.2525720619756366,
        1.252612425927776, 1.2525755185511183,
    ],
}
PINNED_RL_FAULTS = {
    "per_tick": {
        "reward": [[-3.1442566, -3.151687, -3.151687, -3.1489468, -3.150687,
            -3.153687, -3.150687, -3.1478794], [-3.1510234, -3.1581867,
            -3.1581867, -3.1545768, -3.150687, -3.1581867, -3.1571867,
            -3.146764], [-3.1513844, -3.1581864, -3.1576643, -3.155576,
            -3.1506855, -3.164686, -3.153617, -3.1467636], [-3.1498077,
            -3.1581843, -3.1551936, -3.1555743, -3.172184, -3.1565456,
            -3.1524727, -3.1467617], [-3.1436744, -3.153614, -3.1498616,
            -3.1555727, -3.1751823, -3.1597598, -3.152091, -3.1460643],
            [-3.1436453, -3.152469, -3.1468127, -3.1605697, -3.176872,
            -3.159322, -3.1574688, -3.1441476], [-3.143715, -3.1524658,
            -3.1441445, -3.1630676, -3.1749659, -3.159145, -3.1599655,
            -3.1441445], [-3.1437154, -3.1524625, -3.1441412, -3.163064,
            -3.1749628, -3.1596417, -3.1599622, -3.1441412], [-3.1437173,
            -3.1513166, -3.1441374, -3.1630597, -3.1703897, -3.1624498,
            -3.1599586, -3.1384263], [-3.1424556, -3.1436975, -3.1441336,
            -3.159629, -3.1722434, -3.1609225, -3.1595738, -3.1384225],
            [-3.1368148, -3.1379814, -3.1368952, -3.1568184, -3.1767385,
            -3.1563485, -3.1542385, -3.138418], [-3.1318357, -3.133049,
            -3.1316576, -3.1552258, -3.179234, -3.1537876, -3.1515033,
            -3.1349857], [-3.1312919, -3.1326962, -3.1300862, -3.1627195,
            -3.1804204, -3.1599212, -3.153907, -3.1326962], [-3.138401,
            -3.1281207, -3.13008, -3.1717138, -3.1790106, -3.1642158,
            -3.1629012, -3.1326897], [-3.1349676, -3.1212606, -3.1300733,
            -3.1741614, -3.1860042, -3.1661432, -3.1683946, -3.132683],
            [-3.1326761, -3.121254, -3.1300669, -3.1785393, -3.185997,
            -3.1769664, -3.1803873, -3.128107]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False]],
        "facility_w": [[241412.77, 241396.77, 241396.77, 241196.34, 241396.77,
            241396.77, 241396.77, 240519.52], [241427.56, 241396.78, 241396.78,
            241196.34, 241396.78, 241396.78, 241396.78, 240519.53], [241458.1,
            241396.78, 241196.36, 241196.36, 241396.78, 241396.78, 240958.16,
            240519.53], [240837.86, 241396.8, 240757.75, 241196.38, 241396.8,
            240519.55, 240958.17, 240519.55], [240865.81, 240958.19, 240757.77,
            241196.39, 241396.81, 240519.56, 240958.19, 240319.12], [240851.9,
            240958.2, 240319.16, 241196.4, 240958.2, 240319.16, 240958.2,
            240319.16], [240863.61, 240958.22, 240319.17, 241196.42, 240958.22,
            240319.17, 240958.22, 240319.17], [240861.92, 240958.25, 240319.2,
            241196.45, 240958.25, 240319.2, 240958.25, 240319.2], [240857.34,
            240519.66, 240319.22, 241196.48, 240519.66, 239880.6, 240958.28,
            239880.6], [240413.9, 240081.06, 240319.27, 240757.89, 240519.69,
            239880.64, 240519.69, 239880.64], [239949.86, 239642.47, 239442.05,
            240557.5, 240519.72, 239442.05, 240519.72, 239880.67], [239952.48,
            239442.08, 239241.66, 240557.53, 240519.77, 239241.66, 239880.72,
            239442.08], [239912.06, 239442.12, 239241.7, 240557.58, 240081.19,
            238803.11, 239880.75, 239442.12], [239880.8, 239003.55, 239241.75,
            240557.62, 240081.22, 238402.3, 239880.8, 239442.17], [239442.22,
            238564.97, 239241.8, 240119.05, 240081.28, 238402.34, 239880.84,
            239442.22], [239442.28, 238565.02, 239241.84, 239680.47, 240081.33,
            238841.0, 239880.9, 239003.66]],
        "queue_len": [[1.0, 2.0, 2.0, 1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0,
            2.0, 1.0, 2.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 1.0, 3.0, 2.0, 2.0],
            [1.0, 2.0, 2.0, 2.0, 4.0, 3.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 5.0,
            4.0, 2.0, 2.0], [1.0, 2.0, 2.0, 3.0, 5.0, 4.0, 3.0, 2.0], [1.0,
            2.0, 2.0, 3.0, 5.0, 4.0, 3.0, 2.0], [1.0, 2.0, 2.0, 3.0, 5.0, 5.0,
            3.0, 2.0], [1.0, 2.0, 2.0, 3.0, 5.0, 5.0, 3.0, 2.0], [1.0, 2.0,
            2.0, 3.0, 6.0, 5.0, 3.0, 2.0], [1.0, 2.0, 2.0, 3.0, 6.0, 5.0, 3.0,
            2.0], [1.0, 2.0, 2.0, 4.0, 7.0, 6.0, 4.0, 2.0], [1.0, 2.0, 2.0,
            5.0, 7.0, 7.0, 5.0, 2.0], [2.0, 2.0, 2.0, 6.0, 8.0, 8.0, 6.0, 2.0],
            [2.0, 2.0, 2.0, 6.0, 8.0, 9.0, 6.0, 2.0], [2.0, 2.0, 2.0, 8.0, 8.0,
            9.0, 8.0, 2.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0]],
        "energy_kwh": [[1.0058422, 1.00582, 1.00582, 1.005263, 1.00582,
            1.00582, 1.00582, 1.0046014], [1.0059277, 1.00582, 1.00582,
            1.0049846, 1.00582, 1.00582, 1.00582, 1.0021646], [1.0060436,
            1.0058202, 1.0056531, 1.004985, 1.0058202, 1.0058202, 1.0043577,
            1.0021647], [1.0055394, 1.0058202, 1.0048631, 1.004985, 1.0058202,
            1.0028957, 1.0039924, 1.0021647], [1.0035776, 1.0043582, 1.0031571,
            1.0049851, 1.0058202, 1.0021647, 1.0038707, 1.001942], [1.0035689,
            1.0039927, 1.0021825, 1.0049851, 1.0046018, 1.0013853, 1.0039927,
            1.0013297], [1.0035924, 1.0039927, 1.0013299, 1.0049852, 1.0039927,
            1.0013299, 1.0039927, 1.0013299], [1.0035937, 1.0039928, 1.00133,
            1.0049852, 1.0039928, 1.00133, 1.0039928, 1.00133], [1.0035957,
            1.0036273, 1.0013301, 1.0049853, 1.0025308, 0.99999, 1.0039928,
            0.9995026], [1.0031934, 1.0011907, 1.0013303, 1.0038888, 1.0021653,
            0.9995027, 1.0038711, 0.9995027], [1.0013899, 0.9993632, 0.9990155,
            1.0029908, 1.0021654, 0.99804074, 1.0021654, 0.9995028],
            [0.99979854, 0.99778664, 0.9973413, 1.0023229, 1.0021656,
            0.9970629, 1.0011319, 0.99840635], [0.99962616, 0.9976754,
            0.9968403, 1.0023234, 1.0009472, 0.9959875, 0.99950296, 0.9976754],
            [0.9995035, 0.99621344, 0.9968405, 1.0023234, 1.0003386, 0.9938438,
            0.9995035, 0.99767554], [0.99840707, 0.99402046, 0.9968409,
            1.0013489, 1.0003387, 0.9933429, 0.99950355, 0.997676],
            [0.99767613, 0.99402106, 0.996841, 0.9989123, 1.0003388, 0.995049,
            0.9995037, 0.9962141]],
        "carbon_kg": [[0.5029211, 0.50290996, 0.50290996, 0.5026316,
            0.50290996, 0.50290996, 0.50290996, 0.5023007], [0.50296366,
            0.50290984, 0.50290984, 0.5024922, 0.50290984, 0.50290984,
            0.50290984, 0.50108224], [0.50302136, 0.5029095, 0.502826,
            0.5024919, 0.5029095, 0.5029095, 0.50217843, 0.5010819],
            [0.5027689, 0.5029091, 0.50243056, 0.50249153, 0.5029091,
            0.50144696, 0.5019952, 0.50108147], [0.5017873, 0.50217754,
            0.50157726, 0.502491, 0.5029085, 0.50108105, 0.5019339,
            0.50096965], [0.5017823, 0.5019941, 0.5010891, 0.50249034,
            0.50229865, 0.5006905, 0.5019941, 0.5006627], [0.5017932,
            0.50199324, 0.5006619, 0.5024895, 0.50199324, 0.5006619,
            0.50199324, 0.5006619], [0.5017928, 0.5019923, 0.5006609,
            0.5024885, 0.5019923, 0.5006609, 0.5019923, 0.5006609], [0.5017926,
            0.5018084, 0.5006598, 0.5024875, 0.50126016, 0.49998978, 0.5019912,
            0.49974608], [0.5015902, 0.50058883, 0.50065863, 0.5019379,
            0.50107616, 0.49974483, 0.50192904, 0.49974483], [0.50068706,
            0.49967366, 0.4994998, 0.50148755, 0.5010748, 0.49901244,
            0.5010748, 0.49974346], [0.4998897, 0.49888387, 0.4986612,
            0.50115204, 0.50107336, 0.49852198, 0.5005565, 0.49919373],
            [0.4998019, 0.4988266, 0.49840903, 0.50115037, 0.50046253,
            0.49798262, 0.49974036, 0.4988266], [0.49973857, 0.49809378,
            0.49840727, 0.5011486, 0.50015616, 0.49690896, 0.49973857,
            0.4988248], [0.4991884, 0.49699533, 0.49840534, 0.50065935,
            0.50015426, 0.4966566, 0.4997367, 0.49882287], [0.49882084,
            0.49699333, 0.4984033, 0.49943897, 0.50015223, 0.4975073,
            0.49973467, 0.49808982]],
        "final_obs": [[0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0,
            0.0078125, 0.0, 0.99255955, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.99107146, 0.99107146,
            0.99553573, 0.0, 0.99553573, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.06666667, 0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.18023093, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433,
            0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.99255955, 0.66071427,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414,
            0.9936537, 1.0, 0.0078125, 0.0, 0.9895834, 0.0027777778, 0.5, 1.0,
            0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.98660713, 0.9866072,
            0.98660713, 0.99553573, 0.0, 0.99553573, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.06666667, 0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.18023093, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433,
            0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.9895834, 0.6577381, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414,
            0.9936537, 1.0, 0.0078125, 0.0, 0.99107146, 0.0027777778, 0.5, 1.0,
            0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.99107146,
            0.99107146, 0.99107146, 0.0, 0.99107146, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.06666667, 0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.18023093, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433,
            0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.66071427,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414,
            0.9936537, 1.0, 0.03125, 0.0, 0.99255955, 0.0027777778, 0.5, 0.25,
            0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.9933036, 0.9933036,
            0.9933036, 0.99107146, 0.0, 0.99107146, 1.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 0.06666667, 0.061795957, 0.044301696, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.07424609,
            0.42749566, 0.5, 0.22337508, 0.12651713, 0.34126368, 0.31787887,
            0.5, 0.25, 0.0625, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625,
            0.083333336, 0.22916667, 0.0625, 0.4375, 0.3541667, 0.39583334,
            0.083333336, 0.25, 0.5, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5,
            0.018561523, 0.026718479, 0.03125, 0.013960943, 0.031629283,
            0.08531592, 0.01986743, 0.03125, 0.6622024, 0.99255955, 0.99255955,
            0.99255955, 0.6622024, 0.6622024, 0.99255955, 0.6622024],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.03125, 0.0,
            0.99553573, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.9933036, 0.9933036, 0.9933036, 1.0, 0.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.06666667, 0.053921703, 0.053674124,
            0.053645752, 0.046766467, 0.026392212, 0.017972425, 0.00853116,
            0.5, 0.5, 0.42290732, 0.25129122, 0.5, 0.5, 0.5, 0.5, 0.25, 0.0625,
            0.0625, 0.0625, 0.0625, 0.0625, 0.0625, 0.0625, 0.3125, 0.3541667,
            0.39583334, 0.083333336, 0.39583334, 0.20833334, 0.4375, 0.4375,
            1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.125, 0.03125,
            0.026431708, 0.015705701, 0.03125, 0.03125, 0.03125, 0.03125,
            0.6622024, 0.99553573, 0.99553573, 0.99553573, 0.6622024,
            0.99553573, 0.99553573, 0.99553573], [0.017452406, 0.9998477,
            1.3157414, 0.9936537, 1.0, 0.03515625, 0.0, 0.9880953,
            0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.99107146, 0.99107146, 0.99107146, 0.98214287, 0.0, 0.98214287,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.06666667, 0.06393188,
            0.057513393, 0.0486698, 0.033505365, 0.016758198, 0.013663017,
            0.01148193, 0.4147965, 0.5, 0.16752377, 0.12621523, 0.20077494,
            0.5, 0.26978844, 0.5, 0.0625, 0.0625, 0.0625, 0.125, 0.0625, 0.125,
            0.0625, 0.125, 0.3125, 0.4375, 0.39583334, 0.125, 0.375,
            0.20833334, 0.10416667, 0.27083334, 1.0, 0.0, 0.0, 1.0, 1.0, 1.0,
            0.0, 0.5, 0.025924781, 0.03125, 0.010470236, 0.015776904,
            0.012548434, 0.0625, 0.016861778, 0.0625, 0.66071427, 0.9880953,
            0.9880953, 0.66071427, 0.66071427, 0.66071427, 0.9880953,
            0.66071427], [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0,
            0.03125, 0.0, 0.99404764, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.9933036, 0.9933036, 0.9933036,
            0.99553573, 0.0, 0.99553573, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 0.06666667, 0.061795957, 0.044301696, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.07424609,
            0.42749566, 0.5, 0.22337508, 0.12651713, 0.34126368, 0.31787887,
            0.5, 0.25, 0.0625, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625,
            0.083333336, 0.22916667, 0.0625, 0.4375, 0.3541667, 0.39583334,
            0.083333336, 0.25, 0.5, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5,
            0.018561523, 0.026718479, 0.03125, 0.013960943, 0.031629283,
            0.08531592, 0.01986743, 0.03125, 0.6622024, 0.99404764, 0.99404764,
            0.99404764, 0.6622024, 0.6622024, 0.99404764, 0.6622024],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.0078125, 0.0,
            0.99107146, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.98883927, 0.9888393, 0.9888393, 0.99553573, 0.0,
            0.99553573, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.06666667,
            0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.18023093, 0.312406, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433, 0.0781015, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.99107146, 0.6592262, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0]],
        "digest_jstate": [820, 820, 820, 820, 820, 820, 820, 820],
        "digest_placement": [-8390656, -8390656, -8390656, -8390656, -8390656,
            -8390656, -8390656, -8390656],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "digest_degrade_level": [4, 4, 4, 1, 4, 4, 4, 4],
        "digest_n_failures": [0, 0, 0, 0, 0, 0, 0, 0],
        "n_completed": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        "past_queued": 50,
    },
    "macro": {
        "reward": [[-3.1442566, -3.151687, -3.151687, -3.1489468, -3.150687,
            -3.153687, -3.150687, -3.1478794], [-3.1510234, -3.1581867,
            -3.1581867, -3.1545768, -3.150687, -3.1581867, -3.1571867,
            -3.146764], [-3.1513844, -3.1581864, -3.1576643, -3.155576,
            -3.1506855, -3.164686, -3.153617, -3.1467636], [-3.1498077,
            -3.1581843, -3.1551936, -3.1555743, -3.172184, -3.1565456,
            -3.1524727, -3.1467617], [-3.1436744, -3.153614, -3.1498616,
            -3.1555727, -3.1751823, -3.1597598, -3.152091, -3.1460643],
            [-3.1436453, -3.152469, -3.1468127, -3.1605697, -3.176872,
            -3.159322, -3.1574688, -3.1441476], [-3.143715, -3.1524658,
            -3.1441445, -3.1630676, -3.1749659, -3.159145, -3.1599655,
            -3.1441445], [-3.1437154, -3.1524625, -3.1441412, -3.163064,
            -3.1749628, -3.1596417, -3.1599622, -3.1441412], [-3.1437173,
            -3.1513166, -3.1441374, -3.1630597, -3.1703897, -3.1624498,
            -3.1599586, -3.1384263], [-3.1424556, -3.1436975, -3.1441336,
            -3.159629, -3.1722434, -3.1609225, -3.1595738, -3.1384225],
            [-3.1368148, -3.1379814, -3.1368952, -3.1568184, -3.1767385,
            -3.1563485, -3.1542385, -3.138418], [-3.1318357, -3.133049,
            -3.1316576, -3.1552258, -3.179234, -3.1537876, -3.1515033,
            -3.1349857], [-3.1312919, -3.1326962, -3.1300862, -3.1627195,
            -3.1804204, -3.1599212, -3.153907, -3.1326962], [-3.138401,
            -3.1281207, -3.13008, -3.1717138, -3.1790106, -3.1642158,
            -3.1629012, -3.1326897], [-3.1349676, -3.1212606, -3.1300733,
            -3.1741614, -3.1860042, -3.1661432, -3.1683946, -3.132683],
            [-3.1326761, -3.121254, -3.1300669, -3.1785393, -3.185997,
            -3.1769664, -3.1803873, -3.128107]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False]],
        "facility_w": [[241412.77, 241396.77, 241396.77, 241196.34, 241396.77,
            241396.77, 241396.77, 240519.52], [241427.56, 241396.78, 241396.78,
            241196.34, 241396.78, 241396.78, 241396.78, 240519.53], [241458.1,
            241396.78, 241196.36, 241196.36, 241396.78, 241396.78, 240958.16,
            240519.53], [240837.86, 241396.8, 240757.75, 241196.38, 241396.8,
            240519.55, 240958.17, 240519.55], [240865.81, 240958.19, 240757.77,
            241196.39, 241396.81, 240519.56, 240958.19, 240319.12], [240851.9,
            240958.2, 240319.16, 241196.4, 240958.2, 240319.16, 240958.2,
            240319.16], [240863.61, 240958.22, 240319.17, 241196.42, 240958.22,
            240319.17, 240958.22, 240319.17], [240861.92, 240958.25, 240319.2,
            241196.45, 240958.25, 240319.2, 240958.25, 240319.2], [240857.34,
            240519.66, 240319.22, 241196.48, 240519.66, 239880.6, 240958.28,
            239880.6], [240413.9, 240081.06, 240319.27, 240757.89, 240519.69,
            239880.64, 240519.69, 239880.64], [239949.86, 239642.47, 239442.05,
            240557.5, 240519.72, 239442.05, 240519.72, 239880.67], [239952.48,
            239442.08, 239241.66, 240557.53, 240519.77, 239241.66, 239880.72,
            239442.08], [239912.06, 239442.12, 239241.7, 240557.58, 240081.19,
            238803.11, 239880.75, 239442.12], [239880.8, 239003.55, 239241.75,
            240557.62, 240081.22, 238402.3, 239880.8, 239442.17], [239442.22,
            238564.97, 239241.8, 240119.05, 240081.28, 238402.34, 239880.84,
            239442.22], [239442.28, 238565.02, 239241.84, 239680.47, 240081.33,
            238841.0, 239880.9, 239003.66]],
        "queue_len": [[1.0, 2.0, 2.0, 1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0,
            2.0, 1.0, 2.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 1.0, 3.0, 2.0, 2.0],
            [1.0, 2.0, 2.0, 2.0, 4.0, 3.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 5.0,
            4.0, 2.0, 2.0], [1.0, 2.0, 2.0, 3.0, 5.0, 4.0, 3.0, 2.0], [1.0,
            2.0, 2.0, 3.0, 5.0, 4.0, 3.0, 2.0], [1.0, 2.0, 2.0, 3.0, 5.0, 5.0,
            3.0, 2.0], [1.0, 2.0, 2.0, 3.0, 5.0, 5.0, 3.0, 2.0], [1.0, 2.0,
            2.0, 3.0, 6.0, 5.0, 3.0, 2.0], [1.0, 2.0, 2.0, 3.0, 6.0, 5.0, 3.0,
            2.0], [1.0, 2.0, 2.0, 4.0, 7.0, 6.0, 4.0, 2.0], [1.0, 2.0, 2.0,
            5.0, 7.0, 7.0, 5.0, 2.0], [2.0, 2.0, 2.0, 6.0, 8.0, 8.0, 6.0, 2.0],
            [2.0, 2.0, 2.0, 6.0, 8.0, 9.0, 6.0, 2.0], [2.0, 2.0, 2.0, 8.0, 8.0,
            9.0, 8.0, 2.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0]],
        "energy_kwh": [[1.0058422, 1.00582, 1.00582, 1.005263, 1.00582,
            1.00582, 1.00582, 1.0046014], [1.0059277, 1.00582, 1.00582,
            1.0049846, 1.00582, 1.00582, 1.00582, 1.0021646], [1.0060436,
            1.0058202, 1.0056531, 1.004985, 1.0058202, 1.0058202, 1.0043577,
            1.0021647], [1.0055394, 1.0058202, 1.0048631, 1.004985, 1.0058202,
            1.0028957, 1.0039924, 1.0021647], [1.0035776, 1.0043582, 1.0031571,
            1.0049851, 1.0058202, 1.0021647, 1.0038707, 1.001942], [1.0035689,
            1.0039927, 1.0021825, 1.0049851, 1.0046018, 1.0013853, 1.0039927,
            1.0013297], [1.0035924, 1.0039927, 1.0013299, 1.0049852, 1.0039927,
            1.0013299, 1.0039927, 1.0013299], [1.0035937, 1.0039928, 1.00133,
            1.0049852, 1.0039928, 1.00133, 1.0039928, 1.00133], [1.0035957,
            1.0036273, 1.0013301, 1.0049853, 1.0025308, 0.99999, 1.0039928,
            0.9995026], [1.0031934, 1.0011907, 1.0013303, 1.0038888, 1.0021653,
            0.9995027, 1.0038711, 0.9995027], [1.0013899, 0.9993632, 0.9990155,
            1.0029908, 1.0021654, 0.99804074, 1.0021654, 0.9995028],
            [0.99979854, 0.99778664, 0.9973413, 1.0023229, 1.0021656,
            0.9970629, 1.0011319, 0.99840635], [0.99962616, 0.9976754,
            0.9968403, 1.0023234, 1.0009472, 0.9959875, 0.99950296, 0.9976754],
            [0.9995035, 0.99621344, 0.9968405, 1.0023234, 1.0003386, 0.9938438,
            0.9995035, 0.99767554], [0.99840707, 0.99402046, 0.9968409,
            1.0013489, 1.0003387, 0.9933429, 0.99950355, 0.997676],
            [0.99767613, 0.99402106, 0.996841, 0.9989123, 1.0003388, 0.995049,
            0.9995037, 0.9962141]],
        "carbon_kg": [[0.5029211, 0.50290996, 0.50290996, 0.5026316,
            0.50290996, 0.50290996, 0.50290996, 0.5023007], [0.50296366,
            0.50290984, 0.50290984, 0.5024922, 0.50290984, 0.50290984,
            0.50290984, 0.50108224], [0.50302136, 0.5029095, 0.502826,
            0.5024919, 0.5029095, 0.5029095, 0.50217843, 0.5010819],
            [0.5027689, 0.5029091, 0.50243056, 0.50249153, 0.5029091,
            0.50144696, 0.5019952, 0.50108147], [0.5017873, 0.50217754,
            0.50157726, 0.502491, 0.5029085, 0.50108105, 0.5019339,
            0.50096965], [0.5017823, 0.5019941, 0.5010891, 0.50249034,
            0.50229865, 0.5006905, 0.5019941, 0.5006627], [0.5017932,
            0.50199324, 0.5006619, 0.5024895, 0.50199324, 0.5006619,
            0.50199324, 0.5006619], [0.5017928, 0.5019923, 0.5006609,
            0.5024885, 0.5019923, 0.5006609, 0.5019923, 0.5006609], [0.5017926,
            0.5018084, 0.5006598, 0.5024875, 0.50126016, 0.49998978, 0.5019912,
            0.49974608], [0.5015902, 0.50058883, 0.50065863, 0.5019379,
            0.50107616, 0.49974483, 0.50192904, 0.49974483], [0.50068706,
            0.49967366, 0.4994998, 0.50148755, 0.5010748, 0.49901244,
            0.5010748, 0.49974346], [0.4998897, 0.49888387, 0.4986612,
            0.50115204, 0.50107336, 0.49852198, 0.5005565, 0.49919373],
            [0.4998019, 0.4988266, 0.49840903, 0.50115037, 0.50046253,
            0.49798262, 0.49974036, 0.4988266], [0.49973857, 0.49809378,
            0.49840727, 0.5011486, 0.50015616, 0.49690896, 0.49973857,
            0.4988248], [0.4991884, 0.49699533, 0.49840534, 0.50065935,
            0.50015426, 0.4966566, 0.4997367, 0.49882287], [0.49882084,
            0.49699333, 0.4984033, 0.49943897, 0.50015223, 0.4975073,
            0.49973467, 0.49808982]],
        "final_obs": [[0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0,
            0.0078125, 0.0, 0.99255955, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.99107146, 0.99107146,
            0.99553573, 0.0, 0.99553573, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.06666667, 0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.18023093, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433,
            0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.99255955, 0.66071427,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414,
            0.9936537, 1.0, 0.0078125, 0.0, 0.9895834, 0.0027777778, 0.5, 1.0,
            0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.98660713, 0.9866072,
            0.98660713, 0.99553573, 0.0, 0.99553573, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.06666667, 0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.18023093, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433,
            0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.9895834, 0.6577381, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414,
            0.9936537, 1.0, 0.0078125, 0.0, 0.99107146, 0.0027777778, 0.5, 1.0,
            0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.99107146,
            0.99107146, 0.99107146, 0.0, 0.99107146, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.06666667, 0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.18023093, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433,
            0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.99107146, 0.66071427,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414,
            0.9936537, 1.0, 0.03125, 0.0, 0.99255955, 0.0027777778, 0.5, 0.25,
            0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.9933036, 0.9933036,
            0.9933036, 0.99107146, 0.0, 0.99107146, 1.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 0.06666667, 0.061795957, 0.044301696, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.07424609,
            0.42749566, 0.5, 0.22337508, 0.12651713, 0.34126368, 0.31787887,
            0.5, 0.25, 0.0625, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625,
            0.083333336, 0.22916667, 0.0625, 0.4375, 0.3541667, 0.39583334,
            0.083333336, 0.25, 0.5, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5,
            0.018561523, 0.026718479, 0.03125, 0.013960943, 0.031629283,
            0.08531592, 0.01986743, 0.03125, 0.6622024, 0.99255955, 0.99255955,
            0.99255955, 0.6622024, 0.6622024, 0.99255955, 0.6622024],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.03125, 0.0,
            0.99553573, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.9933036, 0.9933036, 0.9933036, 1.0, 0.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.06666667, 0.053921703, 0.053674124,
            0.053645752, 0.046766467, 0.026392212, 0.017972425, 0.00853116,
            0.5, 0.5, 0.42290732, 0.25129122, 0.5, 0.5, 0.5, 0.5, 0.25, 0.0625,
            0.0625, 0.0625, 0.0625, 0.0625, 0.0625, 0.0625, 0.3125, 0.3541667,
            0.39583334, 0.083333336, 0.39583334, 0.20833334, 0.4375, 0.4375,
            1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.125, 0.03125,
            0.026431708, 0.015705701, 0.03125, 0.03125, 0.03125, 0.03125,
            0.6622024, 0.99553573, 0.99553573, 0.99553573, 0.6622024,
            0.99553573, 0.99553573, 0.99553573], [0.017452406, 0.9998477,
            1.3157414, 0.9936537, 1.0, 0.03515625, 0.0, 0.9880953,
            0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.99107146, 0.99107146, 0.99107146, 0.98214287, 0.0, 0.98214287,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.06666667, 0.06393188,
            0.057513393, 0.0486698, 0.033505365, 0.016758198, 0.013663017,
            0.01148193, 0.4147965, 0.5, 0.16752377, 0.12621523, 0.20077494,
            0.5, 0.26978844, 0.5, 0.0625, 0.0625, 0.0625, 0.125, 0.0625, 0.125,
            0.0625, 0.125, 0.3125, 0.4375, 0.39583334, 0.125, 0.375,
            0.20833334, 0.10416667, 0.27083334, 1.0, 0.0, 0.0, 1.0, 1.0, 1.0,
            0.0, 0.5, 0.025924781, 0.03125, 0.010470236, 0.015776904,
            0.012548434, 0.0625, 0.016861778, 0.0625, 0.66071427, 0.9880953,
            0.9880953, 0.66071427, 0.66071427, 0.66071427, 0.9880953,
            0.66071427], [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0,
            0.03125, 0.0, 0.99404764, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.9933036, 0.9933036, 0.9933036,
            0.99553573, 0.0, 0.99553573, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 0.06666667, 0.061795957, 0.044301696, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.07424609,
            0.42749566, 0.5, 0.22337508, 0.12651713, 0.34126368, 0.31787887,
            0.5, 0.25, 0.0625, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625,
            0.083333336, 0.22916667, 0.0625, 0.4375, 0.3541667, 0.39583334,
            0.083333336, 0.25, 0.5, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5,
            0.018561523, 0.026718479, 0.03125, 0.013960943, 0.031629283,
            0.08531592, 0.01986743, 0.03125, 0.6622024, 0.99404764, 0.99404764,
            0.99404764, 0.6622024, 0.6622024, 0.99404764, 0.6622024],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.0078125, 0.0,
            0.99107146, 0.0027777778, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.98883927, 0.9888393, 0.9888393, 0.99553573, 0.0,
            0.99553573, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.06666667,
            0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.18023093, 0.312406, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.3541667, 0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.011264433, 0.0781015, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.99107146, 0.6592262, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0]],
        "digest_jstate": [820, 820, 820, 820, 820, 820, 820, 820],
        "digest_placement": [-8390656, -8390656, -8390656, -8390656, -8390656,
            -8390656, -8390656, -8390656],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "digest_degrade_level": [4, 4, 4, 1, 4, 4, 4, 4],
        "digest_n_failures": [0, 0, 0, 0, 0, 0, 0, 0],
        "n_completed": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        "past_queued": 50,
    },
}


# ---------------------------------------------------------------------------
# The serving twin (``core.serving``) on the replay hour: TX-GAIA's batch
# fleet plus a pool of SERVING["serving_nodes"] inference nodes (every
# other serving field at its default), under ``diurnal_serving`` squeezed
# into the hour (SERVING_TRAFFIC: a 48 req/s peak at half past, a trough
# of a tenth of it, and a 5-minute flash crowd doubling the rate from
# 30 min), the pool starting half asleep (SERVING_ACTIVE0 nodes awake, the
# target the whole pool, so the first tick opens a wake batch). Every rung
# of the overload ladder fires, only around the peak and the burst.
# - ``replay_tx_gaia_1h_serving``: 3600 ticks of "replay" per tick;
# - ``replay_tx_gaia_1h_serving_macro``: the same macro-stepped, held to
#   the same pins and bitwise to the port's per-tick run; the JAX
#   package's own event ticks are reported (its macro path parts from its
#   per tick in the last bits of ``srv_dropped`` and ``srv_retried``);
# - ``fleet_tx_gaia_serving``: FLEET_SERVING_E replicas of the hour's
#   config for FLEET_SERVING_TICKS ticks, replica i under
#   ``diurnal_serving`` at a peak of 12 (i + 1) req/s (burst from 600 s),
#   each starting half asleep; replicas 0-4 never overload;
# - ``rl_tx_gaia_serving``: ``rl_tx_gaia`` with the pool, a 960 s traffic
#   cycle and the SLO reward weight, RL_SERVING_STEPS decisions of
#   ``rl_serving_script`` (every dispatch index, the no-op and the four
#   serving actions), per tick and macro.
# ``PINNED_SERVING``, ``PINNED_FLEET_SERVING`` and ``PINNED_RL_SERVING``
# hold what the JAX package gives on the CPU (jax 0.9.0), made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_serving_pins.py
SERVING_TRAFFIC = dict(peak_rps=48.0, base_frac=0.1, period_s=3600.0,
                       burst_start_s=1800.0, burst_len_s=300.0,
                       burst_mult=2.0)
SERVING_ACTIVE0 = 16.0
SERVING_CASE = "replay_tx_gaia_1h_serving"
SERVING_MACRO_CASE = f"{SERVING_CASE}_macro"
SERVING_KEYS = ("completed", "energy_kwh", "avg_pue", "carbon_kg",
                "srv_arrived", "srv_completed", "srv_shed", "srv_dropped",
                "srv_retried", "srv_mean_latency_s",
                "srv_slo_violation_frac", "srv_p50_latency_x_slo",
                "srv_p99_latency_x_slo", "srv_active", "srv_lat_hist")
FLEET_SERVING_CASE = "fleet_tx_gaia_serving"
FLEET_SERVING_E = 8
FLEET_SERVING_TICKS = 1200
FLEET_SERVING_ALONE = (0, 7)
FLEET_SERVING_KEYS = ("completed", "energy_kwh", "avg_pue", "srv_arrived",
                      "srv_completed", "srv_shed", "srv_dropped",
                      "srv_retried", "srv_slo_violation_frac")
RL_SERVING_CASE = "rl_tx_gaia_serving"
RL_SERVING_TRAFFIC = dict(peak_rps=48.0, base_frac=0.1, period_s=960.0,
                          burst_start_s=240.0, burst_len_s=120.0,
                          burst_mult=2.0)
RL_SERVING_WEIGHTS = (1.0, 1.0, 1.0, 0.05, 0.0, 0.0, 5.0)
RL_SERVING_STEPS = 16


def serving_scenario(cfg: SimConfig, traffic: dict | None = None):
    """The port's ``diurnal_serving`` at ``traffic`` (default
    ``SERVING_TRAFFIC``), on the CPU."""
    from repro_torch.scenarios.scenario import diurnal_serving

    return diurnal_serving(cfg, **(SERVING_TRAFFIC if traffic is None
                                   else traffic))


def fleet_serving_traffic(e: int) -> dict:
    """Replica ``e``'s traffic in the serving fleet."""
    return dict(SERVING_TRAFFIC, peak_rps=12.0 * (e + 1), burst_start_s=600.0)


def half_asleep(state):
    """``state`` with SERVING_ACTIVE0 pool nodes awake (of each replica)."""
    return state._replace(srv_active=state.srv_active.new_full(
        state.srv_active.shape, SERVING_ACTIVE0))


def serving_summary(final, telem) -> dict:
    """``summary`` of a serving hour with the final pool size and the
    latency histogram (one state)."""
    from repro_torch.core import summary

    got = summary(final, telem)
    got["srv_active"] = float(final.srv_active)
    got["srv_lat_hist"] = final.srv_lat_hist.cpu().double().tolist()
    return got


def check_serving(case: str, got: dict, pins: dict | None = None) -> dict:
    """Hold a serving hour's ``serving_summary`` to ``PINNED_SERVING[case]``
    (or ``pins``): ``completed`` exactly, every other value, the
    histogram's eight too, within ``RTOL`` (a pinned 0 exactly). The
    reference's event ticks are only reported. Returns the largest
    relative error."""
    pins = PINNED_SERVING[case] if pins is None else pins
    if got["completed"] != pins["completed"]:
        raise AssertionError(f"{case}: completed {got['completed']} != "
                             f"pinned {pins['completed']}")
    worst = 0.0
    for k in SERVING_KEYS:
        g, w = np.asarray(got[k], np.float64), np.asarray(pins[k])
        rel = np.where(g == w, 0.0, np.abs(g - w)
                       / np.maximum(np.abs(w), 1e-30))
        worst = max(worst, float(np.max(rel)))
        if not np.all(rel <= RTOL):
            raise AssertionError(f"{case}: {k} {g.tolist()} vs pinned "
                                 f"{w.tolist()} (rtol {RTOL})")
    return {"max_rel_err": worst}


def check_fleet_serving(cols: dict, replicas=None) -> dict:
    """Hold ``summary_columns`` of the serving fleet (all replicas, or the
    ``replicas`` they are) to ``PINNED_FLEET_SERVING``: ``completed``
    exactly, the rest within ``RTOL`` (a pinned 0 exactly). Returns the
    largest relative error."""
    idx = (np.arange(FLEET_SERVING_E) if replicas is None
           else np.asarray(replicas))
    worst = 0.0
    for k in FLEET_SERVING_KEYS:
        want = np.asarray(PINNED_FLEET_SERVING[k])[idx]
        got = np.asarray(cols[k])
        if k == "completed":
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{FLEET_SERVING_CASE}: completed {got.tolist()} vs "
                    f"pinned {want.tolist()}")
            continue
        rel = np.where(got == want, 0.0, np.abs(got - want)
                       / np.maximum(np.abs(want), 1e-30))
        worst = max(worst, float(rel.max()))
        if not np.all(rel <= RTOL):
            raise AssertionError(
                f"{FLEET_SERVING_CASE}: {k} off the pins by rel "
                f"{rel.max():.3g} at replicas {idx[rel > RTOL].tolist()}")
    return {"max_rel_err": worst, "replicas": len(idx)}


def rl_serving_script(k: int, n_envs: int, steps: int) -> np.ndarray:
    """(steps, n_envs) int32 actions over the serving action space: env e
    at step t takes (t + 3 e) mod (k + 5), so every dispatch index, the
    no-op k and the four serving actions k + 1 + c recur."""
    t = np.arange(steps)[:, None]
    e = np.arange(n_envs)[None, :]
    return ((t + 3 * e) % (k + 5)).astype(np.int32)


# ``PINNED_SERVING``, ``PINNED_FLEET_SERVING``, ``PINNED_RL_SERVING``: what
# the JAX package gives for the serving cases on the CPU (jax 0.9.0), made
# by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_serving_pins.py
# (~35 s on 8 cores)
PINNED_SERVING = {
    "replay_tx_gaia_1h_serving": {
        "completed": 103.0,
        "energy_kwh": 283.05084,
        "avg_pue": 1.2519201,
        "carbon_kg": 141.12384,
        "srv_arrived": 109149.37,
        "srv_completed": 100665.06,
        "srv_shed": 8323.908,
        "srv_dropped": 141.18619,
        "srv_retried": 9883.44,
        "srv_mean_latency_s": 5.4830723,
        "srv_slo_violation_frac": 0.18564534,
        "srv_p50_latency_x_slo": 0.5,
        "srv_p99_latency_x_slo": 2.0,
        "srv_active": 32.0,
        "srv_lat_hist": [0.0, 0.0, 80185.13, 1792.0, 18688.0, 0.0, 0.0, 0.0],
    },
    "replay_tx_gaia_1h_serving_macro": {
        "completed": 103.0,
        "energy_kwh": 283.05084,
        "avg_pue": 1.2519201,
        "carbon_kg": 141.12384,
        "srv_arrived": 109149.37,
        "srv_completed": 100665.06,
        "srv_shed": 8323.908,
        "srv_dropped": 141.18619,
        "srv_retried": 9883.44,
        "srv_mean_latency_s": 5.4830723,
        "srv_slo_violation_frac": 0.18564534,
        "srv_p50_latency_x_slo": 0.5,
        "srv_p99_latency_x_slo": 2.0,
        "srv_active": 32.0,
        "srv_lat_hist": [0.0, 0.0, 80185.13, 1792.0, 18688.0, 0.0, 0.0, 0.0],
        "reference_macro_steps_taken": 807.0,
    },
}
PINNED_FLEET_SERVING = {
    "completed": [
        17.0, 17.0, 17.0, 17.0, 17.0, 17.0, 17.0, 17.0,
    ],
    "energy_kwh": [
        87.95734405517578, 88.3814468383789, 88.80561065673828,
        89.22975158691406, 89.65374755859375, 90.0461196899414,
        90.34526824951172, 90.54520416259766,
    ],
    "avg_pue": [
        1.2522319690194716, 1.252196658836699, 1.2521607973602051,
        1.252126700359273, 1.2520895692233336, 1.2520596217806674,
        1.2520361108743916, 1.2520192973128081,
    ],
    "srv_arrived": [
        6808.7294921875, 13617.458984375, 20426.177734375, 27234.91796875,
        34043.6640625, 40852.35546875, 47661.09765625, 54469.8359375,
    ],
    "srv_completed": [
        6771.63134765625, 13543.2626953125, 20314.869140625, 27086.525390625,
        33858.14453125, 40122.25, 44896.7421875, 48090.4140625,
    ],
    "srv_shed": [
        0.0, 0.0, 0.0, 0.0, 0.0, 503.2955322265625, 2456.54931640625,
        5464.19287109375,
    ],
    "srv_dropped": [
        0.0, 0.0, 0.0, 0.0, 0.0, 4.216803073883057, 41.080787658691406,
        86.38230895996094,
    ],
    "srv_retried": [
        0.0, 0.0, 0.0, 0.0, 0.0, 965.6715087890625, 3667.97119140625,
        7193.833984375,
    ],
    "srv_slo_violation_frac": [
        0.0, 0.0, 0.0, 0.0, 0.0, 0.08773186947392034, 0.21810045724712418,
        0.3593231694271191,
    ],
}
PINNED_RL_SERVING = {
    "per_tick": {
        "reward": [[-3.3103008, -3.3177314, -3.3177314, -3.3123548, -3.3167312,
            -3.3197312, -3.3167312, -3.3177314], [-3.3212006, -3.3283641,
            -3.3283641, -3.3273642, -3.3150244, -3.3283641, -3.3273642,
            -3.323988], [-3.322684, -3.3294854, -3.3294854, -3.3294854,
            -3.323363, -3.335985, -3.3294854, -3.3294854], [-3.324614,
            -3.331153, -3.3267767, -3.331153, -3.3560677, -3.338653, -3.331153,
            -3.331153], [-3.3272119, -3.333399, -3.333399, -3.3266177,
            -3.369168, -3.3463988, -3.3290224, -3.333399], [-3.3299875,
            -3.3362014, -3.3362014, -3.337348, -3.3839014, -3.3512015,
            -3.341201, -3.3287709], [-3.333393, -3.3351576, -3.339534, -3.3471,
            -3.3861387, -3.354534, -3.3470337, -3.3323708], [-3.3372276,
            -3.343365, -3.3359342, -3.3543444, -3.388659, -3.3544888,
            -3.350865, -3.3365636], [-3.341525, -3.3476567, -3.3404932,
            -3.3613462, -3.3917856, -3.3701565, -3.3483756, -3.3411179],
            [-3.3417451, -3.3523679, -3.3455665, -3.3663201, -3.3977363,
            -3.374868, -3.3485203, -3.3461807], [-3.3513181, -3.3500226,
            -3.3509152, -3.3723977, -3.403159, -3.3799531, -3.3575525,
            -3.3512397], [-3.3566937, -3.3557003, -3.3566763, -3.377591,
            -3.4168594, -3.378701, -3.366911, -3.3567228], [-3.36239,
            -3.3617463, -3.3623333, -3.3916807, -3.4255574, -3.3877938,
            -3.3828323, -3.3624098], [-3.361395, -3.3679106, -3.3683083,
            -3.4019804, -3.4357085, -3.399699, -3.3980231, -3.3683171],
            [-3.3696141, -3.3743248, -3.3743749, -3.4176533, -3.442921,
            -3.4051435, -3.4106016, -3.3698893], [-3.3786988, -3.380464,
            -3.380546, -3.4355664, -3.4442308, -3.414162, -3.4280405,
            -3.380543]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False]],
        "facility_w": [[254439.97, 254423.97, 254423.97, 254087.86, 254423.97,
            254423.97, 254423.97, 254423.97], [254531.55, 254500.77, 254500.77,
            254500.77, 254883.31, 254500.77, 254500.77, 254164.67], [254666.25,
            254604.94, 254604.94, 254604.94, 255436.38, 254604.94, 254604.94,
            254604.94], [254834.23, 254754.11, 254418.0, 254754.11, 256437.47,
            254754.11, 254754.11, 254754.11], [255055.1, 254947.05, 254947.05,
            255112.67, 257131.58, 254947.05, 254610.94, 254947.05], [255276.03,
            255181.89, 255181.89, 255519.17, 257873.06, 255181.89, 255181.89,
            255197.89], [255562.23, 255120.31, 255456.42, 256196.02, 257751.7,
            255456.42, 255456.42, 255487.2], [255872.02, 255767.92, 255783.92,
            256662.94, 257914.88, 255431.84, 255767.92, 255829.23], [256212.97,
            256113.48, 256144.27, 257148.45, 258395.7, 256113.48, 256279.11,
            256193.61], [256248.28, 256489.72, 256551.03, 257579.6, 258609.38,
            256489.72, 256828.47, 256597.77], [256992.69, 256909.02, 256973.14,
            258016.67, 258674.62, 256893.02, 257635.81, 256987.17], [257422.9,
            257350.28, 257427.55, 258396.64, 259501.27, 257397.2, 258220.84,
            257425.31], [257874.27, 257826.39, 257859.22, 258925.36, 259785.78,
            257939.45, 258807.84, 257869.17], [258456.12, 258305.53, 258331.23,
            259026.52, 260700.5, 258663.03, 259325.66, 258324.9], [259059.81,
            258804.16, 258800.2, 259824.6, 261201.56, 259359.61, 259831.3,
            258454.66], [259781.19, 259266.78, 259272.12, 260266.0, 261901.66,
            260269.14, 260259.62, 259272.31]],
        "queue_len": [[1.0, 2.0, 2.0, 1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0,
            2.0, 0.0, 2.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 0.0, 3.0, 2.0, 2.0],
            [1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 2.0, 2.0], [1.0, 2.0, 2.0, 1.0, 4.0,
            4.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 4.0, 4.0, 3.0, 1.0], [1.0,
            2.0, 2.0, 2.0, 4.0, 4.0, 3.0, 1.0], [1.0, 2.0, 1.0, 2.0, 4.0, 5.0,
            3.0, 1.0], [1.0, 2.0, 1.0, 2.0, 4.0, 5.0, 2.0, 1.0], [1.0, 2.0,
            1.0, 2.0, 5.0, 5.0, 1.0, 1.0], [1.0, 1.0, 1.0, 2.0, 5.0, 5.0, 1.0,
            1.0], [1.0, 1.0, 1.0, 3.0, 6.0, 5.0, 2.0, 1.0], [1.0, 1.0, 1.0,
            4.0, 6.0, 5.0, 3.0, 1.0], [0.0, 1.0, 1.0, 5.0, 7.0, 5.0, 4.0, 1.0],
            [0.0, 1.0, 1.0, 5.0, 6.0, 5.0, 4.0, 1.0], [0.0, 1.0, 1.0, 7.0, 5.0,
            4.0, 6.0, 1.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0]],
        "energy_kwh": [[1.0589763, 1.058954, 1.058954, 1.0575536, 1.058954,
            1.058954, 1.058954, 1.058954], [1.0603845, 1.0602767, 1.0602767,
            1.0602767, 1.0608081, 1.0602767, 1.0602767, 1.0588764], [1.0608594,
            1.0606358, 1.0606358, 1.0606358, 1.0634767, 1.0606358, 1.0606358,
            1.0606358], [1.0614778, 1.0611702, 1.0597695, 1.0611702, 1.0670629,
            1.0611702, 1.0611702, 1.0611702], [1.0623096, 1.0618894, 1.0618894,
            1.0621195, 1.0702956, 1.0618894, 1.0604889, 1.0618894], [1.0631988,
            1.062787, 1.062787, 1.0639541, 1.0732511, 1.062787, 1.062787,
            1.0628093], [1.0642896, 1.0624542, 1.0638547, 1.0662757, 1.0739682,
            1.0638547, 1.0638547, 1.0639623], [1.0655179, 1.0650817, 1.0651039,
            1.068595, 1.0747758, 1.0636812, 1.0650817, 1.0653055], [1.0668944,
            1.0664564, 1.0665642, 1.0708371, 1.0757779, 1.0664564, 1.0666865,
            1.0667641], [1.0669663, 1.0679655, 1.0681894, 1.0724305, 1.0767237,
            1.0679655, 1.0691346, 1.0683858], [1.0700315, 1.069617, 1.0699024,
            1.074377, 1.0770209, 1.0695947, 1.0720266, 1.0700063], [1.0717537,
            1.0714359, 1.0717483, 1.0758808, 1.0806068, 1.071436, 1.0748632,
            1.0717629], [1.0735786, 1.0733727, 1.0735606, 1.0779917, 1.0817922,
            1.0737079, 1.0775603, 1.0735852], [1.0756624, 1.0753477, 1.0754746,
            1.0784099, 1.084883, 1.0763999, 1.0795437, 1.0754777], [1.078295,
            1.0774026, 1.0774186, 1.0816679, 1.0873537, 1.0794246, 1.0818112,
            1.0759832], [1.0812049, 1.0793698, 1.0793961, 1.0835626, 1.0901754,
            1.0829532, 1.0835543, 1.079395]],
        "carbon_kg": [[0.5294882, 0.52947706, 0.52947706, 0.5287768,
            0.52947706, 0.52947706, 0.52947706, 0.52947706], [0.5301921,
            0.53013825, 0.53013825, 0.53013825, 0.53040385, 0.53013825,
            0.53013825, 0.529438], [0.5304293, 0.53031754, 0.53031754,
            0.53031754, 0.5317379, 0.53031754, 0.53031754, 0.53031754],
            [0.5307379, 0.5305841, 0.5298839, 0.5305841, 0.5335304, 0.5305841,
            0.5305841, 0.5305841], [0.53115326, 0.53094316, 0.53094316,
            0.5310582, 0.53514624, 0.53094316, 0.5302429, 0.53094316],
            [0.5315971, 0.53139126, 0.53139126, 0.53197473, 0.53662324,
            0.53139126, 0.53139126, 0.5314024], [0.53214157, 0.5312239,
            0.53192407, 0.53313464, 0.5369808, 0.53192407, 0.53192407,
            0.531978], [0.53275466, 0.53253657, 0.5325477, 0.53429323,
            0.5373837, 0.53183633, 0.53253657, 0.5326483], [0.53344166,
            0.53322273, 0.53327656, 0.535413, 0.53788334, 0.53322273,
            0.5333378, 0.5333765], [0.5334763, 0.5339759, 0.5340878,
            0.53620833, 0.5383548, 0.5339759, 0.5345604, 0.53418607],
            [0.53500736, 0.53480005, 0.53494275, 0.53718, 0.53850186,
            0.5347889, 0.53600484, 0.5349947], [0.53586674, 0.5357078,
            0.53586394, 0.53793013, 0.5402931, 0.53570783, 0.5374214,
            0.5358713], [0.53677726, 0.5366743, 0.5367682, 0.53898376,
            0.54088396, 0.53684187, 0.53876793, 0.5367805], [0.5378172,
            0.53765976, 0.53772336, 0.5391908, 0.54242736, 0.53818583,
            0.5397577, 0.5377248], [0.5391313, 0.5386851, 0.5386931, 0.5408177,
            0.5436604, 0.539696, 0.54088926, 0.5379754], [0.54058385,
            0.53966635, 0.53967947, 0.5417627, 0.54506886, 0.541458, 0.5417585,
            0.53967893]],
        "final_obs": [[0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.0,
            0.0078125, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0, 0.4, 0.96875,
            0.03125, 0.9, 1.0, 0.0, 0.0, 0.0, 0.0, 0.9959263, 0.99553573,
            0.997115, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414, 0.9936537,
            1.0, 0.00390625, 0.00390625, 1.0, 0.0027777778, 0.5, 0.16966723,
            0.0, 0.4, 1.0, 0.0, 0.9, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0,
            0.99996334, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.6666667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406,
            0.9998477, 1.3157414, 0.9936537, 1.0, 0.00390625, 0.00390625, 1.0,
            0.0027777778, 0.5, 0.16966723, 0.0, 0.4, 1.0, 0.0, 0.9, 1.0, 0.0,
            0.0, 0.0, 0.0, 0.99905133, 1.0, 0.99996334, 1.0, 0.0, 1.0, 1.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.062811, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.2916667, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0781015,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6666667, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0,
            0.02734375, 0.00390625, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0,
            0.4, 0.96875, 0.03125, 0.84999996, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.9991071, 0.99553573, 0.99951744, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 0.0, 0.061795957, 0.044301696, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.0,
            0.42749566, 0.5, 0.22337508, 0.12651713, 0.34126368, 0.31787887,
            0.5, 0.0, 0.0625, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625, 0.0,
            0.22916667, 0.0625, 0.4375, 0.3541667, 0.39583334, 0.083333336,
            0.25, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.0, 0.026718479,
            0.03125, 0.013960943, 0.031629283, 0.08531592, 0.01986743, 0.03125,
            0.0, 1.0, 1.0, 1.0, 0.66071427, 0.66071427, 1.0, 0.6666667, 0.0],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.01953125,
            0.01171875, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0, 0.4, 0.96875,
            0.03125, 0.95, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99547994, 0.99107146,
            0.9968352, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.053674124, 0.046766467, 0.026392212, 0.017972425, 0.00853116,
            0.0, 0.0, 0.0, 0.42290732, 0.5, 0.5, 0.5, 0.5, 0.0, 0.0, 0.0,
            0.0625, 0.0625, 0.0625, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.39583334,
            0.39583334, 0.20833334, 0.4375, 0.4375, 0.0, 0.0, 0.0, 0.0, 1.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.026431708, 0.03125, 0.03125,
            0.03125, 0.03125, 0.0, 0.0, 0.0, 0.9985119, 0.66071427, 0.9985119,
            0.9985119, 0.9985119, 0.0, 0.0, 0.0], [0.017452406, 0.9998477,
            1.3157414, 0.9936537, 1.0, 0.015625, 0.01953125, 1.0, 0.0027777778,
            0.5, 0.1714532, 0.0, 0.4, 0.96875, 0.03125, 0.9, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.99637276, 0.9933036, 0.99807686, 1.0, 0.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.06393188, 0.0486698,
            0.016758198, 0.01148193, 0.0, 0.0, 0.0, 0.0, 0.5, 0.12621523, 0.5,
            0.5, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.125, 0.125, 0.125, 0.0, 0.0,
            0.0, 0.0, 0.4375, 0.125, 0.20833334, 0.27083334, 0.0, 0.0, 0.0,
            0.0, 0.0, 1.0, 1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.015776904,
            0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.9985119, 0.66071427,
            0.66071427, 0.6636905, 0.0, 0.0, 0.0, 0.0], [0.017452406,
            0.9998477, 1.3157414, 0.9936537, 1.0, 0.0234375, 0.0078125, 1.0,
            0.0027777778, 0.5, 0.16966723, 0.0, 0.4, 1.0, 0.0, 0.9, 1.0, 0.0,
            0.0, 0.0, 0.0, 0.99893975, 0.99553573, 0.99930847, 1.0, 0.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.061795957, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.0, 0.0,
            0.42749566, 0.22337508, 0.12651713, 0.34126368, 0.31787887, 0.5,
            0.0, 0.0, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625, 0.0, 0.0,
            0.22916667, 0.4375, 0.3541667, 0.39583334, 0.083333336, 0.25, 0.0,
            0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.0, 0.0, 0.026718479,
            0.013960943, 0.031629283, 0.08531592, 0.01986743, 0.03125, 0.0,
            0.0, 1.0, 1.0, 0.66071427, 0.66071427, 1.0, 0.6666667, 0.0, 0.0],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.00390625,
            0.00390625, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0, 0.4, 0.96875,
            0.03125, 0.9, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0, 0.99996334,
            1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.062811,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.2916667,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6666667,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
        "digest_jstate": [823, 821, 821, 821, 827, 845, 824, 821],
        "digest_placement": [-8390465, -8390655, -8390655, -8390626, -8390560,
            -8389488, -8390593, -8390655],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "n_completed": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        "past_queued": 64,
    },
    "macro": {
        "reward": [[-3.3103008, -3.3177314, -3.3177314, -3.3123548, -3.3167312,
            -3.3197312, -3.3167312, -3.3177314], [-3.3212006, -3.3283641,
            -3.3283641, -3.3273642, -3.3150244, -3.3283641, -3.3273642,
            -3.323988], [-3.322684, -3.3294854, -3.3294854, -3.3294854,
            -3.323363, -3.335985, -3.3294854, -3.3294854], [-3.324614,
            -3.331153, -3.3267767, -3.331153, -3.3560677, -3.338653, -3.331153,
            -3.331153], [-3.3272119, -3.333399, -3.333399, -3.3266177,
            -3.369168, -3.3463988, -3.3290224, -3.333399], [-3.3299875,
            -3.3362014, -3.3362014, -3.337348, -3.3839014, -3.3512015,
            -3.341201, -3.3287709], [-3.333393, -3.3351576, -3.339534, -3.3471,
            -3.3861387, -3.354534, -3.3470337, -3.3323708], [-3.3372276,
            -3.343365, -3.3359342, -3.3543444, -3.388659, -3.3544888,
            -3.350865, -3.3365636], [-3.341525, -3.3476567, -3.3404932,
            -3.3613462, -3.3917856, -3.3701565, -3.3483756, -3.3411179],
            [-3.3417451, -3.3523679, -3.3455665, -3.3663201, -3.3977363,
            -3.374868, -3.3485203, -3.3461807], [-3.3513181, -3.3500226,
            -3.3509152, -3.3723977, -3.403159, -3.3799531, -3.3575525,
            -3.3512397], [-3.3566937, -3.3557003, -3.3566763, -3.377591,
            -3.4168594, -3.378701, -3.366911, -3.3567228], [-3.36239,
            -3.3617463, -3.3623333, -3.3916807, -3.4255574, -3.3877938,
            -3.3828323, -3.3624098], [-3.361395, -3.3679106, -3.3683083,
            -3.4019804, -3.4357085, -3.399699, -3.3980231, -3.3683171],
            [-3.3696141, -3.3743248, -3.3743749, -3.4176533, -3.442921,
            -3.4051435, -3.4106016, -3.3698893], [-3.3786988, -3.380464,
            -3.380546, -3.4355664, -3.4442308, -3.414162, -3.4280405,
            -3.380543]],
        "done": [[False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False], [False, False, False, False, False, False,
            False, False], [False, False, False, False, False, False, False,
            False], [False, False, False, False, False, False, False, False],
            [False, False, False, False, False, False, False, False], [False,
            False, False, False, False, False, False, False], [False, False,
            False, False, False, False, False, False], [False, False, False,
            False, False, False, False, False], [False, False, False, False,
            False, False, False, False], [False, False, False, False, False,
            False, False, False]],
        "facility_w": [[254439.97, 254423.97, 254423.97, 254087.86, 254423.97,
            254423.97, 254423.97, 254423.97], [254531.55, 254500.77, 254500.77,
            254500.77, 254883.31, 254500.77, 254500.77, 254164.67], [254666.25,
            254604.94, 254604.94, 254604.94, 255436.38, 254604.94, 254604.94,
            254604.94], [254834.23, 254754.11, 254418.0, 254754.11, 256437.47,
            254754.11, 254754.11, 254754.11], [255055.1, 254947.05, 254947.05,
            255112.67, 257131.58, 254947.05, 254610.94, 254947.05], [255276.03,
            255181.89, 255181.89, 255519.17, 257873.06, 255181.89, 255181.89,
            255197.89], [255562.23, 255120.31, 255456.42, 256196.02, 257751.7,
            255456.42, 255456.42, 255487.2], [255872.02, 255767.92, 255783.92,
            256662.94, 257914.88, 255431.84, 255767.92, 255829.23], [256212.97,
            256113.48, 256144.27, 257148.45, 258395.7, 256113.48, 256279.11,
            256193.61], [256248.28, 256489.72, 256551.03, 257579.6, 258609.38,
            256489.72, 256828.47, 256597.77], [256992.69, 256909.02, 256973.14,
            258016.67, 258674.62, 256893.02, 257635.81, 256987.17], [257422.9,
            257350.28, 257427.55, 258396.64, 259501.27, 257397.2, 258220.84,
            257425.31], [257874.27, 257826.39, 257859.22, 258925.36, 259785.78,
            257939.45, 258807.84, 257869.17], [258456.12, 258305.53, 258331.23,
            259026.52, 260700.5, 258663.03, 259325.66, 258324.9], [259059.81,
            258804.16, 258800.2, 259824.6, 261201.56, 259359.61, 259831.3,
            258454.66], [259781.19, 259266.78, 259272.12, 260266.0, 261901.66,
            260269.14, 260259.62, 259272.31]],
        "queue_len": [[1.0, 2.0, 2.0, 1.0, 1.0, 2.0, 1.0, 2.0], [1.0, 2.0, 2.0,
            2.0, 0.0, 2.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 0.0, 3.0, 2.0, 2.0],
            [1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 2.0, 2.0], [1.0, 2.0, 2.0, 1.0, 4.0,
            4.0, 2.0, 2.0], [1.0, 2.0, 2.0, 2.0, 4.0, 4.0, 3.0, 1.0], [1.0,
            2.0, 2.0, 2.0, 4.0, 4.0, 3.0, 1.0], [1.0, 2.0, 1.0, 2.0, 4.0, 5.0,
            3.0, 1.0], [1.0, 2.0, 1.0, 2.0, 4.0, 5.0, 2.0, 1.0], [1.0, 2.0,
            1.0, 2.0, 5.0, 5.0, 1.0, 1.0], [1.0, 1.0, 1.0, 2.0, 5.0, 5.0, 1.0,
            1.0], [1.0, 1.0, 1.0, 3.0, 6.0, 5.0, 2.0, 1.0], [1.0, 1.0, 1.0,
            4.0, 6.0, 5.0, 3.0, 1.0], [0.0, 1.0, 1.0, 5.0, 7.0, 5.0, 4.0, 1.0],
            [0.0, 1.0, 1.0, 5.0, 6.0, 5.0, 4.0, 1.0], [0.0, 1.0, 1.0, 7.0, 5.0,
            4.0, 6.0, 1.0]],
        "completed": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0]],
        "energy_kwh": [[1.0589763, 1.058954, 1.058954, 1.0575536, 1.058954,
            1.058954, 1.058954, 1.058954], [1.0603845, 1.0602767, 1.0602767,
            1.0602767, 1.0608081, 1.0602767, 1.0602767, 1.0588764], [1.0608594,
            1.0606358, 1.0606358, 1.0606358, 1.0634767, 1.0606358, 1.0606358,
            1.0606358], [1.0614778, 1.0611702, 1.0597695, 1.0611702, 1.0670629,
            1.0611702, 1.0611702, 1.0611702], [1.0623096, 1.0618894, 1.0618894,
            1.0621195, 1.0702956, 1.0618894, 1.0604889, 1.0618894], [1.0631988,
            1.062787, 1.062787, 1.0639541, 1.0732511, 1.062787, 1.062787,
            1.0628093], [1.0642896, 1.0624542, 1.0638547, 1.0662757, 1.0739682,
            1.0638547, 1.0638547, 1.0639623], [1.0655179, 1.0650817, 1.0651039,
            1.068595, 1.0747758, 1.0636812, 1.0650817, 1.0653055], [1.0668944,
            1.0664564, 1.0665642, 1.0708371, 1.0757779, 1.0664564, 1.0666865,
            1.0667641], [1.0669663, 1.0679655, 1.0681894, 1.0724305, 1.0767237,
            1.0679655, 1.0691346, 1.0683858], [1.0700315, 1.069617, 1.0699024,
            1.074377, 1.0770209, 1.0695947, 1.0720266, 1.0700063], [1.0717537,
            1.0714359, 1.0717483, 1.0758808, 1.0806068, 1.071436, 1.0748632,
            1.0717629], [1.0735786, 1.0733727, 1.0735606, 1.0779917, 1.0817922,
            1.0737079, 1.0775603, 1.0735852], [1.0756624, 1.0753477, 1.0754746,
            1.0784099, 1.084883, 1.0763999, 1.0795437, 1.0754777], [1.078295,
            1.0774026, 1.0774186, 1.0816679, 1.0873537, 1.0794246, 1.0818112,
            1.0759832], [1.0812049, 1.0793698, 1.0793961, 1.0835626, 1.0901754,
            1.0829532, 1.0835543, 1.079395]],
        "carbon_kg": [[0.5294882, 0.52947706, 0.52947706, 0.5287768,
            0.52947706, 0.52947706, 0.52947706, 0.52947706], [0.5301921,
            0.53013825, 0.53013825, 0.53013825, 0.53040385, 0.53013825,
            0.53013825, 0.529438], [0.5304293, 0.53031754, 0.53031754,
            0.53031754, 0.5317379, 0.53031754, 0.53031754, 0.53031754],
            [0.5307379, 0.5305841, 0.5298839, 0.5305841, 0.5335304, 0.5305841,
            0.5305841, 0.5305841], [0.53115326, 0.53094316, 0.53094316,
            0.5310582, 0.53514624, 0.53094316, 0.5302429, 0.53094316],
            [0.5315971, 0.53139126, 0.53139126, 0.53197473, 0.53662324,
            0.53139126, 0.53139126, 0.5314024], [0.53214157, 0.5312239,
            0.53192407, 0.53313464, 0.5369808, 0.53192407, 0.53192407,
            0.531978], [0.53275466, 0.53253657, 0.5325477, 0.53429323,
            0.5373837, 0.53183633, 0.53253657, 0.5326483], [0.53344166,
            0.53322273, 0.53327656, 0.535413, 0.53788334, 0.53322273,
            0.5333378, 0.5333765], [0.5334763, 0.5339759, 0.5340878,
            0.53620833, 0.5383548, 0.5339759, 0.5345604, 0.53418607],
            [0.53500736, 0.53480005, 0.53494275, 0.53718, 0.53850186,
            0.5347889, 0.53600484, 0.5349947], [0.53586674, 0.5357078,
            0.53586394, 0.53793013, 0.5402931, 0.53570783, 0.5374214,
            0.5358713], [0.53677726, 0.5366743, 0.5367682, 0.53898376,
            0.54088396, 0.53684187, 0.53876793, 0.5367805], [0.5378172,
            0.53765976, 0.53772336, 0.5391908, 0.54242736, 0.53818583,
            0.5397577, 0.5377248], [0.5391313, 0.5386851, 0.5386931, 0.5408177,
            0.5436604, 0.539696, 0.54088926, 0.5379754], [0.54058385,
            0.53966635, 0.53967947, 0.5417627, 0.54506886, 0.541458, 0.5417585,
            0.53967893]],
        "final_obs": [[0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.0,
            0.0078125, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0, 0.4, 0.96875,
            0.03125, 0.9, 1.0, 0.0, 0.0, 0.0, 0.0, 0.9959263, 0.99553573,
            0.997115, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414, 0.9936537,
            1.0, 0.00390625, 0.00390625, 1.0, 0.0027777778, 0.5, 0.16966723,
            0.0, 0.4, 1.0, 0.0, 0.9, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0,
            0.99996334, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.062811, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.2916667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.6666667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.017452406,
            0.9998477, 1.3157414, 0.9936537, 1.0, 0.00390625, 0.00390625, 1.0,
            0.0027777778, 0.5, 0.16966723, 0.0, 0.4, 1.0, 0.0, 0.9, 1.0, 0.0,
            0.0, 0.0, 0.0, 0.99905133, 1.0, 0.99996334, 1.0, 0.0, 1.0, 1.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.062811, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.312406, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.2916667, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0781015,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6666667, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0], [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0,
            0.02734375, 0.00390625, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0,
            0.4, 0.96875, 0.03125, 0.84999996, 1.0, 0.0, 0.0, 0.0, 0.0,
            0.9991071, 0.99553573, 0.99951744, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 0.0, 0.061795957, 0.044301696, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.0,
            0.42749566, 0.5, 0.22337508, 0.12651713, 0.34126368, 0.31787887,
            0.5, 0.0, 0.0625, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625, 0.0,
            0.22916667, 0.0625, 0.4375, 0.3541667, 0.39583334, 0.083333336,
            0.25, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.0, 0.026718479,
            0.03125, 0.013960943, 0.031629283, 0.08531592, 0.01986743, 0.03125,
            0.0, 1.0, 1.0, 1.0, 0.66071427, 0.66071427, 1.0, 0.6666667, 0.0],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.01953125,
            0.01171875, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0, 0.4, 0.96875,
            0.03125, 0.95, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99547994, 0.99107146,
            0.9968352, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.053674124, 0.046766467, 0.026392212, 0.017972425, 0.00853116,
            0.0, 0.0, 0.0, 0.42290732, 0.5, 0.5, 0.5, 0.5, 0.0, 0.0, 0.0,
            0.0625, 0.0625, 0.0625, 0.0625, 0.0625, 0.0, 0.0, 0.0, 0.39583334,
            0.39583334, 0.20833334, 0.4375, 0.4375, 0.0, 0.0, 0.0, 0.0, 1.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.026431708, 0.03125, 0.03125,
            0.03125, 0.03125, 0.0, 0.0, 0.0, 0.9985119, 0.66071427, 0.9985119,
            0.9985119, 0.9985119, 0.0, 0.0, 0.0], [0.017452406, 0.9998477,
            1.3157414, 0.9936537, 1.0, 0.015625, 0.01953125, 1.0, 0.0027777778,
            0.5, 0.1714532, 0.0, 0.4, 0.96875, 0.03125, 0.9, 1.0, 0.0, 0.0,
            0.0, 0.0, 0.99637276, 0.9933036, 0.99807686, 1.0, 0.0, 1.0, 1.0,
            1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.06393188, 0.0486698,
            0.016758198, 0.01148193, 0.0, 0.0, 0.0, 0.0, 0.5, 0.12621523, 0.5,
            0.5, 0.0, 0.0, 0.0, 0.0, 0.0625, 0.125, 0.125, 0.125, 0.0, 0.0,
            0.0, 0.0, 0.4375, 0.125, 0.20833334, 0.27083334, 0.0, 0.0, 0.0,
            0.0, 0.0, 1.0, 1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.03125, 0.015776904,
            0.0625, 0.0625, 0.0, 0.0, 0.0, 0.0, 0.9985119, 0.66071427,
            0.66071427, 0.6636905, 0.0, 0.0, 0.0, 0.0], [0.017452406,
            0.9998477, 1.3157414, 0.9936537, 1.0, 0.0234375, 0.0078125, 1.0,
            0.0027777778, 0.5, 0.16966723, 0.0, 0.4, 1.0, 0.0, 0.9, 1.0, 0.0,
            0.0, 0.0, 0.0, 0.99893975, 0.99553573, 0.99930847, 1.0, 0.0, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.061795957, 0.016799843,
            0.012506172, 0.009283227, 0.0038513946, 0.0025689784, 0.0, 0.0,
            0.42749566, 0.22337508, 0.12651713, 0.34126368, 0.31787887, 0.5,
            0.0, 0.0, 0.0625, 0.0625, 0.25, 0.25, 0.0625, 0.0625, 0.0, 0.0,
            0.22916667, 0.4375, 0.3541667, 0.39583334, 0.083333336, 0.25, 0.0,
            0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.0, 0.0, 0.026718479,
            0.013960943, 0.031629283, 0.08531592, 0.01986743, 0.03125, 0.0,
            0.0, 1.0, 1.0, 0.66071427, 0.66071427, 1.0, 0.6666667, 0.0, 0.0],
            [0.017452406, 0.9998477, 1.3157414, 0.9936537, 1.0, 0.00390625,
            0.00390625, 1.0, 0.0027777778, 0.5, 0.1714532, 0.0, 0.4, 0.96875,
            0.03125, 0.9, 1.0, 0.0, 0.0, 0.0, 0.0, 0.99905133, 1.0, 0.99996334,
            1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.062811,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.312406, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.2916667,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0781015, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6666667,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
        "digest_jstate": [823, 821, 821, 821, 827, 845, 824, 821],
        "digest_placement": [-8390465, -8390655, -8390655, -8390626, -8390560,
            -8389488, -8390593, -8390655],
        "digest_n_nodes": [1490, 1490, 1490, 1381, 1370, 1395, 1381, 1490],
        "digest_workload": [1, 1, 1, 3, 0, 2, 3, 1],
        "n_completed": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        "past_queued": 64,
    },
}


# Distributed PPO (``rl.distributed``): ``rl_tx_gaia``'s env (per tick),
# 8 environments in W contiguous blocks of a fleet mesh, ``compress=True``,
# RL_ITERATIONS iterations. ``run_ppo_dist`` keeps a rank's iteration-0
# rollout from the training run itself (``on_rollout``);
# ``check_ppo_dist`` holds it and every iteration's stats to
# ``PINNED_RL_DIST[W]``.
# a single gradient step a iteration evaluates the loss at ratio 1, where
# pg_loss (the mean of normalised advantages) and approx_kl (the mean of
# old minus new log-probabilities) are zero but for rounding: held to an
# absolute tolerance
RATIO_ONE_STATS, RATIO_ONE_ATOL = ("pg_loss", "approx_kl"), 1e-6
RL_ROLLOUT_STATS = ("mean_reward", "mean_episode_return", "mean_episode_len",
                    "mean_value")


def run_ppo_dist(env, mesh, guard=None,
                 n_iterations: int = RL_ITERATIONS) -> dict:
    """The distributed ``ppo`` case on one rank of ``mesh`` (call it on
    every rank, ``env`` on the rank's device):
    ``distributed_ppo_train(seed=RL_SEED, compress=True)`` inside
    ``guard()`` when one is given, its iteration-0 rollout kept. Returns
    ``check_ppo_dist``'s form and the trained parameters."""
    import contextlib

    from repro_torch.rl import PPOConfig
    from repro_torch.rl.distributed import distributed_ppo_train

    guard = guard or contextlib.nullcontext
    first = {}

    def keep(iteration, batch):
        if iteration == 0:
            first["batch"] = batch

    with guard():
        params, history = distributed_ppo_train(
            env, mesh, cfg=PPOConfig(n_envs=RL_ENVS, rollout_len=RL_ROLLOUT),
            n_iterations=n_iterations, seed=RL_SEED, compress=True,
            on_rollout=keep)
    batch = first["batch"]
    return {"actions0": batch.action.cpu().numpy().tolist(),
            "mean_reward0": float(batch.reward.mean()),
            "mean_value0": float(batch.value.mean()),
            "history": history}, params


def check_ppo_dist(got: dict, world: int, rank: int,
                   pins: dict | None = None) -> dict:
    """Hold rank ``rank`` of a distributed PPO run of ``world`` ranks to
    ``PINNED_RL_DIST[world]``: its iteration-0 actions exactly, its
    rollout's mean reward and value within ``RTOL``; iteration 0's rollout
    stats within ``RTOL``, its loss stats and every later iteration's
    stats (after the compressed updates) within ``RL_STATS_RTOL``
    (``RATIO_ONE_STATS``, zero but for rounding, within
    ``RATIO_ONE_ATOL``). Raises on a miss; returns the largest errors."""
    pins = PINNED_RL_DIST[world] if pins is None else pins
    a, w = np.asarray(got["actions0"]), np.asarray(pins["actions0"][rank])
    if not np.array_equal(a, w):
        raise AssertionError(f"ppo_dist W={world} rank {rank}: iteration "
                             f"0's actions differ at "
                             f"{np.argwhere(a != w).tolist()[:8]}")
    out = {}
    for f in ("mean_reward0", "mean_value0"):
        rel = abs(got[f] - pins[f][rank]) / abs(pins[f][rank])
        out[f"rel_err_{f}"] = rel
        if rel > RTOL:
            raise AssertionError(f"ppo_dist W={world} rank {rank}: {f} "
                                 f"{got[f]!r} vs {pins[f][rank]!r}")
    if len(got["history"]) != len(pins["history"]):
        raise AssertionError("ppo_dist: iteration counts differ")
    for i, (gs, ws) in enumerate(zip(got["history"], pins["history"])):
        if set(gs) != set(ws):
            raise AssertionError(f"ppo_dist: stat keys {sorted(gs)}")
        worst = zero = 0.0
        for k, v in ws.items():
            if k in RATIO_ONE_STATS:
                zero = max(zero, abs(gs[k] - v))
                bad = abs(gs[k] - v) > RATIO_ONE_ATOL
            else:
                rel = abs(gs[k] - v) / max(abs(v), 1e-30)
                worst = max(worst, rel)
                bad = rel > (RTOL if i == 0 and k in RL_ROLLOUT_STATS
                             else RL_STATS_RTOL)
            if bad:
                raise AssertionError(
                    f"ppo_dist W={world} rank {rank}: iteration {i} {k} "
                    f"{gs[k]!r} vs pinned {v!r}")
        out[f"max_rel_err_stats_{i}"] = worst
        out[f"abs_err_ratio_one_{i}"] = zero
    return out


# ``PINNED_RL_DIST``: the JAX package's ``distributed_ppo_train`` on
# ``rl_tx_gaia`` (``SchedEnv(macro=False)``, 8 environments,
# ``compress=True``) at 1 and 2 fake host devices of the CPU (jax 0.9.0):
# each rank's iteration-0 actions, mean reward and mean value, and the
# stats of RL_ITERATIONS iterations; made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_mesh_pins.py
# (44 s on 8 cores).
PINNED_RL_DIST = {
    1: {
        "actions0": [[[5, 2, 2, 4, 2, 6, 2, 8], [7, 4, 4, 4, 5, 7, 5, 7], [2,
            2, 8, 2, 3, 3, 6, 3], [3, 4, 2, 0, 1, 8, 0, 2], [2, 1, 1, 1, 2, 3,
            8, 7], [1, 2, 0, 6, 2, 3, 6, 0], [1, 6, 1, 3, 5, 0, 1, 4], [2, 0,
            8, 8, 4, 8, 7, 6], [8, 1, 8, 8, 4, 6, 2, 3], [0, 1, 7, 8, 6, 3, 3,
            5], [8, 1, 2, 8, 0, 1, 1, 5], [2, 3, 1, 3, 7, 4, 8, 3], [5, 6, 0,
            2, 0, 7, 1, 6], [7, 4, 5, 2, 3, 7, 5, 4], [4, 4, 1, 0, 4, 5, 1, 7],
            [4, 8, 8, 2, 7, 8, 8, 7], [7, 4, 0, 7, 6, 7, 0, 1], [5, 5, 2, 1, 8,
            0, 4, 0], [5, 7, 6, 1, 6, 7, 3, 5], [1, 2, 1, 2, 4, 2, 6, 8], [0,
            4, 0, 7, 6, 4, 4, 2], [4, 0, 0, 3, 5, 1, 1, 5], [0, 8, 7, 7, 2, 3,
            0, 5], [5, 8, 7, 8, 6, 2, 1, 5], [2, 0, 0, 0, 2, 2, 6, 3], [4, 7,
            6, 0, 7, 8, 0, 7], [0, 4, 6, 6, 1, 7, 5, 7], [1, 1, 3, 1, 3, 2, 2,
            7], [5, 0, 7, 0, 2, 0, 5, 5], [7, 7, 6, 0, 8, 5, 4, 5], [6, 3, 7,
            8, 0, 8, 1, 5], [8, 8, 3, 3, 5, 1, 3, 0]]],
        "mean_reward0": [-3.1805367],
        "mean_value0": [-0.1159697],
        "history": [{"approx_kl": 0.0, "entropy": 2.1963828, "loss": 274.6612,
            "mean_episode_len": 32.0, "mean_episode_return": -101.77716,
            "mean_reward": -3.1805367, "mean_value": -0.1159697, "pg_loss":
            1.0430813e-07, "v_loss": 549.36633}, {"approx_kl": 0.0, "entropy":
            2.196068, "loss": 271.37958, "mean_episode_len": 32.0,
            "mean_episode_return": -101.45528, "mean_reward": -3.1704774,
            "mean_value": -0.30983797, "pg_loss": 1.7881393e-07, "v_loss":
            542.8031}],
    },
    2: {
        "actions0": [[[5, 2, 2, 4], [7, 4, 4, 4], [2, 2, 8, 2], [3, 4, 2, 0],
            [2, 1, 1, 1], [1, 2, 0, 6], [1, 6, 1, 3], [2, 0, 8, 8], [8, 1, 8,
            8], [0, 1, 7, 8], [8, 1, 2, 8], [2, 3, 1, 3], [5, 6, 0, 2], [7, 4,
            5, 2], [4, 4, 1, 0], [4, 8, 8, 2], [7, 4, 0, 7], [5, 5, 2, 1], [5,
            7, 6, 1], [1, 2, 1, 2], [0, 4, 0, 7], [4, 0, 0, 3], [0, 8, 7, 7],
            [5, 8, 7, 8], [2, 0, 0, 0], [4, 7, 6, 0], [0, 4, 6, 6], [1, 1, 3,
            1], [5, 0, 7, 0], [7, 7, 6, 0], [6, 3, 7, 8], [8, 8, 3, 3]], [[4,
            1, 3, 0], [2, 2, 0, 4], [5, 0, 2, 0], [1, 4, 5, 3], [7, 6, 5, 4],
            [0, 7, 0, 7], [6, 2, 2, 7], [7, 3, 2, 2], [5, 3, 3, 0], [3, 5, 3,
            6], [6, 1, 1, 6], [4, 3, 6, 5], [5, 4, 2, 0], [7, 2, 6, 0], [4, 1,
            1, 4], [8, 1, 5, 3], [6, 5, 1, 3], [4, 8, 1, 6], [8, 5, 3, 7], [5,
            1, 5, 2], [0, 6, 7, 6], [7, 2, 7, 2], [1, 2, 7, 0], [3, 1, 3, 6],
            [5, 5, 8, 6], [1, 0, 8, 3], [6, 3, 1, 2], [6, 2, 7, 7], [1, 6, 7,
            4], [7, 2, 5, 6], [1, 6, 7, 8], [2, 8, 8, 2]]],
        "mean_reward0": [-3.1779506, -3.175841],
        "mean_value0": [-0.12042669, -0.12277031],
        "history": [{"approx_kl": 0.0, "entropy": 2.1963997, "loss": 273.91754,
            "mean_episode_len": 32.0, "mean_episode_return": -101.66066,
            "mean_reward": -3.1768959, "mean_value": -0.1215985, "pg_loss":
            4.4703484e-08, "v_loss": 547.879}, {"approx_kl": 0.0, "entropy":
            2.1960034, "loss": 271.8974, "mean_episode_len": 32.0,
            "mean_episode_return": -101.56404, "mean_reward": -3.1738758,
            "mean_value": -0.32165837, "pg_loss": 0.0, "v_loss": 543.83875}],
    },
}


# ---------------------------------------------------------------------------
# The virtual cloud: the JAX package's ``examples/virtual_cloud.py``. The
# perf model turns LM jobs of VIRTUAL_CLOUD_ARCHS into a twin workload
# (``perfmodel.lm_jobs_workload``: 32 jobs over an hour, seed 7) on
# ``tx_gaia(max_jobs=64, max_nodes_per_job=16)``; the twin answers five
# what-ifs (config overrides), VIRTUAL_CLOUD_TICKS ticks of "easy" each,
# all on the one workload. ``PINNED_VIRTUAL_CLOUD`` holds what the JAX
# package's ``run_episode(..., summary_only=True)`` + ``summary(state,
# telemetry)`` give for two of them on the CPU (jax 0.9.0), and the
# sha256 of the workload's arrays (``workload_digest``), made by
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_perfmodel_pins.py
VIRTUAL_CLOUD_ARCHS = ("qwen3-4b", "mixtral-8x22b", "gemma3-1b",
                       "granite-3-8b")
VIRTUAL_CLOUD_JOBS = dict(n_jobs=32, horizon_s=3600.0, seed=7)
VIRTUAL_CLOUD_TICKS = 5400
VIRTUAL_CLOUD_SCHEDULER = "easy"
VIRTUAL_CLOUD_WHAT_IFS = {
    "baseline": {},
    "hot day (+8C wetbulb)": {"wetbulb_mean_c": 24.0},
    "smart rectifiers": {"rect_eff_peak": 0.985, "rect_eff_curv": 0.04},
    "degraded network": {"bisection_gbps": 200.0, "congestion_knee": 0.2},
    "demand response 300kW": {"power_cap_w": 300_000.0},
}
VIRTUAL_CLOUD_PINNED = ("baseline", "demand response 300kW")


def virtual_cloud_config(scenario: str = "baseline") -> SimConfig:
    return tx_gaia(max_jobs=64, max_nodes_per_job=16,
                   **VIRTUAL_CLOUD_WHAT_IFS[scenario])


def virtual_cloud_workload(cfg: SimConfig | None = None):
    """(jobs, trace bank) of the virtual cloud on ``cfg`` (default: the
    baseline config; the what-ifs change nothing the workload reads)."""
    from repro_torch.perfmodel import lm_jobs_workload

    return lm_jobs_workload(cfg or virtual_cloud_config(),
                            list(VIRTUAL_CLOUD_ARCHS), **VIRTUAL_CLOUD_JOBS)


def workload_digest(jobs: dict, bank: dict) -> str:
    """sha256 over the jobs' and then the bank's arrays, each key's name,
    dtype, shape and bytes in sorted key order."""
    h = hashlib.sha256()
    for part in (jobs, bank):
        for k in sorted(part):
            a = np.ascontiguousarray(part[k])
            h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def check_virtual_cloud(scenario: str, got: dict,
                        pins: dict | None = None) -> dict:
    """Raise unless the summary ``got`` meets the scenario's pins:
    ``completed`` exactly, every other value within ``RTOL``. Returns the
    largest relative error."""
    pins = (PINNED_VIRTUAL_CLOUD if pins is None else pins)[scenario]
    if got["completed"] != pins["completed"]:
        raise AssertionError(f"virtual cloud {scenario}: completed "
                             f"{got['completed']} != pinned "
                             f"{pins['completed']}")
    worst = 0.0
    for k, v in pins.items():
        err = abs(got[k] - v)
        if err > RTOL * abs(v):
            raise AssertionError(f"virtual cloud {scenario}: {k} "
                                 f"{got[k]!r} vs pinned {v!r} (rtol {RTOL})")
        if v:
            worst = max(worst, err / abs(v))
    return {"max_rel_err": worst, "keys": len(pins)}
PINNED_VIRTUAL_CLOUD = {
    "digest": "224fd4db4b796f9b9a6d025d2445e2044e601050607d9d3f9196c9bbaa3c1bf1",
    "baseline": {
        "t_end_s": 5400.0,
        "completed": 4.0,
        "killed_by_failures": 0.0,
        "energy_kwh": 429.7662353515625,
        "it_energy_kwh": 342.8932189941406,
        "loss_energy_kwh": 23.924007415771484,
        "cooling_energy_kwh": 62.94816207885742,
        "carbon_kg": 213.5205535888672,
        "elec_cost_usd": 43.85024642944336,
        "mean_power_w": 286510.08,
        "mean_wait_s": 0.5325202941894531,
        "mean_slowdown": 1.0008876323699951,
        "gflops_per_watt": 4.276538597383907,
        "avg_pue": 1.253352972719202,
        "peak_rack_outlet_c": 14.0,
        "thermal_throttle_s": 0.0,
        "lost_node_seconds": 0.0,
        "jobs_failed_terminal": 0.0,
        "goodput_node_s": 18295.223388671875,
        "goodput_frac": 1.0,
        "srv_arrived": 0.0,
        "srv_completed": 0.0,
        "srv_shed": 0.0,
        "srv_dropped": 0.0,
        "srv_retried": 0.0,
        "srv_mean_latency_s": 0.0,
        "srv_slo_violation_frac": 0.0,
        "srv_goodput_requests": 0.0,
        "srv_p50_latency_x_slo": 0.0,
        "srv_p99_latency_x_slo": 0.0,
        "ticks_simulated": 5400.0,
        "macro_steps_taken": 5400.0,
        "macro_skip_ratio": 1.0,
        "mean_cop": 5.827758312225342,
        "max_rack_outlet_c": 14.0,
    },
    "demand response 300kW": {
        "t_end_s": 5400.0,
        "completed": 4.0,
        "killed_by_failures": 0.0,
        "energy_kwh": 429.7487487792969,
        "it_energy_kwh": 342.8797607421875,
        "loss_energy_kwh": 23.92306900024414,
        "cooling_energy_kwh": 62.945709228515625,
        "carbon_kg": 213.51223754882812,
        "elec_cost_usd": 43.848541259765625,
        "mean_power_w": 286498.82074074075,
        "mean_wait_s": 0.5325202941894531,
        "mean_slowdown": 1.0008876323699951,
        "gflops_per_watt": 4.275668155449717,
        "avg_pue": 1.2533511684943879,
        "peak_rack_outlet_c": 14.0,
        "thermal_throttle_s": 0.0,
        "lost_node_seconds": 0.0,
        "jobs_failed_terminal": 0.0,
        "goodput_node_s": 18295.223388671875,
        "goodput_frac": 1.0,
        "srv_arrived": 0.0,
        "srv_completed": 0.0,
        "srv_shed": 0.0,
        "srv_dropped": 0.0,
        "srv_retried": 0.0,
        "srv_mean_latency_s": 0.0,
        "srv_slo_violation_frac": 0.0,
        "srv_goodput_requests": 0.0,
        "srv_p50_latency_x_slo": 0.0,
        "srv_p99_latency_x_slo": 0.0,
        "ticks_simulated": 5400.0,
        "macro_steps_taken": 5400.0,
        "macro_skip_ratio": 1.0,
        "mean_cop": 5.827758312225342,
        "max_rack_outlet_c": 14.0,
    },
}


# ---------------------------------------------------------------------------
# The dry-run (``launch/dryrun.py``): the JAX package's records of two
# cells, made by its own dry-run on 256 fake XLA devices with jax 0.9.0 on
# the CPU (``tests/torch_dryrun_pins.py``). ``memory.argument_bytes`` (the
# step's inputs on one device) is what the port's record must equal: the
# port lays every input out by the same specs, and no pinned leaf splits
# unevenly, so XLA pads nothing there. ``output_bytes``, ``temp_bytes``,
# the FLOPs and the collectives differ by design (DTensor and GSPMD lay the
# step out differently) and are recorded, not held.
DRYRUN_CELLS = (("gemma3-1b", "train_4k", "single"),
                ("qwen3-4b", "decode_32k", "single"))
# the cells ``chip_smoke.py``'s phase dryrun traces on the card's host, and
# the fields of each that need no trace as the JAX package's functions give
# them (``shape_applicable``, ``count_params_analytic``,
# ``default_optimizer_for``; ``tests/torch_dryrun_pins.py`` prints them)
DRYRUN_CHIP_CELLS = (("gemma3-1b", "train_4k", "single"),
                     ("gemma3-1b", "prefill_32k", "single"),
                     ("gemma3-1b", "decode_32k", "single"),
                     ("gemma3-1b", "long_500k", "single"),
                     ("mixtral-8x22b", "train_4k", "single"),
                     ("gemma3-1b", "train_4k", "multi"))
# the record's keys in the JAX package (the port's add "chip")
DRYRUN_KEYS = (
    "active_params_b", "arch", "collective_bytes_per_dev", "collective_s",
    "collectives", "compile_s", "compute_s", "ctx", "dominant",
    "hlo_bytes_per_dev", "hlo_flops_per_dev", "lower_s", "memory",
    "memory_s", "mesh", "microbatches", "model_flops_ratio",
    "model_flops_total", "n_chips", "optimizer", "params_b", "probe",
    "raw_cost_analysis", "shape", "status", "tokens_per_step",
)
PINNED_DRYRUN = {
    "gemma3-1b__train_4k__single": {
        "memory": {"argument_bytes": 48280068, "output_bytes": 47758008,
                   "temp_bytes": 12127176640, "alias_bytes": 47755780},
        "status": "OK",
        "n_chips": 256,
        "optimizer": "adamw",
        "params_b": 0.999826048,
        "active_params_b": 0.999826048,
        "tokens_per_step": 1048576.0,
        "model_flops_total": 6290361588645888.0,
    },
    "qwen3-4b__decode_32k__single": {
        "memory": {"argument_bytes": 2447735332, "output_bytes": 2416223000,
                   "temp_bytes": 6389587312, "alias_bytes": 2415919104},
        "status": "OK",
        "n_chips": 256,
        "optimizer": "adamw",
        "params_b": 4.022468096,
        "active_params_b": 4.022468096,
        "tokens_per_step": 128.0,
        "model_flops_total": 1029751832576.0,
    },
}
PINNED_DRYRUN_FIELDS = {
    "gemma3-1b__train_4k__single": {
        "status": "OK", "n_chips": 256, "optimizer": "adamw",
        "params_b": 0.999826048, "active_params_b": 0.999826048,
        "tokens_per_step": 1048576.0,
        "model_flops_total": 6290361588645888.0,
    },
    "gemma3-1b__prefill_32k__single": {
        "status": "OK", "n_chips": 256, "optimizer": "adamw",
        "params_b": 0.999826048, "active_params_b": 0.999826048,
        "tokens_per_step": 1048576.0,
        "model_flops_total": 2096787196215296.0,
    },
    "gemma3-1b__decode_32k__single": {
        "status": "OK", "n_chips": 256, "optimizer": "adamw",
        "params_b": 0.999826048, "active_params_b": 0.999826048,
        "tokens_per_step": 128.0, "model_flops_total": 255955468288.0,
    },
    "gemma3-1b__long_500k__single": {
        "status": "OK", "n_chips": 256, "optimizer": "adamw",
        "params_b": 0.999826048, "active_params_b": 0.999826048,
        "tokens_per_step": 1.0, "model_flops_total": 1999652096.0,
    },
    "mixtral-8x22b__train_4k__single": {
        "status": "OK", "n_chips": 256, "optimizer": "adafactor",
        "params_b": 140.630071296, "active_params_b": 39.161468928,
        "tokens_per_step": 1048576.0,
        "model_flops_total": 2.4638265865587917e+17,
    },
    "gemma3-1b__train_4k__multi": {
        "status": "OK", "n_chips": 512, "optimizer": "adamw",
        "params_b": 0.999826048, "active_params_b": 0.999826048,
        "tokens_per_step": 1048576.0,
        "model_flops_total": 6290361588645888.0,
    },
}
