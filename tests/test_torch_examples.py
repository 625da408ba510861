"""The port's examples (``repro_torch.examples``) on the CPU at reduced
size: what each prints is finite and equal to the same run made directly
through the port's entry points. Without a card, each example's ``main``
refuses to run unless ``--device cpu`` is given (no fallback)."""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import repro_torch.core as C
from repro_torch.configs import acceptance as A
from repro_torch.configs.sim import tiny_cluster
from repro_torch.data import synth_workload, write_supercloud_csvs
from repro_torch.envs import SchedEnv
from repro_torch.examples import (
    quickstart,
    replay_supercloud,
    rl_scheduler,
    scenario_sweep,
    virtual_cloud,
)
from repro_torch.perfmodel import lm_training_job
from repro_torch.rl import ActorCritic, PPOConfig, ppo_train
from repro_torch.utils import prng

EXAMPLES = ("quickstart", "replay_supercloud", "rl_scheduler",
            "scenario_sweep", "virtual_cloud")

torch.set_num_threads(1)


def _finite(values) -> None:
    for v in values:
        assert math.isfinite(v), values


def _direct(cfg, jobs, bank, n_steps, scheduler, **kw):
    statics = C.build_statics(cfg, bank, device="cpu")
    state = C.load_jobs(C.init_state(cfg, statics, 0), jobs)
    return C.run_episode(cfg, statics, state, n_steps, scheduler, **kw)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal without a card")
@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_the_card_or_an_explicit_device(name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_quickstart():
    cfg = tiny_cluster()
    s, power = quickstart.replay(cfg, 20, 200.0, 300, "cpu")
    _finite(list(s.values()) + list(power.values()))
    jobs, bank = synth_workload(cfg, n_jobs=20, horizon_s=200.0, seed=0)
    final, outs = _direct(cfg, jobs, bank, 300, "replay")
    assert s == C.summary(final)
    p = outs.facility_w
    assert power == {"peak_kw": float(p.max()) / 1e3,
                     "min_kw": float(p.min()) / 1e3,
                     "swing_kw": float(p.max() - p.min()) / 1e3}
    assert s["completed"] > 0 and power["swing_kw"] > 0


def test_replay_supercloud(tmp_path):
    cfg = tiny_cluster(max_jobs=32)
    write_supercloud_csvs(str(tmp_path), cfg, n_jobs=16, horizon_s=150.0,
                          seed=42)
    rows = replay_supercloud.compare_policies(cfg, str(tmp_path), 300, "cpu")
    assert list(rows) == list(replay_supercloud.SCHEDULERS)
    from repro_torch.data import load_supercloud

    jobs, bank = load_supercloud(str(tmp_path), cfg)
    for sched, s in rows.items():
        _finite(s.values())
        assert s == C.summary(_direct(cfg, jobs, bank, 300, sched)[0]), sched
        assert s["completed"] > 0


def test_rl_scheduler():
    cfg = tiny_cluster(sched_max_candidates=4)
    sizes = dict(n_workloads=2, n_jobs=12, horizon_s=300.0, episode_steps=4)
    env = rl_scheduler.make_env(cfg, "cpu", **sizes)
    lines = []
    params, returns = rl_scheduler.train(env, 2, n_envs=2, rollout_len=4,
                                         log=lines.append)
    assert len(returns) == len(lines) == 2
    _finite(returns)

    wls = [synth_workload(cfg, 12, 300.0, seed=s) for s in range(2)]
    env2 = SchedEnv(cfg, wls, episode_steps=4, sim_steps_per_action=15,
                    device="cpu")
    hist = []
    want, _ = ppo_train(env2, cfg=PPOConfig(n_envs=2, rollout_len=4,
                                            lr=3e-4),
                        n_iterations=2, log=lambda it, s: hist.append(
                            s["mean_episode_return"]))
    assert returns == hist
    assert sorted(params) == sorted(want)
    for k in want:
        assert torch.equal(params[k], want[k]), k

    got = rl_scheduler.evaluate_policy(env, params, prng.key_words(99),
                                       episodes=2)
    _finite(got)
    policy = ActorCritic(env2.obs_dim, env2.n_actions, device="cpu")
    totals = []
    for e in range(2):
        st, obs = env2.reset(prng.fold_in(prng.key_words(99), e))
        acc = np.zeros(4)
        for _ in range(env2.episode_steps):
            logits, _ = policy.apply(want, obs)
            st, obs, r, _, info = env2.step(st, torch.argmax(logits))
            acc += [float(r), float(info["energy_kwh"]),
                    float(info["carbon_kg"]), float(info["completed"])]
        totals.append(acc)
    np.testing.assert_array_equal(got, np.mean(totals, axis=0))

    rows = rl_scheduler.classical(cfg, wls[0], 60, "cpu")
    for sched, s in rows.items():
        _finite(s.values())
        assert s == C.summary(_direct(cfg, *wls[0], 60, sched)[0]), sched


def test_scenario_sweep():
    cfg = tiny_cluster()
    out = scenario_sweep.sweep(cfg, 120, ["fcfs", "easy"], ["first_fit"],
                               "cpu")
    assert [(p, s) for p, s, _, _ in out] == [
        (p, s) for p in ("fcfs+first_fit", "easy+first_fit")
        for s in ("diurnal", "solar_heavy", "carbon_trace",
                  "demand_response", "heatwave")]
    for _, _, row, peak_kw in out:
        _finite(list(row.values()) + [peak_kw])
    # each cell against the same policy and scenario run alone, from the
    # fleet's initial state (made under the default scenario)
    jobs, bank = synth_workload(cfg, 32, 120 * cfg.dt * 0.75, seed=0)
    scns = dict(scenario_sweep.build_scenarios(cfg, 120 * cfg.dt))
    statics = C.build_statics(cfg, bank, device="cpu")
    state = C.load_jobs(C.init_state(cfg, statics, 0), jobs)
    for pol, scn, row, peak_kw in out[::3]:
        sel, place = pol.split("+")
        alone = statics._replace(scenario=C.build_statics(
            cfg, bank, scenario=scns[scn], device="cpu").scenario)
        final, tel = C.run_episode(cfg, alone, state, 120, sel,
                                   placement=place, summary_only=True)
        want = C.summary(final)
        for k, v in row.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=0.0,
                                       err_msg=f"{pol}/{scn}: {k}")
        np.testing.assert_allclose(peak_kw, float(tel.max_facility_w) / 1e3,
                                   rtol=1e-5)


def test_virtual_cloud():
    jobs = virtual_cloud.lm_jobs()
    assert list(jobs) == ["qwen3-4b", "mixtral-8x22b", "gemma3-1b"]
    for arch, j in jobs.items():
        assert j == lm_training_job(arch, "train_4k", n_chips=64,
                                    token_budget=5e8)
        _finite([j["step_s"], j["duration_s"], j["gpu_util"],
                 j["net_tx_gbps"]])
    base = tiny_cluster(max_jobs=64)
    rows = virtual_cloud.what_ifs(base, 150, "cpu")
    assert list(rows) == list(A.VIRTUAL_CLOUD_WHAT_IFS)
    wl = A.virtual_cloud_workload(base)
    for name, s in rows.items():
        _finite(s.values())
        cfg = dataclasses.replace(base, **A.VIRTUAL_CLOUD_WHAT_IFS[name])
        assert s == C.summary(*_direct(cfg, *wl, 150, "easy",
                                       summary_only=True)), name
    assert rows["hot day (+8C wetbulb)"]["energy_kwh"] > \
        rows["baseline"]["energy_kwh"] > rows["smart rectifiers"]["energy_kwh"]
