"""Where a tick's time goes on the card: the main path under torch.profiler.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick \
        [--case replay_tx_gaia_1h_thermal] [--ticks 100] [--replicas 72]
    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick \
        --case rl_tx_gaia [--replicas 8] [--decisions 4]
    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick --macro \
        [--case replay_tx_gaia_1h] [--ticks 600] [--replicas 72]
    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick \
        --case replay_tx_gaia_1h_faults [--macro]
    PYTHONPATH=src python3 -m repro_torch.tools.profile_tick \
        --case replay_tx_gaia_1h_serving [--macro]

Runs an acceptance case (``configs/acceptance.py``; default
``replay_tx_gaia_1h``) on the card up to tick ``--start`` (so jobs are
running), with ``--replicas E`` > 1 as a fleet of E replicas (the fleet
case's policy x scenario grid, ``acceptance.fleet_grid``, tiled to E),
then times ``--ticks`` more ticks twice: once on the host
clock around a synchronised loop, once under ``torch.profiler`` with CPU
and CUDA activities. Prints one JSON line: ms per tick, CUDA kernels per
tick (and launches of the port's own kernels per tick), the device's
busy share (sum of kernel times over the profiled wall time; the rest is
idle, waiting on the host), and the top CUDA kernels and host ops by
time. It also reports the CUDA launch calls per tick, and their share of
the tick's, of the fault engine (``core.faults.apply_faults``) and of the
serving twin's ladder, flow and power (``core.serving.apply_serving``,
``serving_flow``, ``serving_power``), each run inside a profiler range
(``ENGINE_RANGES``): zeros where the case runs none of them. A fault hour
(``acceptance.FAULT_CASES``) runs with the drill under its scenario, the
serving hour (``replay_tx_gaia_1h_serving``) under its traffic, its pool
half asleep. Needs a CUDA device.

With an RL case (``acceptance.RL_CASES``) it profiles one PPO iteration
of ``--replicas`` environments instead (``setup_rl``: a rollout of one
episode, ``RL_EPISODE_STEPS`` decisions, its auto-reset and the update)
and reports per env step: ms on the host clock, CUDA kernels, the
device's busy share, and the kernel launches of each stage (``rl_stages``:
sampling, key splits, the ``"rl"`` tick, the idle ticks, observe, reset,
update and the rest of the rollout), counted as the CUDA launch calls
inside each stage's ``record_function`` range. A stage is a function the
iteration calls; an operation counts for the outermost stage running.
``--decisions N`` profiles N decisions of the rollout alone instead.

``--macro`` macro-steps instead (``core.sim.make_macro_step``; the RL
env with ``macro=True``). For a replay case it runs ``--ticks``
simulated ticks after ``--start`` through the macro engine
(``profile_macro``) and reports host ms per simulated tick, the event
and fast ticks issued, the host reads per macro step, and the CUDA
launch calls per event tick and per fast tick (inside each kind's
``record_function`` range; the rest, per macro step, is the loop's own:
the reads' reductions).

``episode_launch_calls`` (a function, no flag) counts the CUDA launch
calls of a tick inside ``run_episode(summary_only=True)`` against a bare
``make_step`` + telemetry loop of the same ticks.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import time


def device_summary(prof, wall_us: float, per: int, top: int) -> dict:
    """What a ``torch.profiler`` run over ``per`` repetitions (ticks, decode
    steps) spent on the card, per repetition: CUDA kernels, device time,
    the device's busy share of the profiled wall time, the port's own
    kernels' device time, and the top kernels and host ops."""
    import torch

    from repro_torch import kernels as port_kernels

    from repro_torch.core import sim

    # the CUDA-side events, less the ranges ``record_function`` marks on
    # the device's timeline (the tools' stages, the macro engine's ticks;
    # a tree from before the macro engine has none of the latter)
    marks = tuple(getattr(sim, "TICK_RANGES", {}).values())
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(RANGE_PREFIX)
               and e.name not in marks]
    # a device event's own time range is the kernel's time on the card
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    host_ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    # the port's own kernels (csrc/<name>.cu: a kernel named <name>_kernel
    # or <name>_<variant>_kernel), by entry
    own = {}
    for name, (tot, n) in by_name.items():
        for k in port_kernels.LAUNCHES:
            found = re.search(rf"\b{k}_(\w+_)?kernel\b", name)
            if found:
                key = found.group(0)
                us, count = own.get(key, (0.0, 0))
                own[key] = (us + tot, count + n)
    return {
        "cuda_kernels": len(kernels) / per,
        "port_kernel_us": {
            k: sum(us for key, (us, _) in own.items()
                   if key.startswith(f"{k}_")) / per
            for k in port_kernels.LAUNCHES},
        "port_kernel_launches": {key: n / per
                                 for key, (_, n) in sorted(own.items())},
        "device_busy_share": (dev_us / wall_us) if kernels else None,
        "device_us": dev_us / per if kernels else None,
        "top_kernels_us": [[name[:80], tot / per, n / per]
                           for name, (tot, n) in top_dev],
        "top_host_ops_us": [[a.key, a.self_cpu_time_total / per,
                             a.count / per] for a in host_ops[:top]],
    }


def _advance(step, state, action, n):
    for _ in range(n):
        state, _ = step(state, action)
    return state


def case_inputs(case: str, device=None, replicas: int = 1):
    """(cfg, statics, state, policy) of an acceptance case
    (``configs/acceptance.py``) built on ``device`` (the card when
    ``None``) at tick 0; with ``replicas`` > 1, a fleet of that many
    replicas of the case under the fleet grid (``acceptance.fleet_grid``
    tiled, set up as ``run_fleet`` does)."""
    from repro_torch.configs import acceptance
    from repro_torch.core import build_statics, init_state, load_jobs

    cfg = acceptance.config(case)
    jobs, bank = acceptance.workload(cfg)
    scn = (acceptance.serving_scenario(cfg) if cfg.serving_on
           else acceptance.fault_scenario(case, cfg))
    statics = build_statics(cfg, bank, scn, device=device)
    state = load_jobs(init_state(cfg, statics, acceptance.SEED), jobs)
    if cfg.serving_on:
        state = acceptance.half_asleep(state)
    who = acceptance.SCHEDULER
    if replicas > 1:
        from repro_torch.core.fleet import prepare_fleet

        _, pol, scn = acceptance.fleet_grid(cfg, replicas)
        statics, state, who = prepare_fleet(cfg, statics, state,
                                            policies=pol, scenarios=scn)
    return cfg, statics, state, who


def setup_case(case: str, start: int, device=None, replicas: int = 1,
               macro: bool = False):
    """An acceptance case (``case_inputs``) run to tick ``start``: returns
    (step, state, action). With ``macro``, ``step`` is the case's macro
    step (``make_macro_step``; the state still reaches ``start`` tick by
    tick). Shared by the tick tools, so each reads the same tick."""
    import torch

    from repro_torch.core.sim import make_macro_step, make_step
    from repro_torch.utils.device import full

    cfg, statics, state, who = case_inputs(case, device, replicas)
    step = make_step(cfg, statics, who)
    action = full(-1, torch.int64, statics.capacity.device)
    state = _advance(step, state, action, start)
    if macro:
        step = make_macro_step(cfg, statics, who)
    return step, state, action


def setup_rl(case: str, replicas: int, device=None,
             rollout_len: int | None = None, macro: bool = False):
    """An RL case's ``SchedEnv`` on ``device`` (the card when ``None``;
    ``macro``: the macro env), a policy and one PPO iteration over
    ``replicas`` environments (``rollout_len`` decisions, default one
    episode), set up as ``ppo_train`` sets up: returns (env, policy,
    iteration, carry), where ``iteration(*carry, step)`` runs it."""
    import torch

    from repro_torch.configs import acceptance as A
    from repro_torch.envs import SchedEnv
    from repro_torch.rl import ActorCritic, PPOConfig
    from repro_torch.rl.ppo import _zero_ep, make_train_iteration
    from repro_torch.utils import prng
    from repro_torch.utils.device import to_device

    cfg = A.rl_config(case)
    kw = A.rl_env_kwargs(macro, case)
    if cfg.serving_on:
        kw["scenario"] = A.rl_scenario(case, cfg)
    env = SchedEnv(cfg, A.rl_workloads(cfg), device=device, **kw)
    ppo_cfg = PPOConfig(n_envs=replicas,
                        rollout_len=rollout_len or A.RL_EPISODE_STEPS)
    policy = ActorCritic(env.obs_dim, env.n_actions, device=env.device)
    iteration, opt = make_train_iteration(env, policy, ppo_cfg)
    key = to_device(torch.from_numpy(prng.key_words(A.RL_SEED)), env.device)
    key, kp, ke = prng.split(key, 3)
    params = policy.init(kp)
    states, obs = env.reset(prng.split(ke, replicas))
    carry = (params, opt.init(params), states, _zero_ep(obs[:, 0]), key)
    return env, policy, iteration, carry


RANGE_PREFIX = "rl_stage::"
# (module of ``core``, function): the engines whose launch calls a replay
# profile counts apart, each inside the profiler range RANGE_PREFIX + name
ENGINE_RANGES = (("faults", "apply_faults"), ("serving", "apply_serving"),
                 ("serving", "serving_flow"), ("serving", "serving_power"))


def engine_ranges():
    """Context manager: while it is open, each function of
    ``ENGINE_RANGES`` that the tree has runs inside the profiler range
    RANGE_PREFIX + its name."""
    import contextlib
    import importlib

    from torch.profiler import record_function

    def ranged(name, real):
        def run(*a, **kw):
            with record_function(RANGE_PREFIX + name):
                return real(*a, **kw)
        return run

    @contextlib.contextmanager
    def patched():
        saved = []
        for mod_name, name in ENGINE_RANGES:
            try:
                mod = importlib.import_module(f"repro_torch.core.{mod_name}")
            except ImportError:
                continue
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, ranged(name, saved[-1][2]))
        try:
            yield
        finally:
            for mod, name, real in saved:
                setattr(mod, name, real)
    return patched()


def launch_calls_in(events, name: str) -> tuple:
    """(CUDA launch calls in all, those inside the host ranges ``name``)
    of a profiler's events."""
    import torch

    host = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in host
             if e.name == name]
    launches = [e.time_range.start for e in host if "LaunchKernel" in e.name]
    inside = sum(any(a <= t <= b for a, b in spans) for t in launches)
    return len(launches), inside
RL_STAGES = ("sampling", "keys", "rl tick", "idle ticks", "observe",
             "reset", "update")


def rl_stages(env, policy, hook):
    """Context manager: while it is open, each stage of a PPO iteration
    (``RL_STAGES``) runs inside ``hook(stage)`` (a context manager), for
    the outermost stage only. The stages are the functions an iteration
    calls: ``policy.apply`` and ``prng.categorical`` (sampling; in the
    update, ``policy.apply`` is the update's), ``prng.split`` (keys), the
    env's ``"rl"`` and idle steps (a macro env's macro advance), ``observe``,
    ``reset``, and the update (GAE, ``permutation``, the loss and its
    gradients, clipping, AdamW)."""
    import contextlib

    from repro_torch.optim import AdamW
    from repro_torch.rl import ppo as P
    from repro_torch.utils import prng

    depth = [0]

    def staged(stage, fn):
        def run(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            try:
                with hook(stage):
                    return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    patches = [
        (env, "_step_rl", "rl tick"), (env, "_step_idle", "idle ticks"),
        (env, "observe", "observe"), (env, "reset", "reset"),
        (policy, "apply", "sampling"), (prng, "categorical", "sampling"),
        (prng, "split", "keys"), (prng, "permutation", "update"),
        (P, "gae", "update"), (P, "loss_and_grads", "update"),
        (P, "clip_by_global_norm", "update"), (AdamW, "update", "update")]
    if env.macro:
        patches.append((env._macro_idle, "run", "idle ticks"))

    @contextlib.contextmanager
    def patched():
        saved = []
        try:
            for obj, name, stage in patches:
                saved.append((obj, name, obj.__dict__.get(name)))
                # on a class the wrapper is a method too: self comes first
                setattr(obj, name, staged(stage, getattr(obj, name)))
            yield
        finally:
            for obj, name, old in reversed(saved):
                if old is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, old)

    return patched()


def telem_zero(cfg, state):
    """``sim._telem_zero`` for ``cfg``'s models, one per replica of
    ``state`` (a tree from before the serving twin takes no serving
    flag, and runs no serving case)."""
    from repro_torch.core import sim

    kw = dict(serving_on=True) if cfg.serving_on else {}
    return sim._telem_zero(state.t.device, tuple(state.t.shape),
                           cfg.resilience_on, **kw)


def profile_macro(case: str, start: int, ticks: int, replicas: int = 1,
                  top: int = 8) -> dict:
    """``ticks`` simulated ticks of a replay case after tick ``start``
    through its macro step on the card (``setup_case(..., macro=True)``;
    one untimed run first): host ms per simulated tick, the event and
    fast ticks issued and the host reads, then under ``torch.profiler``
    the CUDA launch calls per event tick and per fast tick and the
    device's time and busy share per simulated tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import sim
    from repro_torch.utils import device as D

    from repro_torch.configs import acceptance

    ms, state, _ = setup_case(case, start, replicas=replicas, macro=True)
    lead = tuple(state.t.shape)
    acc0 = telem_zero(acceptance.config(case), state)

    def run():
        return ms.run(state, acc0, ticks)

    run()                                                  # warm-up
    torch.cuda.synchronize()
    sim.reset_macro_ticks()
    D.reset_host_reads()
    t0 = time.perf_counter()
    _, acc = run()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / ticks
    issued = dict(sim.MACRO_TICKS)
    reads = D.HOST_READS["count"]
    committed = float(acc.n_steps.sum() - acc.macro_steps.sum())

    # the engine runs each tick inside its profiler range
    kinds = {name: f"{k} tick" for k, name in sim.TICK_RANGES.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = device_summary(prof, wall_us, ticks, top)
    events = list(prof.events())
    ranges = [(kinds[e.name], e.time_range.start, e.time_range.end)
              for e in events if e.name in kinds
              and e.device_type != torch.autograd.DeviceType.CUDA]
    by_kind = {"event tick": 0, "fast tick": 0, "macro loop": 0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                and "LaunchKernel" in e.name:
            t = e.time_range.start
            by_kind[next((k for k, a, b in ranges if a <= t <= b),
                         "macro loop")] += 1
    return {
        "case": case, "replicas": replicas, "start_tick": start,
        "ticks": ticks, "ms_per_simulated_tick": host_ms,
        "event_ticks": issued["event"], "fast_ticks_issued": issued["fast"],
        "fast_replica_ticks_committed": committed,
        "fast_replica_ticks_masked": issued["fast"] * math.prod(lead)
        - committed,
        "host_reads": reads,
        "host_reads_per_macro_step": reads / max(issued["event"], 1),
        "launch_calls_per_event_tick":
            by_kind["event tick"] / max(issued["event"], 1),
        "launch_calls_per_fast_tick":
            by_kind["fast tick"] / max(issued["fast"], 1),
        "loop_launch_calls_per_macro_step":
            by_kind["macro loop"] / max(issued["event"], 1),
        **{k if k == "device_busy_share" else f"{k}_per_simulated_tick": v
           for k, v in summary.items()}}


def profile_rl(case: str, replicas: int, top: int = 8,
               decisions: int | None = None, macro: bool = False) -> dict:
    """One PPO iteration of an RL case over ``replicas`` environments on
    the card (after a warm-up iteration): host ms per env step, then
    under ``torch.profiler`` CUDA kernels, device time and busy share per
    env step, and the CUDA launch calls of each stage per env step. With
    ``decisions``, that many decisions of the rollout alone instead (no
    update, no reset): the profiler's own processing grows with the
    events, ~3 s a decision."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import kernels as port_kernels
    from repro_torch.configs import acceptance as A
    from repro_torch.rl import PPOConfig
    from repro_torch.rl.ppo import make_rollout

    from repro_torch.utils import device as D

    env, policy, iteration, carry = setup_rl(case, replicas, macro=macro)
    step0 = torch.zeros((), dtype=torch.int32, device=env.device)
    carry = iteration(*carry, step0)[:5]                 # warm-up
    if decisions is None:
        steps = A.RL_EPISODE_STEPS

        def run(c):
            return iteration(*c, step0)[:5]
    else:
        steps = decisions
        rollout = make_rollout(env, policy, PPOConfig(
            n_envs=replicas, rollout_len=decisions))

        def run(c):
            params, opt_state, states, ep, key = c
            states, _, _, ep = rollout(params, states, key, ep)
            return params, opt_state, states, ep, key
    torch.cuda.synchronize()
    D.reset_host_reads()
    t0 = time.perf_counter()
    carry2 = run(carry)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    reads = D.HOST_READS["count"]

    def hook(stage):
        return record_function(RANGE_PREFIX + stage)

    port_kernels.reset_launches()
    with rl_stages(env, policy, hook), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(carry2)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    summary = device_summary(prof, wall_us, steps, top)
    events = list(prof.events())
    ranges = [(e.name.split("::", 1)[1], e.time_range.start,
               e.time_range.end) for e in events
              if e.name.startswith(RANGE_PREFIX)
              and e.device_type != torch.autograd.DeviceType.CUDA]
    launches = [e.time_range.start for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA
                and "LaunchKernel" in e.name]
    by_stage = {s: 0 for s in RL_STAGES}
    by_stage["rest of the rollout"] = 0
    for t in launches:
        stage = next((s for s, a, b in ranges if a <= t <= b),
                     "rest of the rollout")
        by_stage[stage] += 1
    return {"case": case, "replicas": replicas, "env_steps": steps,
            "what": "iteration" if decisions is None else "rollout",
            "macro": env.macro, "ms_per_env_step": host_ms,
            "host_reads_per_env_step": reads / steps,
            "ms_per_env_step_profiled": wall_us / 1e3 / steps,
            "port_kernel_launches_per_env_step": {
                k: v / steps for k, v in port_kernels.LAUNCHES.items()},
            "launch_calls_per_env_step": len(launches) / steps,
            "launch_calls_by_stage_per_env_step": {
                k: v / steps for k, v in by_stage.items()},
            **{k if k == "device_busy_share" else f"{k}_per_env_step": v
               for k, v in summary.items()}}


def profile_replay(case: str, start: int, ticks: int, replicas: int = 1,
                   top: int = 12) -> dict:
    """``ticks`` ticks of a replay case after tick ``start`` on the card
    (``setup_case``): host ms per tick on a synchronised loop, then under
    ``torch.profiler`` CUDA kernels, device time and busy share per tick,
    the launches of the port's kernels, and the CUDA launch calls of each
    engine of ``ENGINE_RANGES`` and their share of the tick's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as port_kernels

    step, state, action = setup_case(case, start, replicas=replicas)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    _advance(step, state, action, ticks)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / ticks

    port_kernels.reset_launches()
    with engine_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _advance(step, state, action, ticks)
        torch.cuda.synchronize()
        prof_wall_us = 1e6 * (time.perf_counter() - t0)

    summary = device_summary(prof, prof_wall_us, ticks, top)
    events = list(prof.events())
    engines = {}
    for _, name in ENGINE_RANGES:
        calls, inside = launch_calls_in(events, RANGE_PREFIX + name)
        engines[f"{name}_launch_calls_per_tick"] = inside / ticks
        engines[f"{name}_launch_share"] = inside / max(calls, 1)
    return {
        "case": case, "replicas": replicas, "start_tick": start,
        "ticks": ticks, "device": torch.cuda.get_device_name(0),
        "ms_per_tick": host_ms,
        "us_per_replica_tick": 1e3 * host_ms / replicas,
        "ms_per_tick_profiled": prof_wall_us / 1e3 / ticks,
        "port_kernel_launches_per_tick": {
            k: v / ticks for k, v in port_kernels.LAUNCHES.items()},
        "launch_calls_per_tick": calls / ticks, **engines,
        **{k if k == "device_busy_share" else f"{k}_per_tick": v
           for k, v in summary.items()},
    }


def episode_launch_calls(case: str, start: int, ticks: int) -> dict:
    """CUDA launch calls a tick of ``run_episode(summary_only=True)`` from
    tick ``start`` of a replay case on the card, against a bare loop of
    the same ticks (``make_step`` and the telemetry update: the episode's
    tick with nothing around it), and the bare loop's calls inside its
    ``make_step`` step (what ``profile_replay`` counts a tick). Each is the
    difference between windows of 2 x ``ticks`` and ``ticks`` ticks, over
    ``ticks``, so set-up and finalisation cancel. With ``REPRO_CHECKIFY``
    unset the first two are equal: the episode adds nothing to a tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import sim
    from repro_torch.utils.device import full

    cfg, statics, state, who = case_inputs(case)
    step = sim.make_step(cfg, statics, who)
    action = full(-1, torch.int64, statics.capacity.device)
    state = _advance(step, state, action, start)
    dev, lead = state.t.device, tuple(state.t.shape)

    def bare(n):
        acc = sim._telem_zero(dev, lead, cfg.resilience_on, cfg.serving_on)
        s = state
        for _ in range(n):
            with record_function(RANGE_PREFIX + "step"):
                s, out = step(s, action)
            acc = sim._telem_update(acc, out)
        return s, sim._telem_finalize(acc)

    def episode(n):
        return sim.run_episode(cfg, statics, state, n, who,
                               summary_only=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in (("episode", episode), ("bare", bare)):
            for n in (ticks, 2 * ticks):
                with record_function(f"{RANGE_PREFIX}{name}_{n}"):
                    fn(n)
        torch.cuda.synchronize()
    events = list(prof.events())

    def inside(name):
        return launch_calls_in(events, RANGE_PREFIX + name)[1]

    def per_tick(name):
        return (inside(f"{name}_{2 * ticks}")
                - inside(f"{name}_{ticks}")) / ticks

    return {
        "case": case, "start_tick": start, "ticks": ticks,
        "episode_launch_calls_per_tick": per_tick("episode"),
        "bare_launch_calls_per_tick": per_tick("bare"),
        "step_launch_calls_per_tick": inside("step") / (3 * ticks),
    }


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import acceptance

    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="replay_tx_gaia_1h",
                    choices=sorted(acceptance.CASES)
                    + sorted(acceptance.FAULT_CASES)
                    + [acceptance.SERVING_CASE]
                    + sorted(acceptance.RL_CASES))
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--decisions", type=int, default=None,
                    help="RL cases: profile this many decisions of the "
                    "rollout instead of one whole iteration")
    ap.add_argument("--macro", action="store_true",
                    help="macro-step (replay: --ticks simulated ticks; "
                    "RL: the macro env)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: needs a CUDA device", file=sys.stderr)
        return 1
    if args.case in acceptance.RL_CASES:
        out = profile_rl(args.case, args.replicas, args.top,
                         args.decisions, args.macro)
        out["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
        return 0
    if args.macro:
        out = profile_macro(args.case, args.start, args.ticks,
                            args.replicas, args.top)
        out["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
        return 0

    out = profile_replay(args.case, args.start, args.ticks, args.replicas,
                         args.top)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
