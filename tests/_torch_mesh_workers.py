"""Rank programs of ``tests/test_torch_mesh.py``: each runs on every rank of
a gloo world on the CPU (``launch.mesh.spawn_world``) and returns what the
tests compare. Importable by name from the spawned processes, so it
imports no JAX; the inputs the JAX side must share (``psum_inputs``,
``fleet_case``) are plain numpy or the port's own builders of the same
seeded data.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

import repro_torch.configs.sim as pcfg
import repro_torch.core as C
from repro_torch import scenarios as PS
from repro_torch.checkpoint import restore_sharded, save_sharded
from repro_torch.core import fleet as PF
from repro_torch.data import synth_workload
from repro_torch.envs import SchedEnv
from repro_torch.optim.compress import compressed_psum, quantize_dequantize
from repro_torch.rl.distributed import distributed_ppo_train
from repro_torch.rl.ppo import PPOConfig
from repro_torch.sharding.specs import fleet_block
from repro_torch.utils.errors import CheckpointError, ConfigError

# gradient-like trees for the compressed all-reduce: the actor-critic's
# leaf names, a spread of scales per rank
PSUM_SHAPES = {"w0": (53, 16), "b0": (16,), "w_v": (16, 1)}

# the sharded fleet of tests/test_multidevice.py's bitwise case: thermals
# and faults on, macro-stepped, 12 sampled scenarios
FLEET_CFG = dict(thermal_enabled=True, node_mtbf_hours=0.5,
                 node_repair_hours=0.2, rack_mtbf_hours=1.5,
                 rack_repair_hours=0.3, ckpt_interval_s=240.0,
                 ckpt_overhead_s=20.0, max_job_retries=3)
FLEET_JOBS, FLEET_HORIZON, FLEET_SCENARIOS, FLEET_TICKS = 32, 900.0, 12, 400
FLEET_SNAP_S, FLEET_KEEP_TICKS = 100.0, 200
# tests/test_multidevice.py's thermal fleet: the trip is crossed
THERMAL_CFG = dict(thermal_enabled=True, rack_tau_s=120.0,
                   thermal_trip_c=22.0, throttle_start_c=20.0,
                   throttle_full_c=30.0)
THERMAL_JOBS, THERMAL_HORIZON, THERMAL_SCENARIOS = 24, 600.0, 8
THERMAL_TICKS = 400

# distributed PPO on tests/test_torch_ppo.py's env, per tick or macro
ENV_JOBS, ENV_HORIZON, ENV_WORKLOADS = 24, 900.0, 3
ENV_KW = dict(episode_steps=8, sim_steps_per_action=5)
PPO_REF = dict(n_envs=4, rollout_len=8)      # against the JAX package
PPO_CKPT = dict(n_envs=6, rollout_len=8)     # divides across 2 and 3 ranks
PPO_ITERATIONS = 3


def psum_inputs(world: int):
    """(grads, errors): dicts of (world, ...) f32 arrays, one row a rank."""
    rng = np.random.default_rng(world)
    g = {k: (rng.normal(size=(world,) + s) * rng.uniform(
        1e-3, 3.0, size=(world,) + (1,) * len(s))).astype(np.float32)
         for k, s in PSUM_SHAPES.items()}
    e = {k: (rng.normal(size=(world,) + s) * 1e-2).astype(np.float32)
         for k, s in PSUM_SHAPES.items()}
    return g, e


def fleet_case(kind: str):
    """(cfg, statics, state, scenarios) of the port on the CPU."""
    if kind == "fleet":
        cfg = pcfg.tiny_cluster(**FLEET_CFG)
        n, horizon, n_scn, seed = (FLEET_JOBS, FLEET_HORIZON,
                                   FLEET_SCENARIOS, 7)
    else:
        cfg = pcfg.tiny_cluster(**THERMAL_CFG)
        n, horizon, n_scn, seed = (THERMAL_JOBS, THERMAL_HORIZON,
                                   THERMAL_SCENARIOS, 3)
    jobs, bank = synth_workload(cfg, n, horizon, seed=0)
    statics = C.build_statics(cfg, bank, device="cpu")
    state = C.load_jobs(C.init_state(cfg, statics, 0), jobs)
    return cfg, statics, state, PS.sample_scenarios(cfg, n_scn, seed=seed)


def run_fleet_case(kind: str, mesh=None, **kw):
    cfg, statics, state, scns = fleet_case(kind)
    if kind == "fleet":
        return PF.run_fleet(cfg, statics, state, FLEET_TICKS, "fcfs",
                            scenarios=scns, macro=True, summary_only=True,
                            mesh=mesh, **kw)
    return PF.run_fleet(cfg, statics, state, THERMAL_TICKS, "fcfs",
                        scenarios=scns, summary_only=True, mesh=mesh, **kw)


def make_env(macro: bool = False) -> SchedEnv:
    cfg = pcfg.tiny_cluster(sched_max_candidates=4)
    wls = [synth_workload(cfg, ENV_JOBS, ENV_HORIZON, seed=s)
           for s in range(ENV_WORKLOADS)]
    return SchedEnv(cfg, wls, macro=macro, device="cpu", **ENV_KW)


def _psum(mesh) -> dict:
    g, e = psum_inputs(mesh.world)
    mine = {k: torch.from_numpy(v[mesh.rank]) for k, v in g.items()}
    out, new_e = compressed_psum(
        mine, mesh, {k: torch.from_numpy(v[mesh.rank]) for k, v in e.items()})
    return {"out": out, "new_error": new_e,
            "qd": quantize_dequantize(mine)}


def _ppo(mesh, macro=False, **kw):
    params, hist = distributed_ppo_train(
        make_env(macro), mesh, cfg=PPOConfig(**kw.pop("cfg", PPO_REF)),
        n_iterations=kw.pop("n_iterations", PPO_ITERATIONS), seed=0, **kw)
    return {"params": params, "history": hist}


def _refusal(fn) -> str:
    try:
        fn()
    except (ConfigError, CheckpointError) as e:
        return f"{type(e).__name__}: {e}"
    return "no refusal"


def world_two(mesh, tmp: str) -> dict:
    """Everything a world of 2 checks; the files it leaves under ``tmp``
    (a fleet snapshot kept at tick FLEET_KEEP_TICKS, a distributed PPO
    checkpoint of PPO_CKPT) are resumed by ``world_three``."""
    out = {"psum": _psum(mesh), "fleet": run_fleet_case("fleet", mesh),
           "thermal": run_fleet_case("thermal", mesh)}
    # the macro fleet's final states, written from this rank's block
    save_sharded(os.path.join(tmp, "sharded"), 0,
                 fleet_block(out["fleet"][0], mesh), mesh)
    snap = os.path.join(tmp, "fleet_snap")
    out["fleet_snapshotted"] = run_fleet_case(
        "fleet", mesh, snapshot_every_s=FLEET_SNAP_S, snapshot_dir=snap)
    if mesh.rank == 0:
        # the run "dies" after its snapshot at FLEET_KEEP_TICKS
        for d in os.listdir(snap):
            if int(d.split("_")[1]) > FLEET_KEEP_TICKS:
                shutil.rmtree(os.path.join(snap, d))
    mesh.barrier()
    out["ppo"] = _ppo(mesh, compress=False)
    # checkpointed as the JAX package's reference run is, so that the
    # parameters and error-feedback state after two compressed updates
    # can be held to its
    out["ppo_compressed"] = _ppo(
        mesh, compress=True, checkpoint_dir=os.path.join(tmp, "ppo_comp"),
        checkpoint_every=2)
    out["ppo_macro"] = _ppo(mesh, macro=True, compress=False)
    ck = os.path.join(tmp, "ppo_ckpt")
    whole = _ppo(mesh, cfg=PPO_CKPT, n_iterations=4,
                 checkpoint_dir=os.path.join(tmp, "ppo_whole"),
                 checkpoint_every=2)
    _ppo(mesh, cfg=PPO_CKPT, n_iterations=2, checkpoint_dir=ck,
         checkpoint_every=2)
    resumed = _ppo(mesh, cfg=PPO_CKPT, n_iterations=4, checkpoint_dir=ck,
                   checkpoint_every=2, resume=True)
    out["ppo_resume"] = {"whole": whole, "resumed": resumed}
    return out


def world_three(mesh, tmp: str, jax_ckpt: str) -> dict:
    """A world of 3, with a world of 1 (rank 0) and of 2 (ranks 0, 1) as
    subgroups: the compressed all-reduce and the sharded fleet at 3, the
    fleet snapshot of ``world_two`` resumed at 3 and at 1, its sharded
    checkpoint read back in blocks of 3, the JAX package's distributed
    PPO checkpoint resumed at 2, and the refusals."""
    import torch.distributed as dist

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.mesh import FleetMesh

    def sub_mesh(ranks):
        """This rank's mesh of a world made of ``ranks`` of this one (every
        rank of the world takes part in making the group)."""
        group = dist.new_group(ranks)
        return (FleetMesh(mesh.axis, ranks.index(mesh.rank), len(ranks),
                          group, mesh.device, mesh.backend)
                if mesh.rank in ranks else None)

    one, two = sub_mesh([0]), sub_mesh([0, 1])
    out = {"psum": _psum(mesh), "fleet": run_fleet_case("fleet", mesh)}

    out["resumed_from"] = {}

    def resumed(m, name):
        src, dst = os.path.join(tmp, "fleet_snap"), os.path.join(tmp, name)
        if m.rank == 0:
            shutil.copytree(src, dst)
            out["resumed_from"][name] = latest_step(dst)
        m.barrier()
        return run_fleet_case("fleet", m, snapshot_every_s=FLEET_SNAP_S,
                              resume_from=dst)

    out["fleet_resumed"] = resumed(mesh, "w3")
    if one is not None:
        out["fleet_resumed_w1"] = resumed(one, "w1")
    if two is not None:
        m2 = two
        if m2.rank == 0:
            shutil.copytree(jax_ckpt, os.path.join(tmp, "jax_ckpt"))
        m2.barrier()
        out["ppo_from_jax"] = _ppo(
            m2, compress=True, checkpoint_dir=os.path.join(tmp, "jax_ckpt"),
            checkpoint_every=2, resume=True)
    whole = out["fleet"][0]
    out["sharded_restore"] = (
        restore_sharded(os.path.join(tmp, "sharded"), 0, whole, mesh),
        fleet_block(whole, mesh))
    cfg, statics, state, scns = fleet_case("fleet")
    out["refusals"] = {
        "uneven": _refusal(lambda: PF.run_fleet(
            cfg, statics, state, 5, "fcfs",
            scenarios=PS.sample_scenarios(cfg, 4, seed=7), mesh=mesh)),
        "axis": _refusal(lambda: PF.run_fleet(
            cfg, statics, state, 5, "fcfs", scenarios=scns, mesh=mesh,
            mesh_axis="data")),
        "ppo_world": _refusal(lambda: _ppo(
            mesh, cfg=PPO_CKPT, n_iterations=4, resume=True,
            checkpoint_dir=os.path.join(tmp, "ppo_ckpt"),
            checkpoint_every=2)),
    }
    mesh.barrier()
    return out
