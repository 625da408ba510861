"""The device-sharded twin on ``torch.distributed``: gloo worlds of 2 and 3
CPU processes (``launch.mesh.spawn_world``; the rank programs are in
``_torch_mesh_workers.py``), each spawned once and running all its cases,
against the port's single-process runs and the JAX package's, whose
multi-device references come from one subprocess with 4 fake host
devices (as ``tests/test_multidevice.py`` runs them):

- ``compressed_psum`` and ``quantize_dequantize`` at W = 2 and 3 bit for
  bit with the JAX package's, compiled (inside ``shard_map``, and under
  ``jit``: eager JAX divides by 127 where XLA's compiler multiplies by
  its reciprocal);
- ``run_fleet(mesh=)`` with thermals, faults and macro on (12 scenarios)
  at W = 2 and 3: bitwise the port's vmapped ``run_fleet`` (every state
  and telemetry field, the key words, ``fleet_summary``), on every rank,
  and within ``RTOL`` of the JAX package's vmapped run per tick (its
  sharded path fails on this jax, and its macro path misses restarts of
  killed jobs, ROADMAP queue 3; the port's macro run is its per-tick run
  bit for bit, so only the count of macro steps is left out); the thermal
  fleet likewise, its trip crossed;
- the refusals in the reference's words;
- ``distributed_ppo_train`` with ``SchedEnv(macro=False)`` at W = 2
  against the JAX package's at 2 fake devices: every iteration's stats
  (``compress=True``: iterations 1 and 2, after compressed updates, all
  at the loss tolerance), and with ``compress=True`` the parameters and
  each rank's error-feedback state after two updates (an element whose
  int8 value a rounding tie flipped is off by one step: at most 0.1% of
  a leaf); ``macro=True`` bitwise its ``macro=False`` run;
- a fleet snapshot written at W = 2 resumed at W = 1 and 3, bitwise the
  uninterrupted vmapped run with the same snapshot interval (a segment's
  edge counts as a macro step, ``sim.run_segment``); a distributed PPO checkpoint resumed at W =
  2 bitwise and refused at W = 3; the JAX package's distributed PPO
  checkpoint (2 fake devices) resumed in the port at W = 2.

PPO stats: rollout stats within 1e-5, loss stats within 1e-3 (as
``tests/test_torch_ppo.py``); one gradient step a iteration evaluates the
loss at ratio 1, where ``pg_loss`` and ``approx_kl`` are zero but for
rounding, so they are held to 1e-6 absolute
(``acceptance.RATIO_ONE_ATOL``).
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_state_close,
    assert_summary_close,
    assert_tree_close,
)

import _torch_mesh_workers as MW
from repro_torch.configs import acceptance as A
from repro_torch.core import fleet as PF
from repro_torch.launch.mesh import FleetMesh, spawn_world
from repro_torch.utils.errors import ConfigError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROLLOUT_STATS = ("mean_reward", "mean_episode_return", "mean_episode_len",
                 "mean_value")
STATS_RTOL = 1e-3
# the compressed run's state after two updates against the JAX package's
PARAMS_ATOL, ERROR_ATOL = 1e-6, 1e-6

# the JAX package's multi-device references, in one process with 4 fake
# host devices; everything numpy, pickled to OUT/ref.pkl
_JAX_REF = """
import os, pickle, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
import _torch_mesh_workers as MW
import repro.configs.sim as rcfg
from repro.core import (build_statics, fleet_summary, init_state, load_jobs,
                        run_fleet)
from repro.data import synth_workload
from repro.envs import SchedEnv
from repro.launch.mesh import make_fleet_mesh
from repro.optim.compress import compressed_psum, quantize_dequantize
from repro.rl.distributed import distributed_ppo_train
from repro.rl.ppo import PPOConfig
from repro.scenarios import sample_scenarios
from repro.sharding.specs import shard_map_compat

out_dir = sys.argv[1]
res = {"psum": {}, "fleet": {}, "ppo": {}}
cfg = rcfg.tiny_cluster(sched_max_candidates=4)
wls = [synth_workload(cfg, MW.ENV_JOBS, MW.ENV_HORIZON, seed=s)
       for s in range(MW.ENV_WORKLOADS)]
env = SchedEnv(cfg, wls, macro=False, **MW.ENV_KW)
mesh = make_fleet_mesh(2)
for compress in (False, True):
    kw = (dict(checkpoint_dir=os.path.join(out_dir, "ppo_ckpt"),
               checkpoint_every=2) if compress else {})
    _, hist = distributed_ppo_train(
        env, mesh, cfg=PPOConfig(**MW.PPO_REF),
        n_iterations=MW.PPO_ITERATIONS, compress=compress, **kw)
    res["ppo"][compress] = hist
for W in (2, 3):
    mesh = make_fleet_mesh(W)
    g, e = MW.psum_inputs(W)
    spec = {k: P("replica") for k in g}

    def f(g, e):
        o, ne = compressed_psum({k: v[0] for k, v in g.items()}, "replica",
                                {k: v[0] for k, v in e.items()})
        return ({k: v[None] for k, v in o.items()},
                {k: v[None] for k, v in ne.items()})

    fn = jax.jit(shard_map_compat(f, mesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec)))
    o, ne = jax.device_get(fn(g, e))
    qd = [jax.device_get(jax.jit(quantize_dequantize)(
        {k: v[r] for k, v in g.items()})) for r in range(W)]
    res["psum"][W] = dict(out=o, new_error=ne, qd=qd)

for kind, kw in (("fleet", dict(MW.FLEET_CFG)), ("thermal", MW.THERMAL_CFG)):
    cfg = rcfg.tiny_cluster(**kw)
    n, horizon, n_scn, seed, ticks = (
        (MW.FLEET_JOBS, MW.FLEET_HORIZON, MW.FLEET_SCENARIOS, 7,
         MW.FLEET_TICKS) if kind == "fleet" else
        (MW.THERMAL_JOBS, MW.THERMAL_HORIZON, MW.THERMAL_SCENARIOS, 3,
         MW.THERMAL_TICKS))
    jobs, bank = synth_workload(cfg, n, horizon, seed=0)
    statics = build_statics(cfg, bank)
    st = load_jobs(init_state(cfg, statics, jax.random.key(0)), jobs)
    # per tick: the reference's macro path misses restarts of killed jobs
    fs, tel = run_fleet(cfg, statics, st, ticks, "fcfs",
                        scenarios=sample_scenarios(cfg, n_scn, seed=seed),
                        summary_only=True)
    fs = jax.device_get(fs._replace(key=jax.random.key_data(fs.key)))
    res["fleet"][kind] = (fs, jax.device_get(tel),
                          fleet_summary(fs, jax.device_get(tel)))

with open(os.path.join(out_dir, "ref.pkl"), "wb") as fh:
    pickle.dump(res, fh)
"""


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Started first, to run while the port's worlds run: the JAX
    references' subprocess (its distributed PPO checkpoint first) and, in
    a thread, the port's single-process (vmapped) runs of both fleets and
    of the macro fleet with snapshots uninterrupted."""
    out = tmp_path_factory.mktemp("jax_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    log = open(out / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_REF), str(out)],
        stdout=log, stderr=subprocess.STDOUT, env=env)
    snap = str(tmp_path_factory.mktemp("vmapped_snap"))
    vmapped = {}

    def port_runs():
        for kind in ("fleet", "thermal"):
            vmapped[kind] = MW.run_fleet_case(kind)
        vmapped["snapshotted"] = MW.run_fleet_case(
            "fleet", snapshot_every_s=MW.FLEET_SNAP_S, snapshot_dir=snap)

    thread = threading.Thread(target=port_runs)
    thread.start()
    yield proc, out, thread, vmapped
    thread.join()
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    log.close()


@pytest.fixture(scope="module")
def jax_ref(background):
    proc, out, _, _ = background
    rc = proc.wait(timeout=600)
    assert rc == 0, (out / "log.txt").read_text()
    with open(out / "ref.pkl", "rb") as fh:
        ref = pickle.load(fh)
    ref["ppo_ckpt"] = str(out / "ppo_ckpt")
    return ref


@pytest.fixture(scope="module")
def vmapped(background):
    _, _, thread, runs = background
    thread.join(timeout=600)
    assert not thread.is_alive() and set(runs) == {"fleet", "thermal",
                                                   "snapshotted"}
    return runs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_files")


@pytest.fixture(scope="module")
def world2(background, files):
    return spawn_world(MW.world_two, 2, backend="gloo",
                       devices=["cpu"] * 2, args=(str(files),))


@pytest.fixture(scope="module")
def world3(world2, background, files):
    """Spawned once world 2 is done and the JAX subprocess has written its
    distributed PPO checkpoint (its other references still computing)."""
    proc, out, _, _ = background
    ckpt = out / "ppo_ckpt"
    deadline = time.monotonic() + 600
    while not list(ckpt.glob("step_*/manifest.json")):
        assert proc.poll() is None, (out / "log.txt").read_text()
        assert time.monotonic() < deadline, "no JAX checkpoint"
        time.sleep(0.2)
    return spawn_world(MW.world_three, 3, backend="gloo",
                       devices=["cpu"] * 3, args=(str(files), str(ckpt)))


MACRO_COLUMNS = ("macro_steps_taken", "macro_skip_ratio")


def _assert_reference_close(ref, want, tag):
    """The port's fleet within RTOL of the JAX package's per-tick one."""
    fs, tel, rows = ref
    assert_state_close(fs, want[0], f"{tag}.state")
    assert_tree_close(tel, want[1], f"{tag}.telemetry", skip=("macro_steps",))
    for i, (a, b) in enumerate(zip(rows, PF.fleet_summary(*want))):
        assert_summary_close(
            {k: v for k, v in a.items() if k not in MACRO_COLUMNS},
            {k: v for k, v in b.items() if k not in MACRO_COLUMNS},
            f"{tag}[{i}]")


def _assert_bitwise(want, got, tag):
    ws, wt = want
    gs, gt = got
    for f in ws._fields:
        assert torch.equal(getattr(ws, f), getattr(gs, f)), f"{tag}: {f}"
    for f in wt._fields:
        a, b = getattr(wt, f), getattr(gt, f)
        assert (a is None and b is None) or torch.equal(a, b), \
            f"{tag}: telemetry.{f}"
    assert PF.fleet_summary(*want) == PF.fleet_summary(*got), tag


def _assert_stats(ref, got, tag, rollout_rtol=1e-5):
    assert set(ref) == set(got), tag
    for k, v in ref.items():
        if k in A.RATIO_ONE_STATS:
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=A.RATIO_ONE_ATOL,
                                       err_msg=f"{tag}: {k}")
        else:
            tol = rollout_rtol if k in ROLLOUT_STATS else STATS_RTOL
            np.testing.assert_allclose(got[k], v, rtol=tol,
                                       err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("world", [2, 3])
def test_compressed_psum_is_the_jax_packages_bit_for_bit(world, world2,
                                                         world3, jax_ref):
    ref = jax_ref["psum"][world]
    ranks = world2 if world == 2 else world3
    for r, got in enumerate(ranks):
        for k in MW.PSUM_SHAPES:
            np.testing.assert_array_equal(got["psum"]["out"][k].numpy(),
                                          ref["out"][k][r], err_msg=k)
            np.testing.assert_array_equal(
                got["psum"]["new_error"][k].numpy(), ref["new_error"][k][r],
                err_msg=k)
            np.testing.assert_array_equal(got["psum"]["qd"][k].numpy(),
                                          ref["qd"][r][k], err_msg=k)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_fleet_is_the_vmapped_run_bit_for_bit(world, world2, world3,
                                                      vmapped, jax_ref):
    want = vmapped["fleet"]
    assert float(want[0].n_killed.sum()) > 0, "faults never fired"
    for r, got in enumerate(world2 if world == 2 else world3):
        _assert_bitwise(want, got["fleet"], f"W={world} rank {r}")
    _assert_reference_close(jax_ref["fleet"]["fleet"], want, "fleet")


def test_sharded_thermal_fleet_crosses_the_trip(world2, vmapped, jax_ref):
    want = vmapped["thermal"]
    cfg = MW.fleet_case("thermal")[0]
    assert bool((want[0].peak_rack_c >= cfg.thermal_trip_c).any()), \
        "no replica crossed the trip threshold"
    for r, got in enumerate(world2):
        _assert_bitwise(want, got["thermal"], f"thermal rank {r}")
    _assert_reference_close(jax_ref["fleet"]["thermal"], want, "thermal")


def test_refusals_use_the_references_words(world3):
    got = world3[0]["refusals"]
    assert got["uneven"].startswith("ConfigError") \
        and "4 replicas" in got["uneven"] and "3 " in got["uneven"]
    assert got["axis"].startswith("ConfigError") and "'data'" in got["axis"]
    cfg, statics, state, _ = MW.fleet_case("fleet")
    from repro_torch import scenarios as PS

    four = FleetMesh("replica", 0, 4, None, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="6 replicas.*4 'replica'"):
        PF.run_fleet(cfg, statics, state, 5, "fcfs", mesh=four,
                     scenarios=PS.sample_scenarios(cfg, 6, seed=3))
    with pytest.raises(ConfigError, match="'data'"):
        PF.run_fleet(cfg, statics, state, 5, "fcfs", mesh=four,
                     mesh_axis="data",
                     scenarios=PS.sample_scenarios(cfg, 8, seed=3))


def test_distributed_ppo_matches_the_jax_packages(world2, jax_ref):
    for r, got in enumerate(world2):
        hist = got["ppo"]["history"]
        assert len(hist) == MW.PPO_ITERATIONS
        for i, (a, b) in enumerate(zip(jax_ref["ppo"][False], hist)):
            _assert_stats(a, b, f"rank {r} compress=False iteration {i}")
        comp = got["ppo_compressed"]["history"]
        assert len(comp) == MW.PPO_ITERATIONS
        _assert_stats(jax_ref["ppo"][True][0], comp[0],
                      f"rank {r} compress=True iteration 0")
        # iterations 1 and 2 follow one and two compressed updates (the
        # error-feedback carry and the compressed mean applied)
        for i in range(1, MW.PPO_ITERATIONS):
            _assert_stats(jax_ref["ppo"][True][i], comp[i],
                          f"rank {r} compress=True iteration {i}",
                          rollout_rtol=STATS_RTOL)
        assert set(hist[0]) == set(jax_ref["ppo"][True][0])
    assert world2[0]["ppo"]["history"] == world2[1]["ppo"]["history"]


def _checkpoint(directory, step):
    """A checkpoint's leaves as numpy arrays, by file name."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        names = json.load(fh)["leaves"]
    return {n: np.load(os.path.join(path, n + ".npy")) for n in names}


def test_compressed_training_state_matches_the_jax_packages(world2, files,
                                                            jax_ref):
    """After two compressed updates at W = 2 (checkpoint step 1 of both
    runs): the parameters, the Adam moments and each rank's
    error-feedback state against the JAX package's."""
    got = _checkpoint(files / "ppo_comp", 1)
    want = _checkpoint(jax_ref["ppo_ckpt"], 1)
    params = [n for n in want if n.startswith("params__")]
    errors = [n for n in want if n.startswith("error__")]
    assert params and errors and set(got) >= set(params + errors)
    for n in params:
        # Adam moves an element by up to lr = 3e-4 a step; a fault in the
        # compressed mean moves many by a share of that
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=PARAMS_ATOL, err_msg=n)
    for n in errors:
        a, b = got[n].astype(np.float64), want[n].astype(np.float64)
        assert a.shape == b.shape == (2,) + want[n].shape[1:], n
        # rounding noise in the gradients may flip an element's int8 value
        # at a tie, moving its error by one step: the two errors then sit
        # at opposite ends, -step/2 and +step/2, and sum to about 0
        apart = np.abs(a - b) > ERROR_ATOL
        assert np.all(np.abs(a + b)[apart] <= ERROR_ATOL), n
        assert apart.sum() <= 1e-3 * a.size, (n, int(apart.sum()))


def test_distributed_ppo_macro_is_its_per_tick_run(world2):
    for got in world2:
        assert got["ppo_macro"]["history"] == got["ppo"]["history"]
        for k, v in got["ppo"]["params"].items():
            assert torch.equal(got["ppo_macro"]["params"][k], v), k


@pytest.mark.parametrize("world", [1, 3])
def test_fleet_snapshot_resumes_on_another_world_size(world, world2, world3,
                                                      vmapped):
    want = vmapped["snapshotted"]
    for r, got in enumerate(world2):
        _assert_bitwise(want, got["fleet_snapshotted"],
                        f"snapshotted rank {r}")
    if world == 1:
        _assert_bitwise(want, world3[0]["fleet_resumed_w1"],
                        "resumed at W=1")
    else:
        for r, got in enumerate(world3):
            _assert_bitwise(want, got["fleet_resumed"],
                            f"resumed at W=3, rank {r}")
    # the runs resumed from the snapshot at FLEET_KEEP_TICKS; snapshots
    # leave the state as the plain run's
    assert world3[0]["resumed_from"] == {"w1": MW.FLEET_KEEP_TICKS,
                                         "w3": MW.FLEET_KEEP_TICKS}
    for f in want[0]._fields:
        assert torch.equal(getattr(want[0], f),
                           getattr(vmapped["fleet"][0], f)), f


def test_sharded_checkpoint_restores_in_blocks_of_another_world(world3):
    """``save_sharded`` from a world of 2's blocks, ``restore_sharded`` on
    a world of 3: each rank reads its own block of the whole."""
    for r, got in enumerate(world3):
        restored, want = got["sharded_restore"]
        assert restored.t.shape == (MW.FLEET_SCENARIOS // 3,)
        for f in want._fields:
            assert torch.equal(getattr(restored, f), getattr(want, f)), \
                f"rank {r}: {f}"


def test_distributed_ppo_checkpoint_resumes_on_its_world_only(world2,
                                                              world3):
    for got in world2:
        whole, resumed = got["ppo_resume"]["whole"], got["ppo_resume"][
            "resumed"]
        assert resumed["history"] == whole["history"][2:]
        for k, v in whole["params"].items():
            assert torch.equal(resumed["params"][k], v), k
    msg = world3[0]["refusals"]["ppo_world"]
    assert msg.startswith("CheckpointError") and "2" in msg and "3" in msg


def test_jax_written_distributed_checkpoint_resumes_in_the_port(world3,
                                                                 jax_ref):
    for r in (0, 1):
        hist = world3[r]["ppo_from_jax"]["history"]
        assert len(hist) == 1          # iteration 2, after the checkpoint
        _assert_stats(jax_ref["ppo"][True][2], hist[0], f"rank {r}")


def test_spawn_world_puts_ranks_on_the_card_unless_told(monkeypatch):
    """The backend has no default, and a world whose devices are not named
    goes to the card: on a host without one it refuses before any rank
    starts, naming the CPU's spelling."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(TypeError, match="backend"):
        spawn_world(MW.world_two, 2)
    for backend, device in (("gloo", "cuda:0"), ("nccl", "cuda:0")):
        with pytest.raises(RuntimeError, match=f"{device} is missing.*'cpu'"):
            spawn_world(MW.world_two, 2, backend=backend)
