"""The port's perf model against the JAX package's, on the CPU.

Every arch: the config (``dataclasses.asdict``), ``shape_applicable``, the
parameter-spec leaves (names and shapes in the JAX package's flatten
order), both analytic parameter counts, every ``analytic_roofline`` field
at 16, 64 and 256 modelled chips, ``lm_training_job`` and
``serving_profile``: all equal (``==``, host float64 in both). The
``lm_jobs_workload`` arrays are equal bit for bit. Then the slice as a
whole: the LM workload through both packages' twins for 300 ticks of
"easy" under each of the virtual cloud's what-ifs, and the
``serving_profile`` knobs in a serving ``tiny_cluster``; integers equal,
floats within ``rtol = 1e-5``. The JAX runs are module-scoped fixtures.
"""

from __future__ import annotations

import dataclasses

import jax
import pytest

import repro.configs.base as JB
import repro.core as R
import repro.models.spec as JS
import repro.perfmodel as JP
from repro.configs.sim import tiny_cluster as jax_tiny
from repro.configs.sim import tx_gaia as jax_tx_gaia
from repro.scenarios.scenario import diurnal_serving as jax_diurnal_serving

import repro_torch.configs.base as TB
import repro_torch.core as C
import repro_torch.models.spec as TS
import repro_torch.perfmodel as TP
from repro_torch.configs import acceptance as A
from repro_torch.configs.sim import tiny_cluster
from repro_torch.scenarios import diurnal_serving

from _torch_parity import assert_state_close, assert_summary_close

ARCHS = JB.arch_names()
N_CHIPS = (16, 64, 256)
# (JAX package's, port's) shape configs
SHAPES = [(JB.SHAPES[k], TB.SHAPES[k]) for k in JB.SHAPES] + [
    (JB.SMOKE_SHAPE, TB.SMOKE_SHAPE),
    (JB.SMOKE_DECODE_SHAPE, TB.SMOKE_DECODE_SHAPE)]

# the slice as a whole, on the tiny cluster: the virtual cloud's archs and
# what-ifs over a short horizon, so that jobs arrive and finish in 300 ticks
SLICE_TICKS = 300
SLICE_JOBS = dict(n_jobs=32, horizon_s=150.0, seed=7)
# one more case beside the five what-ifs: a cap that binds on 16 nodes
SLICE_CASES = dict(A.VIRTUAL_CLOUD_WHAT_IFS,
                   **{"binding cap 3kW": {"power_cap_w": 3_000.0}})
SERVING_TICKS = 300
SERVING_KW = dict(serving_enabled=True, serving_nodes=4)
SERVING_TRAFFIC = dict(peak_rps=6.0, base_frac=0.2, period_s=300.0,
                       burst_start_s=120.0, burst_len_s=60.0, burst_mult=2.0)


def _jax_leaves(cfg):
    return [(jax.tree_util.keystr(path), tuple(leaf.shape)) for path, leaf
            in jax.tree_util.tree_leaves_with_path(JS.model_param_specs(cfg))]


def _keystr(name: str) -> str:
    """``body/0/wq`` as ``jax.tree_util.keystr`` writes its path."""
    return "".join(f"[{p}]" if p.isdigit() else f"[{p!r}]"
                   for p in name.split("/"))


def test_the_registries_hold_the_same_archs():
    assert TB.arch_names() == ARCHS
    assert len(ARCHS) == 10
    assert not hasattr(TB, "NOT_YET_PORTED")    # the port builds all ten


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_parameter_shapes_match(arch):
    jcfg, tcfg = JB.get_arch(arch), TB.get_arch(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert TB.to_dict(tcfg) == JB.to_dict(jcfg)
    for jshape, tshape in SHAPES:
        assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
        assert TB.shape_applicable(tcfg, tshape) == JB.shape_applicable(
            jcfg, jshape), jshape.name
    for j, t in ((jcfg, tcfg), (JB.reduced(jcfg), TB.reduced(tcfg))):
        assert TS.layout(t) == JS.layout(j)
        got = [(_keystr(n), s) for n, s in
               TS.leaves_with_names(TS.model_param_specs(t))]
        assert got == _jax_leaves(j)
        for active in (False, True):
            assert TS.count_params_analytic(t, active_only=active) == \
                JS.count_params_analytic(j, active_only=active)
        for p in range(t.n_layers):
            assert TS.layer_specs(t, p) == {
                k: tuple(v.shape) for k, v in JS.layer_specs(j, p).items()}
            assert TS.layer_kind_at(t, p) == JS.layer_kind_at(j, p)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_fields_equal(arch):
    jcfg, tcfg = JB.get_arch(arch), TB.get_arch(arch)
    n = 0
    for name, shape in JB.SHAPES.items():
        if not JB.shape_applicable(jcfg, shape)[0]:
            continue
        for chips in N_CHIPS:
            want = JP.analytic_roofline(jcfg, shape, n_chips=chips)
            got = TP.analytic_roofline(tcfg, TB.SHAPES[name], n_chips=chips)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                name, chips)
            assert got.terms() == want.terms()
            n += 1
    assert n >= 9


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_jobs_and_serving_profiles_equal(arch):
    cfg = JB.get_arch(arch)
    for name, shape in JB.SHAPES.items():
        if name == "long_500k" or not JB.shape_applicable(cfg, shape)[0]:
            continue
        for chips in N_CHIPS:
            kw = dict(n_chips=chips, token_budget=1e8)
            assert TP.lm_training_job(arch, name, **kw) == \
                JP.lm_training_job(arch, name, **kw)
    for kw in ({}, dict(n_chips=64, gen_tokens=128)):
        assert TP.serving_profile(arch, **kw) == JP.serving_profile(arch, **kw)
    assert TP.V5E == TP.constants.Chip(**dataclasses.asdict(JP.V5E))


def _assert_bitwise(want, got):
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("case", ["tiny", "virtual_cloud", "all_archs"])
def test_lm_jobs_workload_bitwise(case):
    if case == "virtual_cloud":
        jcfg = jax_tx_gaia(max_jobs=64, max_nodes_per_job=16)
        tcfg = A.virtual_cloud_config()
        archs, kw = list(A.VIRTUAL_CLOUD_ARCHS), A.VIRTUAL_CLOUD_JOBS
    else:
        jcfg, tcfg = jax_tiny(max_jobs=64), tiny_cluster(max_jobs=64)
        archs = (list(A.VIRTUAL_CLOUD_ARCHS) if case == "tiny" else ARCHS)
        kw = dict(n_jobs=48, horizon_s=1800.0, seed=3)
    want = JP.lm_jobs_workload(jcfg, archs, **kw)
    got = TP.lm_jobs_workload(tcfg, archs, **kw)
    _assert_bitwise(want, got)
    if case == "virtual_cloud":
        assert A.workload_digest(*want) == A.workload_digest(*got) == \
            A.PINNED_VIRTUAL_CLOUD["digest"]


def test_pinned_virtual_cloud_is_the_reference():
    """``PINNED_VIRTUAL_CLOUD`` against a live JAX run of both pinned
    what-ifs (the port on the card is held to it by ``chip_smoke.py``)."""
    jobs, bank = JP.lm_jobs_workload(
        jax_tx_gaia(max_jobs=64, max_nodes_per_job=16),
        list(A.VIRTUAL_CLOUD_ARCHS), **A.VIRTUAL_CLOUD_JOBS)
    for name in A.VIRTUAL_CLOUD_PINNED:
        cfg = jax_tx_gaia(max_jobs=64, max_nodes_per_job=16,
                          **A.VIRTUAL_CLOUD_WHAT_IFS[name])
        st = R.build_statics(cfg, bank)
        s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
        fs, tel = jax.jit(lambda s: R.run_episode(
            cfg, st, s, A.VIRTUAL_CLOUD_TICKS, A.VIRTUAL_CLOUD_SCHEDULER,
            summary_only=True))(s)
        assert R.summary(fs, tel) == A.PINNED_VIRTUAL_CLOUD[name], name
        assert A.virtual_cloud_config(name) == dataclasses.replace(
            A.virtual_cloud_config(), **A.VIRTUAL_CLOUD_WHAT_IFS[name])


# ---------------------------------------------------------------------------
# the slice as a whole
@pytest.fixture(scope="module")
def slice_workload():
    want = JP.lm_jobs_workload(jax_tiny(max_jobs=64),
                               list(A.VIRTUAL_CLOUD_ARCHS), **SLICE_JOBS)
    got = TP.lm_jobs_workload(tiny_cluster(max_jobs=64),
                              list(A.VIRTUAL_CLOUD_ARCHS), **SLICE_JOBS)
    _assert_bitwise(want, got)
    return got


@pytest.fixture(scope="module")
def reference_what_ifs(slice_workload):
    """The JAX package's final state and summary under each case."""
    jobs, bank = slice_workload
    out = {}
    for name, overrides in SLICE_CASES.items():
        cfg = jax_tiny(max_jobs=64, **overrides)
        st = R.build_statics(cfg, bank)
        s = R.load_jobs(R.init_state(cfg, st, jax.random.key(0)), jobs)
        fs, tel = jax.jit(lambda s, c=cfg, st=st: R.run_episode(
            c, st, s, SLICE_TICKS, A.VIRTUAL_CLOUD_SCHEDULER,
            summary_only=True))(s)
        out[name] = fs, R.summary(fs, tel)
    return out


@pytest.mark.parametrize("name", list(SLICE_CASES))
def test_lm_workload_what_ifs_through_the_twin(name, slice_workload,
                                               reference_what_ifs):
    from repro_torch.examples import virtual_cloud

    jobs, bank = slice_workload
    cfg = tiny_cluster(max_jobs=64, **SLICE_CASES[name])
    statics = C.build_statics(cfg, bank, device="cpu")
    state = C.load_jobs(C.init_state(cfg, statics, 0), jobs)
    final, telem = C.run_episode(cfg, statics, state, SLICE_TICKS,
                                 A.VIRTUAL_CLOUD_SCHEDULER,
                                 summary_only=True)
    ref_final, ref_summary = reference_what_ifs[name]
    assert_state_close(ref_final, final, name)
    got = C.summary(final, telem)
    assert_summary_close(ref_summary, got, name)
    assert got["ticks_simulated"] == SLICE_TICKS and got["energy_kwh"] > 0
    # the example's entry gives the same run
    assert virtual_cloud.what_if(cfg, jobs, bank, SLICE_TICKS, "cpu") == got
    base = reference_what_ifs["baseline"][1]
    if name == "binding cap 3kW":   # the cap throttles: less work, less power
        assert got["energy_kwh"] < base["energy_kwh"]
        assert got["completed"] < base["completed"]
    else:
        assert got["completed"] > 0


def test_serving_profile_drives_the_serving_twin(slice_workload):
    prof = JP.serving_profile("gemma3-1b", n_chips=16, gen_tokens=128)
    assert TP.serving_profile("gemma3-1b", n_chips=16, gen_tokens=128) == prof
    jobs, bank = slice_workload
    jcfg = jax_tiny(max_jobs=64, **SERVING_KW, **prof)
    tcfg = tiny_cluster(max_jobs=64, **SERVING_KW, **prof)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    st = R.build_statics(jcfg, bank, scenario=jax_diurnal_serving(
        jcfg, **SERVING_TRAFFIC))
    s = R.load_jobs(R.init_state(jcfg, st, jax.random.key(0)), jobs)
    ref_final, ref_tel = jax.jit(lambda s: R.run_episode(
        jcfg, st, s, SERVING_TICKS, A.VIRTUAL_CLOUD_SCHEDULER,
        summary_only=True))(s)
    statics = C.build_statics(tcfg, bank, device="cpu",
                              scenario=diurnal_serving(tcfg,
                                                       **SERVING_TRAFFIC))
    state = C.load_jobs(C.init_state(tcfg, statics, 0), jobs)
    final, telem = C.run_episode(tcfg, statics, state, SERVING_TICKS,
                                 A.VIRTUAL_CLOUD_SCHEDULER,
                                 summary_only=True)
    assert_state_close(ref_final, final, "serving")
    got = C.summary(final, telem)
    assert_summary_close(R.summary(ref_final, ref_tel), got, "serving")
    assert got["srv_arrived"] > 0 and got["srv_completed"] > 0
