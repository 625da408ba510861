"""The port's dry-run (``launch/dryrun.py``) against the JAX package's, on
the CPU.

- The fields that need no trace, for all 80 cells (10 archs x 4 shapes x
  ``single`` / ``multi``): the status, the skip reason word for word, the
  chips, the optimizer, the parameter counts, the tokens of a step and the
  model's FLOPs, each equal to what the JAX package's own functions give
  (``shape_applicable``, ``count_params_analytic``,
  ``default_optimizer_for``).
- ``memory.argument_bytes`` and ``alias_bytes`` of the two cells the JAX
  dry-run pinned (``acceptance.PINNED_DRYRUN``, on 256 fake ranks): the
  inputs alone are built, no step is traced.
- Traces on small fake worlds: reduced gemma3-1b (cut to a window layer
  and a global layer) under train, prefill and decode at small shapes on
  1 and 4 ranks, each ``OK`` with the JAX record's keys (and ``chip``),
  every collective kind the step issues counted; on 1 rank the FLOPs
  equal ``FlopCounterMode`` over the same step run for real on CPU
  tensors. The layer-delta probes of reduced qwen3-4b (2 layers) equal
  the full trace's counts. The kernels' cost
  formulas hold to ``FlopCounterMode`` over their plain versions. The records render
  through ``benchmarks/roofline_table.py``. ``--set`` refuses the JAX
  package's XLA knobs.

Collective bytes and FLOPs of full cells differ from the JAX dry-run by
design (DTensor and GSPMD lay the step out differently): they are
recorded, not held. The fake world lives in this process for the
module's tests and is torn down after them.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import count_params_analytic as jax_count_params
from repro.optim import default_optimizer_for as jax_default_optimizer

from repro_torch import kernels
from repro_torch.configs import SHAPES, ShapeConfig, arch_names, get_arch
from repro_torch.configs import acceptance as A
from repro_torch.configs import reduced
from repro_torch.configs.base import ATTN, ATTN_LOCAL
from repro_torch.launch import dryrun as D

CELLS = [(a, s, m) for a in arch_names() for s in SHAPES
         for m in ("single", "multi")]
# the small steps, named by the shape of their mode
SMALL = {"train_4k": ShapeConfig("train_4k", 16, 4, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 16, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 16, 4, "decode")}
# the collectives each small step issues on (2, 2)
KINDS = {"train_4k": {"all-gather", "reduce-scatter", "all-reduce"},
         "prefill_32k": {"all-gather", "reduce-scatter"},
         "decode_32k": {"all-gather", "all-reduce"}}


def gemma_cut():
    return dataclasses.replace(reduced(get_arch("gemma3-1b")), n_layers=2,
                               block_pattern=(ATTN_LOCAL, ATTN),
                               swa_window=8)


@pytest.fixture(scope="module")
def fake():
    """Tear the fake world down after the module (its tests make it)."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_analytic_fields_equal_the_jax_packages(arch, shape, mesh):
    got = D.cell_fields(arch, shape, mesh)
    jcfg, jshape = jax_get_arch(arch), JAX_SHAPES[shape]
    ok, why = jax_shape_applicable(jcfg, jshape)
    if not ok:
        assert got == {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "SKIP", "reason": why}
        return
    n, active = (jax_count_params(jcfg),
                 jax_count_params(jcfg, active_only=True))
    tokens = jshape.global_batch * (1 if jshape.mode == "decode"
                                    else jshape.seq_len)
    per = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[jshape.mode]
    assert got == {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "OK",
                   "n_chips": 512 if mesh == "multi" else 256,
                   "optimizer": jax_default_optimizer(n),
                   "params_b": n / 1e9, "active_params_b": active / 1e9,
                   "tokens_per_step": float(tokens),
                   "model_flops_total": per * active * tokens}


@pytest.mark.parametrize("cell", list(A.PINNED_DRYRUN))
def test_argument_bytes_equal_the_pinned_jax_records(fake, cell):
    from repro_torch.optim import get_optimizer
    from repro_torch.utils.tree import tree_bytes

    pin = A.PINNED_DRYRUN[cell]
    arch, shape_name, mesh_kind = cell.split("__")
    fields = D.cell_fields(arch, shape_name, mesh_kind)
    assert {k: fields[k] for k in pin if k != "memory"} == {
        k: v for k, v in pin.items() if k != "memory"}
    mesh, tp, multi = D.make_mesh(mesh_kind)
    shape = SHAPES[shape_name]
    ctx = D.cell_ctx(shape, multi, tp, mesh.size() // tp)
    _, args, alias = D.step_inputs(get_arch(arch), shape, mesh, ctx,
                                   get_optimizer(fields["optimizer"]))
    assert tree_bytes(args, local=True) == pin["memory"]["argument_bytes"]
    assert tree_bytes(alias, local=True) == pin["memory"]["alias_bytes"]


@pytest.fixture(scope="module")
def records(fake):
    """(ranks, shape name) -> the record of reduced gemma3-1b (cut) at the
    small step of that mode, on 1 and 4 ranks."""
    cfg = gemma_cut()
    return {(n, name): D.run_cell("gemma3-1b", name, mesh, cfg=cfg,
                                  shape=SMALL[name], probes=False,
                                  verbose=False)
            for n, mesh in ((1, "custom:1,1"), (4, "custom:2,2"))
            for name in SMALL}


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("name", list(SMALL))
def test_small_cells_trace_with_the_jax_record_keys(records, ranks, name):
    rec = records[(ranks, name)]
    assert rec["status"] == "OK"
    assert set(rec) == set(A.DRYRUN_KEYS) | {"chip"}
    assert rec["chip"] == D.CHIP and rec["n_chips"] == ranks
    assert rec["hlo_flops_per_dev"] > 0 and rec["hlo_bytes_per_dev"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    if name != "prefill_32k":       # the donated state or cache
        assert 0 < mem["alias_bytes"] < mem["argument_bytes"]


@pytest.mark.parametrize("name", list(SMALL))
def test_every_collective_kind_is_counted(records, name):
    coll = records[(4, name)]["collectives"]
    counts = coll["raw_scan_body_count_by_kind"]
    assert set(counts) == KINDS[name]
    assert all(counts[k] > 0 and coll["raw_scan_body_bytes_by_kind"][k] > 0
               for k in counts)
    assert records[(1, name)]["collective_bytes_per_dev"] == 0


def _cpu_step(name: str):
    """The small step of ``name``'s mode on real CPU tensors, unsharded, on
    the dry-run's weights (bf16 for serving, the f32 state for train)."""
    from repro_torch.models.init import init_params
    from repro_torch.models.model import (
        DecoderLM,
        decode_step,
        init_cache,
        prefill,
    )
    from repro_torch.optim import AdamW
    from repro_torch.train import create_train_state, make_train_step

    cfg, shape = gemma_cut(), SMALL[name]
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                         generator=gen, dtype=torch.int32)
    if shape.mode == "train":
        opt = AdamW()
        state = create_train_state(cfg, opt, gen, "cpu")
        step = make_train_step(cfg, opt)
        return lambda: step(state, {"tokens": toks, "labels": toks})
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = DecoderLM.from_tree(bcfg, init_params(bcfg, gen, "cpu"))
    if shape.mode == "prefill":
        return lambda: prefill(model, toks, cache_seq_len=shape.seq_len)
    cache = init_cache(model, shape.global_batch, shape.seq_len)
    return lambda: decode_step(model, cache, toks[:, :1], shape.seq_len - 1)


@pytest.mark.parametrize("name", list(SMALL))
def test_one_rank_flops_equal_flop_counter_on_cpu(records, name):
    from torch.utils.flop_counter import FlopCounterMode

    run = _cpu_step(name)
    with FlopCounterMode(display=False) as fc:
        run()
    assert records[(1, name)]["raw_cost_analysis"]["flops"] == float(
        fc.get_total_flops())


def test_probes_scale_to_the_full_trace(fake):
    """Reduced qwen3-4b's prefill: 2 layers of period 1, probed at L = 0
    and 1: the scaled FLOPs, bytes and collective bytes by kind equal the
    full trace's."""
    rec = D.run_cell("qwen3-4b", "prefill_32k", "custom:2,2",
                     cfg=reduced(get_arch("qwen3-4b")),
                     shape=SMALL["prefill_32k"], verbose=False)
    probe, raw = rec["probe"], rec["raw_cost_analysis"]
    assert set(probe["probe_points"]) == {"L0", "L_period"}
    assert probe["flops_per_dev"] == raw["flops"]
    assert probe["bytes_per_dev"] == raw["bytes_accessed"]
    assert probe["collective_bytes_by_kind"] == rec["collectives"][
        "raw_scan_body_bytes_by_kind"]


def test_a_dtensor_product_counts_the_ranks_local_flops(fake):
    """x (16, 64) split over ``data``, w (64, 32) over ``model`` on a (2,
    2) fake mesh: rank 0 multiplies (8, 64) by (64, 16), 16,384 FLOPs;
    DTensor's propagation of the global product on fake tensors is not
    counted (``FlopCounterMode`` counts it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = D.make_mesh("custom:2,2")[0]
    x = DTensor.from_local(torch.empty(8, 64, device="meta"), mesh,
                           (Shard(0), Replicate()), run_check=False,
                           shape=(16, 64), stride=(64, 1))
    w = DTensor.from_local(torch.empty(64, 16, device="meta"), mesh,
                           (Replicate(), Shard(1)), run_check=False,
                           shape=(64, 32), stride=(32, 1))
    with D.StepCosts() as costs:
        y = x @ w
    assert tuple(y.to_local().shape) == (8, 16)
    assert costs.flops == 2 * 8 * 64 * 16


def test_kernel_formulas_hold_to_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attn import (
        attention_cost,
        attention_torch,
        flash_attention,
    )
    from repro_torch.kernels.selective_scan import (
        mamba_scan,
        mamba_scan_torch,
        scan_cost,
    )

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 16, generator=gen, requires_grad=True)
    k = torch.randn(2, 12, 2, 16, generator=gen, requires_grad=True)
    v = torch.randn(2, 12, 2, 16, generator=gen, requires_grad=True)
    flops, nbytes = attention_cost(q, k, v)
    with FlopCounterMode(display=False) as fwd:
        out = attention_torch(q, k, v, causal=True, window=4)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert fwd.get_total_flops() == flops
    assert bwd.get_total_flops() == 2 * flops
    assert nbytes == 4 * (q.numel() * 2 + k.numel() * 2)

    got = []
    kernels.META_SINKS.append(lambda f, b: got.append((f, b)))
    try:
        before = dict(kernels.LAUNCHES)
        qm, km, vm = (t.detach().to("meta").requires_grad_()
                      for t in (q, k, v))
        om = flash_attention(qm, km, vm, causal=True, window=4)
        om.sum().backward()
        assert om.shape == q.shape and om.dtype == q.dtype
        assert km.grad.shape == k.shape
        xb = torch.randn(2, 6, 8, generator=gen)
        A_ = -torch.rand(8, 8, generator=gen)
        args = (xb, torch.randn(2, 6, 8, generator=gen),
                torch.randn(8, generator=gen), A_,
                torch.randn(2, 6, 8, generator=gen),
                torch.randn(2, 6, 8, generator=gen),
                torch.randn(2, 6, 8, generator=gen),
                torch.randn(8, generator=gen))
        with FlopCounterMode(display=False) as scan:
            y, final = mamba_scan_torch(*args)
        ym, fm = mamba_scan(*(t.to("meta") for t in args))
        assert (ym.shape, fm.shape, fm.dtype) == (y.shape, final.shape,
                                                  final.dtype)
        assert scan.get_total_flops() == scan_cost(args, (y, final))[0] == 0
        assert kernels.LAUNCHES == before
    finally:
        kernels.META_SINKS.pop()
    assert [f for f, _ in got] == [flops, 2 * flops, 0]


def test_records_render_through_the_roofline_tables(records):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks.roofline_table import dryrun_table, roofline_table

    cells = {("gemma3-1b", name, "single"): rec
             for (n, name), rec in records.items() if n == 4}
    cells[("qwen3-4b", "long_500k", "single")] = D.cell_fields(
        "qwen3-4b", "long_500k", "single")
    table = dryrun_table(cells)
    rows = [r for r in table.splitlines() if r.startswith("| gemma3-1b |")]
    assert [r.split(" | ")[2] for r in rows] == ["OK", "OK", "OK", "MISSING"]
    assert "| qwen3-4b | long_500k | SKIP |" in table
    roof, rows = roofline_table(cells)
    assert roof.count("| gemma3-1b |") == 4 and "dominant" in roof
    assert [r[1] for r in rows] == list(SMALL)


def test_set_refuses_the_xla_knobs():
    for knob in D.XLA_KNOBS:
        with pytest.raises(ValueError, match="XLA knob"):
            D.parse_overrides([f"{knob}=1"])
    with pytest.raises(ValueError, match="not a ShardCtx field"):
        D.parse_overrides(["no_such_knob=1"])
    assert D.parse_overrides(["seq_parallel=0", "logit_chunk=1",
                              "decode_kv_shard=head"]) == {
        "seq_parallel": False, "logit_chunk": 1, "decode_kv_shard": "head"}
    assert np.isclose(D.PEAK_FLOPS, 989e12) and D.CHIP == "H100"
