"""Multi-pod dry-run of the port (the JAX package's ``launch/dryrun.py``):
trace every (arch x shape x mesh) cell's step on a fake world of 256
ranks (the (16, 16) pod) or 512 (two pods) and record its roofline
inputs: FLOPs, bytes, per-collective traffic and memory, per device. No
tensor is allocated and nothing runs on a device: the host alone.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/artifacts
  ... --set seq_parallel=0 --microbatches 2 --tag nosp   (ShardCtx knobs)

The world is a ``FakeStore`` process group (``torch.testing._internal.
distributed.fake_pg``) of which this process is rank 0, its mesh
``launch.mesh.make_production_mesh`` (or ``custom:d,m``, a (d, m) mesh
over d * m ranks). A step's inputs are tensors on the ``meta`` device made
into DTensors laid out by ``train_state_pspecs``, ``param_pspecs`` and
``batch_pspecs`` (the decode cache by ``layer_cache_pspecs``); prefill
and decode run on a ``DecoderLM`` of bf16 weights, as the JAX dry-run
casts its parameters. The step then runs as DTensor operations on rank
0's local meta shards, which is what the record counts "per device":

- FLOPs: the local ops' products, by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter``: matmuls, attention, convolutions; no
  elementwise op), plus the kernels' own formulas where a kernel's
  wrapper is called on meta tensors (``kernels.meta_cost``:
  ``flash_attn.attention_cost``, ``selective_scan.scan_cost``). DTensor
  runs a new op once more on fake or meta tensors of the global shape to
  propagate its sharding; those runs are not the rank's work and are not
  counted (``FlopCounterMode`` around a DTensor counts them too), so the
  counts do not depend on what the process traced before.
- bytes: each local op's inputs read and outputs written, views and
  ``empty`` excepted.
- collectives: every ``_c10d_functional`` op (DTensor's redistributions)
  in a ``utils.hlo.CollectiveStats``, by the HLO kind of the same
  collective, with the bytes of its result (``utils.hlo``'s convention:
  what the op materialises on each participant).
- memory: ``argument_bytes`` and ``output_bytes`` the local bytes of the
  step's inputs and outputs, ``alias_bytes`` the donated train state or
  decode cache, ``temp_bytes`` the peak of live allocations the step
  made (its storages, freed as they die).

``_probe_costs`` ports the layer-delta probes: the step at L = 0, one
period and one period plus the tail, scaled to the full depth. The port
traces every layer (there is no scan body that XLA's cost analysis
counts once), so the probes agree with the full trace; the record takes
the probes' numbers where they ran, as the JAX dry-run does.

The roofline terms divide by the card the port runs on, an NVIDIA H100
SXM 80 GB (HBM3, 700 W; ``CHIP``, ``PEAK_FLOPS``, ``HBM_BW``,
``LINK_BW``). The collective term takes NVLink's rate, which is a lower
bound on the time across hosts. Times here are estimates, never
measurements.

A cell is ``OK``, ``SKIP`` (``configs.shape_applicable``'s reason) or
``FAIL`` (with ``error``): the families that do not serve on a mesh yet
fail their prefill and decode cells with ``models.model.
check_mesh_serving``'s refusal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from dataclasses import replace
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.configs import SHAPES, arch_names, get_arch, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import count_params_analytic
from repro_torch.models import spec as S
from repro_torch.optim import default_optimizer_for, get_optimizer
from repro_torch.sharding.ctx import ShardCtx, make_ctx
from repro_torch.sharding.specs import (
    batch_pspecs,
    layer_cache_pspecs,
    param_pspecs,
    placements,
    train_state_pspecs,
)
from repro_torch.utils.hlo import FUNCTIONAL_KINDS, CollectiveStats
from repro_torch.utils.tree import tree_bytes, tree_map_with_path_names

# the card's roofline denominators: NVIDIA H100 SXM 80 GB HBM3 at 700 W
CHIP = "H100"
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # bytes/s of HBM3
LINK_BW = 450e9            # bytes/s of NVLink, each way

# ShardCtx knobs of the JAX package that steer XLA and have no reader here
XLA_KNOBS = ("attention_impl", "block_q", "block_k", "force_unroll",
             "scan_unroll")


# ---------------------------------------------------------------------------
# the fake world and its meta inputs
def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks, replacing
    a fake world of another size (a real process group is refused)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if str(dist.get_backend()) != "fake":
            raise RuntimeError("the dry-run needs a process of its own: a "
                               f"{dist.get_backend()} process group is "
                               "initialised here")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(mesh_kind: str):
    """(the DeviceMesh of ``mesh_kind`` on a fake world, its model axis,
    multi-pod?): ``single`` the (16, 16) pod, ``multi`` (2, 16, 16),
    ``custom:d,m`` a (d, m) (data, model) mesh."""
    from repro_torch.launch.mesh import make_mesh_for, make_production_mesh

    n, m, multi = mesh_shape(mesh_kind)
    fake_world(n)
    if mesh_kind.startswith("custom:"):
        return make_mesh_for(n, model_axis=m, device="cpu"), m, False
    return make_production_mesh(multi_pod=multi, device="cpu"), m, multi


def meta_dtensor(x: torch.Tensor, spec: tuple, mesh):
    """A DTensor of ``x``'s shape and dtype laid out by ``spec`` on
    ``mesh``, its local shard a meta tensor of the shape DTensor cuts for
    this rank."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    pl = placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    return DTensor.from_local(
        torch.empty(tuple(local), dtype=x.dtype, device="meta"), mesh, pl,
        run_check=False, shape=x.shape,
        stride=torch.empty(x.shape, device="meta").stride())


def meta_tree(tree: Any, specs: Any, mesh) -> Any:
    """``meta_dtensor`` of every leaf of ``tree`` by the spec tree
    ``specs`` (same structure)."""
    from repro_torch.sharding.specs import spec_leaves

    by = dict(spec_leaves(specs))
    return tree_map_with_path_names(
        lambda n, x: meta_dtensor(x, by[n], mesh), tree)


def meta_params(cfg: ModelConfig, dtype: torch.dtype) -> Any:
    """The parameter tree of ``cfg`` (``models.spec.model_param_specs``)
    as meta tensors of ``dtype`` (the JAX dry-run casts its parameters'
    specs to bf16, ``_cast_tree``)."""
    from repro_torch.models.init import _unflatten

    specs = S.model_param_specs(cfg)
    return _unflatten(specs, {
        name: torch.empty(shape, dtype=dtype, device="meta")
        for name, shape in S.leaves_with_names(specs)})


# ---------------------------------------------------------------------------
# what a traced step costs rank 0
def _propagating() -> bool:
    """Whether DTensor is propagating an op's sharding rather than running
    the rank's op: it runs the op, or its decomposition, on fake or meta
    tensors of the global shape (under a ``FakeTensorMode``, or from its
    sharding propagator's modules, once per new op signature)."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith(_PROPAGATION) and "tensor" in name:
            return True
        f = f.f_back
    return False


_PROPAGATION = ("_sharding_prop.py", "_decompositions.py")


class StepCosts(TorchDispatchMode):
    """Counts the local ops of a step run as DTensor operations (see the
    module docstring): FLOPs, bytes, collectives by kind, the ops, and
    the live and peak bytes of the storages the step allocates. A
    DTensor op is handed on to DTensor (its local ops come back here);
    the ops DTensor runs to propagate a sharding (``_propagating``) run
    uncounted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = CollectiveStats()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Any] = {}

    def kernel(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        kernels.META_SINKS.append(self.kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.META_SINKS.remove(self.kernel)
        return super().__exit__(*exc)

    def _freed(self, key: int, size: int, _ref) -> None:
        self._refs.pop(key, None)
        self.live -= size

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        size = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda r, key=key, size=size: self._freed(key, size, r))
        self.live += size
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in ins) or _propagating():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.ops += 1
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional":
            if not name.startswith(("wait", "_wrap")):
                self.collectives.add(FUNCTIONAL_KINDS.get(name, name),
                                     kernels.nbytes(*outs))
            return out
        packet = func.overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        in_st = {id(a.untyped_storage()) for a in ins}
        fresh = [o for o in outs if id(o.untyped_storage()) not in in_st]
        if fresh and not name.startswith("empty"):
            self.bytes += (kernels.nbytes(*ins) + kernels.nbytes(*fresh))
        for o in fresh:
            self._allocated(o)
        return out


# ---------------------------------------------------------------------------
# one step on the fake world
def _model(cfg: ModelConfig, ctx: ShardCtx, mesh):
    """The serving model: bf16 weights (the JAX dry-run's cast) laid out by
    ``param_pspecs``."""
    from repro_torch.models.model import DecoderLM

    cfg = replace(cfg, dtype="bfloat16")
    params = meta_params(cfg, torch.bfloat16)
    return DecoderLM.from_tree(cfg, meta_tree(
        params, param_pspecs(cfg, ctx, mesh), mesh)), cfg


def step_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, ctx: ShardCtx,
                optimizer, microbatches: int = 1):
    """(the step, its arguments, the donated ones) of ``shape.mode`` for
    ``cfg`` on ``mesh``, every argument a meta DTensor: train the train
    state (donated) and the batch; prefill the bf16 model's weights and
    the prompt; decode the weights, the cache (donated), the token and
    the cache length (a 0-d int32, as the JAX step's; the step reads a
    Python int)."""
    from repro_torch.models.model import (
        batch_specs,
        decode_step,
        layer_cache_spec,
        prefill,
    )

    b_specs = batch_specs(cfg, shape)
    b_ps = batch_pspecs(cfg, shape, ctx)
    if shape.mode == "train":
        from repro_torch.train import make_train_step
        from repro_torch.train.state import abstract_train_state

        state = meta_tree(abstract_train_state(cfg, optimizer),
                          train_state_pspecs(cfg, ctx, optimizer, mesh),
                          mesh)
        batch = meta_tree(b_specs, b_ps, mesh)
        step = make_train_step(cfg, optimizer, ctx, microbatches=microbatches)
        return (lambda: step(state, batch)), (state, batch), state
    model, mcfg = _model(cfg, ctx, mesh)
    weights = dict(model.named_parameters())
    if shape.mode == "prefill":
        tokens = meta_tree(b_specs, b_ps, mesh)["tokens"]
        return (lambda: prefill(model, tokens, cache_seq_len=shape.seq_len,
                                ctx=ctx)), (weights, tokens), None
    tokens = meta_dtensor(b_specs["tokens"], b_ps["tokens"], mesh)
    layer_ps = layer_cache_pspecs(mcfg, ctx)
    cache = [{name: meta_dtensor(
        torch.empty(shp, dtype=dt, device="meta"), layer_ps[i][name], mesh)
        for name, (shp, dt) in layer_cache_spec(
            mcfg, i, shape.global_batch, shape.seq_len,
            torch.bfloat16).items()} for i in range(mcfg.n_layers)]
    cache_len = b_specs["cache_len"]
    return (lambda: decode_step(model, cache, tokens, shape.seq_len - 1,
                                ctx=ctx)), (weights, cache, tokens,
                                            cache_len), cache


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, ctx: ShardCtx,
               optimizer, microbatches: int = 1) -> Dict[str, Any]:
    """Set up the step of ``shape.mode`` for ``cfg`` on ``mesh`` with meta
    inputs (``step_inputs``) and trace it under ``StepCosts``. Returns its
    costs, memory and the set-up's and trace's seconds."""
    t0 = time.time()
    run, args, alias = step_inputs(cfg, shape, mesh, ctx, optimizer,
                                   microbatches)
    setup_s = time.time() - t0
    costs = StepCosts()
    with costs:
        out = run()
    trace_s = time.time() - t0 - setup_s
    memory = {"argument_bytes": tree_bytes(args, local=True),
              "output_bytes": tree_bytes(out, local=True),
              "temp_bytes": int(costs.peak),
              "alias_bytes": tree_bytes(alias, local=True)}
    return {"flops": float(costs.flops), "bytes": float(costs.bytes),
            "coll": costs.collectives, "ops": costs.ops, "memory": memory,
            "setup_s": setup_s, "trace_s": trace_s}


def _probe_costs(cfg, shape, mesh, ctx, optimizer, microbatches):
    """Layer-delta cost probes: the step traced at L = 0, L = period and
    (where a tail exists) L = period + tail, the per-superblock delta
    scaled by the repeats. Probes use microbatches = 1, as the JAX
    dry-run's do (the FLOPs of a step do not depend on them)."""
    period, n_repeats, n_tail = S.layout(cfg)

    def costs_at(L):
        c = trace_step(replace(cfg, n_layers=L), shape, mesh, ctx,
                       optimizer, 1)
        return {"flops": c["flops"], "bytes": c["bytes"],
                "coll": float(c["coll"].total_bytes),
                "coll_by_kind": dict(c["coll"].bytes_by_kind),
                "loops": 0, "compile_s": c["trace_s"]}

    c0 = costs_at(0)
    c1 = costs_at(period)
    c2 = costs_at(period + n_tail) if n_tail else c1

    def scale(a, b, c):
        return a + n_repeats * (b - a) + (c - b)

    kinds = set(c0["coll_by_kind"]) | set(c1["coll_by_kind"]) | set(
        c2["coll_by_kind"])
    return {
        "flops_per_dev": scale(c0["flops"], c1["flops"], c2["flops"]),
        "bytes_per_dev": scale(c0["bytes"], c1["bytes"], c2["bytes"]),
        "collective_bytes_per_dev": scale(c0["coll"], c1["coll"],
                                          c2["coll"]),
        "collective_bytes_by_kind": {k: scale(
            *(c["coll_by_kind"].get(k, 0) for c in (c0, c1, c2)))
            for k in kinds},
        "residual_loops_in_probe": 0,
        "probe_compile_s": c0["compile_s"] + c1["compile_s"]
        + c2["compile_s"],
        "probe_points": {"L0": c0, "L_period": c1,
                         **({"L_period_tail": c2} if n_tail else {})},
    }


# ---------------------------------------------------------------------------
# one cell
def cell_ctx(shape: ShapeConfig, multi: bool, tp_size: int, dp_total: int,
             ctx_overrides: Optional[dict] = None) -> ShardCtx:
    """The cell's ``ShardCtx``: the JAX dry-run's defaults (``seq2d``
    where a decode batch does not cover the data axes) under the
    overrides."""
    kw = dict(ctx_overrides or {})
    refused = [k for k in kw if k in XLA_KNOBS]
    if refused:
        raise ValueError(f"--set {', '.join(refused)}: XLA knobs of the JAX "
                         "package with no reader in the port")
    if shape.mode == "decode" and shape.global_batch < dp_total:
        kw.setdefault("decode_kv_shard", "seq2d")
    kw.setdefault("dp_size", dp_total)
    kw.setdefault("tp_size", tp_size)
    return make_ctx(multi, **kw)


def mesh_shape(mesh_kind: str) -> tuple:
    """(ranks, model axis, multi-pod?) of ``mesh_kind``."""
    if mesh_kind.startswith("custom:"):
        d, m = (int(x) for x in mesh_kind.split(":")[1].split(","))
        return d * m, m, False
    if mesh_kind not in ("single", "multi"):
        raise ValueError(f"mesh must be single, multi or custom:d,m, got "
                         f"{mesh_kind!r}")
    return (512, 16, True) if mesh_kind == "multi" else (256, 16, False)


def cell_fields(arch: str, shape_name: str, mesh_kind: str, *,
                optimizer_name: str = "", cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """The record's fields that need no trace: the status (``SKIP`` with
    ``shape_applicable``'s reason), the chips, the optimizer, the
    parameter counts, the tokens of a step and the model's FLOPs."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "SKIP", "reason": why}
    n_params = count_params_analytic(cfg)
    n_active = count_params_analytic(cfg, active_only=True)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:
        tokens = shape.global_batch
        model_flops = 2.0 * n_active * tokens
    return {**head, "status": "OK", "n_chips": mesh_shape(mesh_kind)[0],
            "optimizer": optimizer_name or default_optimizer_for(n_params),
            "params_b": n_params / 1e9, "active_params_b": n_active / 1e9,
            "tokens_per_step": float(tokens),
            "model_flops_total": model_flops}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             ctx_overrides=None, microbatches: int = 1,
             optimizer_name: str = "", verbose: bool = True,
             probes: bool = True, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Trace one cell (``cfg`` and ``shape`` replace the arch's config and
    the named shape where given); returns its record (``SKIP`` where the
    shape does not apply). Raises where the step cannot be traced."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    fields = cell_fields(arch, shape_name, mesh_kind,
                         optimizer_name=optimizer_name, cfg=cfg, shape=shape)
    if fields["status"] == "SKIP":
        return fields
    mesh, tp_size, multi = make_mesh(mesh_kind)
    n_chips = fields["n_chips"]
    ctx = cell_ctx(shape, multi, tp_size, n_chips // tp_size, ctx_overrides)
    optimizer = get_optimizer(fields["optimizer"])

    full = trace_step(cfg, shape, mesh, ctx, optimizer, microbatches)
    raw_coll = full["coll"]
    probe = (_probe_costs(cfg, shape, mesh, ctx, optimizer, microbatches)
             if probes else None)
    flops_dev = probe["flops_per_dev"] if probe else full["flops"]
    bytes_dev = probe["bytes_per_dev"] if probe else full["bytes"]
    coll_dev = (probe["collective_bytes_per_dev"] if probe
                else float(raw_coll.total_bytes))
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll_dev / LINK_BW}
    dominant = max(terms, key=terms.get)
    model_flops = fields["model_flops_total"]
    mem = full["memory"]
    result = {
        **fields,
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": coll_dev,
        "collectives": {
            "bytes_by_kind": (probe or {}).get(
                "collective_bytes_by_kind", dict(raw_coll.bytes_by_kind)),
            "raw_scan_body_bytes_by_kind": dict(raw_coll.bytes_by_kind),
            "raw_scan_body_count_by_kind": dict(raw_coll.count_by_kind),
        },
        **terms,
        "dominant": dominant,
        "model_flops_ratio": (model_flops / (flops_dev * n_chips)
                              if flops_dev else 0.0),
        "memory": mem,
        "raw_cost_analysis": {"flops": full["flops"],
                              "bytes_accessed": full["bytes"]},
        "probe": probe,
        "lower_s": full["setup_s"],
        "compile_s": full["trace_s"],
        "ctx": dict(ctx_overrides or {}),
        "microbatches": microbatches,
        "chip": CHIP,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind}] OK "
              f"flops/dev={flops_dev:.3e} bytes/dev={bytes_dev:.3e} "
              f"coll/dev={coll_dev:.3e} dominant={dominant} "
              f"mfr={result['model_flops_ratio']:.3f} "
              f"mem(arg)={mem['argument_bytes'] / 2**30:.2f}GiB "
              f"mem(temp)={mem['temp_bytes'] / 2**30:.2f}GiB "
              f"trace={full['trace_s']:.1f}s", flush=True)
    return result


def record_cell(arch: str, shape_name: str, mesh_kind: str,
                **kw) -> Dict[str, Any]:
    """``run_cell``, with a cell that raises recorded as ``FAIL`` and its
    error."""
    try:
        return run_cell(arch, shape_name, mesh_kind, **kw)
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "FAIL", "error": repr(e)}


def parse_overrides(pairs) -> dict:
    """``--set k=v`` pairs as ShardCtx overrides: ``0`` / ``1`` as bools
    (but ``logit_chunk``), digits as ints, ``True`` / ``False``. The JAX
    package's XLA knobs are refused by name; any other name must be a
    ``ShardCtx`` field."""
    fields = {f.name for f in dataclasses.fields(ShardCtx)}
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if k in XLA_KNOBS:
            raise ValueError(f"--set {k}: an XLA knob of the JAX package "
                             "with no reader in the port")
        if k not in fields:
            raise ValueError(f"--set {k}: not a ShardCtx field "
                             f"({sorted(fields)})")
        if v in ("0", "1") and k != "logit_chunk":
            v = bool(int(v))
        elif v.isdigit():
            v = int(v)
        elif v in ("True", "False"):
            v = v == "True"
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both | custom:<data>,<model>")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/artifacts")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", dest="overrides",
                    help="ShardCtx overrides, e.g. --set seq_parallel=0")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip layer-delta cost probes (multi-pod pass only "
                    "needs the full trace)")
    args = ap.parse_args(argv)

    archs = arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = parse_overrides(args.overrides)

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                fname = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh}{tag}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[{arch} x {shape} x {mesh}] exists, skipping")
                    continue
                res = record_cell(
                    arch, shape, mesh, ctx_overrides=overrides,
                    microbatches=args.microbatches,
                    optimizer_name=args.optimizer,
                    probes=not args.no_probes and mesh != "multi")
                if res["status"] == "FAIL":
                    failures.append((arch, shape, mesh))
                with open(fname, "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete.")


if __name__ == "__main__":
    main()
