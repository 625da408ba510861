"""Rank programs of ``tests/test_torch_serve_mesh.py``: one gloo world of
4 CPU ranks (``launch.mesh.spawn_world``) serves every case and returns
what the test holds to the JAX package. Not a test module.

The world holds three meshes: (2, 2) over its 4 ranks, and (1, 2) over
ranks 0-1 beside (2, 1) over ranks 2-3, which serve at the same time."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ARCHS = ("gemma3-1b", "qwen3-4b")
KV_SHARDS = ("seq", "seq2d", "head", "none")
MESHES = ((1, 2), (2, 1), (2, 2))
# gemma's window layers keep a ring of 8 slots: the 15-token prompt wraps
# it at prefill, and the decode steps at positions 15 and 16 write slots 7
# and 0, across the wrap
BATCH, PROMPT, DECODE, WINDOW = 2, 15, 2, 8
GENERATE_ARCH = "gemma3-1b"     # ``generate`` on (2, 2) under "seq2d"


def case_config(arch: str):
    """A case's reduced config: gemma3-1b's cut to one window layer with
    a ring of 8 slots and one global layer (its pattern of five window
    layers and a global one, shortened), Kv 1; qwen3-4b's 2 global layers,
    Kv 2."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ATTN, ATTN_LOCAL

    cfg = reduced(get_arch(arch))
    if cfg.block_pattern is not None:
        cfg = dataclasses.replace(cfg, swa_window=WINDOW, n_layers=2,
                                  block_pattern=(ATTN_LOCAL, ATTN))
    return cfg


def case_tokens(cfg) -> np.ndarray:
    """(B, prompt + decode) int32: the prompt, then the decode steps'
    tokens."""
    from repro_torch.configs import acceptance as A

    rng = np.random.default_rng(A.LM_TOKEN_SEED)
    return rng.integers(0, cfg.vocab, (BATCH, PROMPT + DECODE),
                        dtype=np.int32)


def case_tree(cfg):
    from repro_torch.configs import acceptance as A
    from repro_torch.models import seeded_numpy_params

    return seeded_numpy_params(cfg, A.LM_SEED)


class _Gathers(torch.utils._python_dispatch.TorchDispatchMode):
    """The input shapes of the all-gathers this rank issues (DTensor ops
    are handed on to DTensor, whose collectives come back here)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.all_gather_into_tensor.default:
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def _layout_faults(cache, specs, mesh) -> list:
    from repro_torch.sharding.specs import placements

    return [(i, name, str(t.placements), specs[i][name])
            for i, entry in enumerate(cache) for name, t in entry.items()
            if tuple(t.placements) != placements(specs[i][name], mesh)]


def serve(cfg, tree, toks, mesh, data: int, model_axis: int, kv: str,
          model=None) -> dict:
    """Prefill the prompt and run the decode steps on ``mesh`` under
    ``decode_kv_shard=kv``: every step's logits (whole, on this rank),
    the cache leaves whose layout left ``layer_cache_pspecs`` after any
    step, and the local shapes of the cache leaves beside the shapes of
    the decode steps' all-gathers."""
    from repro_torch.models.layers import local_box
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import (
        batch_pspecs,
        distribute_leaf,
        layer_cache_pspecs,
    )

    ctx = make_ctx(False, tp_size=model_axis, dp_size=data,
                   decode_kv_shard=kv)
    prompt_spec = batch_pspecs(cfg, _Shape("prefill"), ctx)["tokens"]
    token_spec = batch_pspecs(cfg, _Shape("decode"), ctx)["tokens"]
    specs = layer_cache_pspecs(cfg, ctx)
    logits, cache = prefill(
        model, distribute_leaf(toks[:, :PROMPT], prompt_spec, mesh),
        cache_seq_len=PROMPT + DECODE, ctx=ctx)
    out, faults, gathers = [logits.full_tensor()], [], []
    faults += _layout_faults(cache, specs, mesh)
    for i in range(DECODE):
        pos = PROMPT + i
        with _Gathers() as g:
            logits, cache = decode_step(
                model, cache, distribute_leaf(toks[:, pos:pos + 1],
                                              token_spec, mesh), pos,
                ctx=ctx)
        gathers += g.shapes
        out.append(logits.full_tensor())
        faults += _layout_faults(cache, specs, mesh)
    leaves = sorted({local_box(t)[0] for entry in cache
                     for t in entry.values()})
    return {"logits": torch.stack(out).numpy(), "faults": faults,
            "gathers": sorted(set(gathers)), "cache_shapes": leaves}


@dataclasses.dataclass(frozen=True)
class _Shape:
    mode: str


def serve_cases(fmesh) -> dict:
    """Every case this rank serves: (arch, (data, model), kv) -> ``serve``'s
    result."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models.model import DecoderLM
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import distribute, param_pspecs
    from repro_torch.utils.tree import tree_map

    torch.set_num_threads(1)    # four ranks share the host's cores
    names = ("data", "model")
    whole = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                       mesh_dim_names=names)
    pair = {(1, 2): DeviceMesh("cpu", torch.tensor([[0, 1]]),
                               mesh_dim_names=names),
            (2, 1): DeviceMesh("cpu", torch.tensor([[2], [3]]),
                               mesh_dim_names=names)}
    mine = [((2, 2), whole), ((1, 2), pair[(1, 2)]) if fmesh.rank < 2
            else ((2, 1), pair[(2, 1)])]
    out = {}
    for arch in ARCHS:
        cfg = case_config(arch)
        tree = tree_map(torch.from_numpy, case_tree(cfg))
        toks = torch.from_numpy(case_tokens(cfg))
        for (d, m), mesh in mine:
            ctx = make_ctx(False, tp_size=m, dp_size=d)
            model = DecoderLM.from_tree(cfg, distribute(
                tree, param_pspecs(cfg, ctx, mesh), mesh))
            for kv in KV_SHARDS:
                out[(arch, (d, m), kv)] = serve(cfg, tree, toks, mesh, d, m,
                                                kv, model)
            if (d, m) == (2, 2) and arch == GENERATE_ARCH:
                out["generate"] = _generate(cfg, tree, toks, mesh, model)
    return out


def _generate(cfg, tree, toks, mesh, model) -> tuple:
    """``generate``'s greedy tokens on the (2, 2) mesh under ``"seq2d"``
    and on one device, from the prompt."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import distribute_leaf
    from repro_torch.train.serve_step import generate

    ctx = make_ctx(False, tp_size=2, dp_size=2, decode_kv_shard="seq2d")
    prompt = toks[:, :PROMPT].contiguous()
    got = generate(model, distribute_leaf(prompt, (ctx.axis("dp"), None),
                                          mesh), DECODE + 1, ctx=ctx)
    want = generate(DecoderLM.from_tree(cfg, tree), prompt, DECODE + 1)
    return got.numpy(), want.numpy()
