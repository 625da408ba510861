"""Rank programs of ``tests/test_torch_train_mesh.py``: one gloo world of
8 CPU ranks (``launch.mesh.spawn_world``) runs every case in turn and
returns what the test holds to the JAX package and to the port's own
unsharded runs. Not a test module."""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch

from repro_torch.utils.tree import tree_leaves_with_names as tree_leaves

STEPS, BATCH, SEQ = 3, 8, 64
# the leaves a summary keeps, where the arch has no tail layer
BODY_LEAVES = ("emb", "body/0/wq", "body/0/ln1", "final_ln")


def case_configs() -> dict:
    """name -> (arch, config, (data, model) mesh, optimizer, leaves)."""
    from repro_torch.configs import acceptance as A
    from repro_torch.configs import get_arch, reduced

    return {
        # H 4, Kv 2 over a model axis of 4: q's heads split, k and v whole
        "qwen3": ("qwen3-4b", reduced(get_arch("qwen3-4b")), (2, 4),
                  "adamw", BODY_LEAVES),
        # 6 window layers (16) and 2 global ones, Kv 1: 2 local q heads
        "gemma": ("gemma3-1b", dataclasses.replace(
            reduced(get_arch("gemma3-1b")), n_layers=8, swa_window=16),
            (4, 2), "adamw", A.TRAIN_LEAVES),
        # FSDP alone, Adafactor's factored moments
        "granite": ("granite-3-8b", reduced(get_arch("granite-3-8b")),
                    (8, 1), "adafactor", BODY_LEAVES),
    }


def elastic_state():
    """A reduced granite-3-8b AdamW state at step 3 with random moments:
    what the elastic restore saves (made the same on every rank and in
    the test's process)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.optim import AdamW
    from repro_torch.train import create_train_state
    from repro_torch.utils.tree import tree_map

    cfg = reduced(get_arch("granite-3-8b"))
    opt = AdamW()
    state = create_train_state(cfg, opt, torch.Generator().manual_seed(1),
                               "cpu")
    gen = torch.Generator().manual_seed(2)
    state["opt"] = tree_map(lambda t: torch.randn(t.shape, generator=gen),
                            state["opt"])
    state["step"] = torch.tensor(3, dtype=torch.int32)
    return cfg, opt, state


def _digest(tree) -> str:
    import hashlib

    from repro_torch.optim.base import plain
    from repro_torch.utils.tree import tree_leaves_with_names

    h = hashlib.sha256()
    for name, x in tree_leaves_with_names(tree):
        h.update(name.encode())
        h.update(plain(x).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _elastic(work: str, rank: int) -> dict:
    """(2, 4) -> save -> (8, 1) and (1, 1): every leaf bit for bit."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import (
        distribute,
        named_shardings,
        train_state_pspecs,
    )

    cfg, opt, state = elastic_state()
    directory = os.path.join(work, "elastic")
    mesh24 = make_mesh_for(model_axis=4, device="cpu")
    specs24 = train_state_pspecs(cfg, make_ctx(False, tp_size=4, dp_size=2),
                                 opt, mesh24)
    save(directory, 3, distribute(state, specs24, mesh24))
    mesh81 = make_mesh_for(model_axis=1, device="cpu")
    specs81 = train_state_pspecs(cfg, make_ctx(False, tp_size=1, dp_size=8),
                                 opt, mesh81)
    on81 = restore(directory, 3, state,
                   shardings=named_shardings(specs81, mesh81))
    on11 = restore(directory, 3, state)
    return {"saved": _digest(state), "on_8x1": _digest(on81),
            "on_1x1": _digest(on11), "placements_8x1": {
                "emb": str(on81["params"]["emb"].placements),
                "opt/m/body/0/wq": str(
                    on81["opt"]["m"]["body"][0]["wq"].placements)}}


def launcher_args(directory: str, *extra) -> list:
    return ["--arch", "qwen3-4b", "--reduced", "--batch", "8", "--seq",
            "32", "--steps", "4", "--warmup", "1", "--log-every", "1",
            "--device", "cpu", "--model-axis", "2", "--ckpt", directory,
            "--ckpt-every", "2", *extra]


def _launcher(work: str, rank: int) -> dict:
    """``launch.train.main --model-axis 2`` on (4, 2): 4 steps whole, then
    from the first run's checkpoint after step 2 with ``--resume``."""
    import torch.distributed as dist

    from repro_torch.launch import train

    whole, resumed = (os.path.join(work, n) for n in ("whole", "resumed"))
    first = train.main(launcher_args(whole))
    if rank == 0:
        os.makedirs(resumed)
        shutil.copytree(os.path.join(whole, "step_0000000001"),
                        os.path.join(resumed, "step_0000000001"))
    dist.barrier()
    second = train.main(launcher_args(resumed, "--resume"))
    return {"whole": first, "resumed": second}


def staged_case(rank: int) -> dict:
    """``launch.mesh.staged`` (the host route of the all-gather on card
    tensors, called here on CPU tensors) against the functional
    all-gather itself, over the 8 ranks, with its counts."""
    from repro_torch.launch.mesh import STAGED, make_mesh_for, staged

    mesh = make_mesh_for(model_axis=1, device="cpu")
    group = mesh.get_group(0).group_name
    op = torch.ops._c10d_functional.all_gather_into_tensor.default
    x = torch.arange(6, dtype=torch.float32) + 10 * rank
    before = dict(STAGED)
    got = staged(op)(x, 8, group)
    want = torch.ops._c10d_functional.wait_tensor(op(x, 8, group))
    return {"equal": torch.equal(got, want), "shape": tuple(got.shape),
            "calls": STAGED["calls"] - before["calls"],
            "bytes": STAGED["bytes"] - before["bytes"]}


def attention_case(rank: int) -> dict:
    """``models.layers.local_attention`` against the plain attention, the
    output and q's, k's and v's gradients (the largest difference over
    the largest value), on (2, 4) and (4, 2): H 4 / Kv
    2 and H 8 / Kv 2 (q's heads split, k and v whole, whole groups a
    rank), H 12 / Kv 3 over a model axis of 2 (a rank's q heads straddle
    two groups) and H 8 / Kv 4 on (2, 4) (k and v split too)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.kernels.flash_attn import attention_torch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.layers import local_attention
    from repro_torch.sharding.specs import placements

    out = {}
    for model, h, kv, window in ((4, 4, 2, 0), (4, 8, 2, 8), (2, 12, 3, 0),
                                 (4, 8, 4, 0)):
        mesh = make_mesh_for(model_axis=model, device="cpu")
        gen = torch.Generator().manual_seed(h * 10 + kv)
        q = torch.randn(4, 24, h, 16, generator=gen)
        k, v = (torch.randn(4, 24, kv, 16, generator=gen) for _ in range(2))
        w = torch.randn(4, 24, h, 16, generator=gen)
        heads = lambda n: "model" if n % model == 0 else None  # noqa: E731
        leaves = [distribute_tensor(
            t, mesh, placements(("data", None, heads(t.shape[2]), None),
                                mesh), src_data_rank=None
        ).requires_grad_(True) for t in (q, k, v)]
        got = local_attention(*leaves, causal=True, window=window)
        gg = torch.autograd.grad(
            (got * distribute_tensor(w, mesh, got.placements,
                                     src_data_rank=None)).sum().full_tensor(),
            leaves)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = attention_torch(*plain, causal=True, window=window)
        gw = torch.autograd.grad((want * w).sum(), plain)
        rel = lambda a, b: float(  # noqa: E731
            (a.full_tensor() - b).abs().max() / b.abs().max())
        out[f"H{h}/Kv{kv}/tp{model}"] = {
            "out": rel(got, want),
            **{f"d{n}": rel(a, b) for n, a, b in zip("qkv", gg, gw)}}
    return out


def step_cases(rank: int) -> dict:
    """Reduced qwen3-4b on (2, 4), one f32 step each way: the guard (a NaN
    in one parameter: the step skipped, every leaf kept bit for bit, the
    step count advanced) and remat "layer" against "block" (the same
    loss, norm and new state, bit for bit). Then what the forward of a
    bfloat16 model receives (``forward_train`` stood in for, nothing run
    past it): with ``cast_params_bf16`` bf16 DTensors laid out as their
    f32 masters (the cast on the shards, before any gather), without it
    the f32 masters themselves."""
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.data.synth_lm import lm_batch_at
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.optim import AdamW
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import (
        batch_pspecs,
        distribute,
        train_state_pspecs,
    )
    from repro_torch.train import create_train_state, make_train_step
    from repro_torch.train import train_step as TS

    mesh = make_mesh_for(model_axis=4, device="cpu")
    out = {}

    def one(cfg, ctx, plant=False):
        opt = AdamW(lr=1e-3)
        state = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                   "cpu")
        if plant:
            state["params"]["final_ln"][3] = float("nan")
        state = distribute(state, train_state_pspecs(cfg, ctx, opt, mesh),
                           mesh)
        batch = distribute(lm_batch_at(0, vocab=cfg.vocab, batch=8,
                                       seq_len=32, device="cpu"),
                           batch_pspecs(cfg, ShapeConfig("s", 32, 8, "train"),
                                        ctx), mesh)
        new, m = make_train_step(cfg, opt, ctx)(state, batch)
        return state, new, {k: float(v) for k, v in m.items()}

    cfg = reduced(get_arch("qwen3-4b"))
    ctx = make_ctx(False, tp_size=4, dp_size=2)
    old, new, m = one(cfg, ctx, plant=True)
    out["guard"] = {"skipped": m["skipped"], "step": int(
        new["step"].full_tensor()), "kept": _digest(old["params"])
        == _digest(new["params"]) and _digest(old["opt"])
        == _digest(new["opt"])}
    (_, a, ma), (_, b, mb) = one(cfg, ctx), one(cfg, ctx.with_(remat="layer"))
    out["block = layer"] = ma == mb and _digest(a) == _digest(b)

    class Seen(Exception):
        pass

    def seen(params, batch, cfg, ctx):
        raise Seen({n: (str(x.dtype), str(tuple(x.placements)))
                    for n, x in tree_leaves(params)})

    real, TS.forward_train = TS.forward_train, seen
    try:
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        for cast in (True, False):
            try:
                one(bf, ctx.with_(cast_params_bf16=cast))
            except Seen as e:
                out[f"cast {cast}"] = e.args[0]
    finally:
        TS.forward_train = real
    masters = dict(tree_leaves(distribute(
        create_train_state(bf, AdamW(), torch.Generator().manual_seed(0),
                           "cpu")["params"],
        train_state_pspecs(bf, ctx, AdamW(), mesh)["params"], mesh)))
    out["masters"] = {n: (str(x.dtype), str(tuple(x.placements)))
                      for n, x in masters.items()}
    return out


def mesh_cases(fmesh, work: str) -> dict:
    """Every case, in one world (rank ``fmesh.rank`` of 8)."""
    from repro_torch.configs import acceptance as A
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import seeded_numpy_params

    torch.set_num_threads(1)
    out = {}
    for name, (_, cfg, (data, model), opt, leaves) in case_configs().items():
        mesh = make_mesh_for(model_axis=model, device="cpu")
        assert mesh.shape == (data, model)
        got, launches, _ = A.run_train(
            cfg, seeded_numpy_params(cfg, A.LM_SEED), "cpu", steps=STEPS,
            batch=BATCH, seq=SEQ, optimizer=opt, mesh=mesh, leaves=leaves)
        out[name] = {"summary": got, "launches": launches}
    out["production"] = []
    for multi in (False, True):
        try:
            from repro_torch.launch.mesh import make_production_mesh

            make_production_mesh(multi_pod=multi, device="cpu")
        except RuntimeError as e:        # the refusal is the result
            out["production"].append(str(e))
    out["staged"] = staged_case(fmesh.rank)
    out["attention"] = attention_case(fmesh.rank)
    out["steps"] = step_cases(fmesh.rank)
    out["elastic"] = _elastic(work, fmesh.rank)
    out["launcher"] = _launcher(work, fmesh.rank)
    return out


__all__ = ["mesh_cases", "case_configs", "elastic_state", "launcher_args",
           "STEPS", "BATCH", "SEQ", "BODY_LEAVES"]
