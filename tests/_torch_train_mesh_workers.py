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
    """name -> (arch, config, (data, model) mesh, optimizer, leaves). An
    MoE layer routes groups of the mesh's data axis (``moe.n_groups``)."""
    from repro_torch.configs import acceptance as A
    from repro_torch.configs import get_arch, reduced

    mixtral = reduced(get_arch("mixtral-8x22b"))
    return {
        # expert parallelism: 4 experts over a model axis of 4, G = 2;
        # capacity factor 1 (C = 128 of a group's 512 slots): slots drop
        "mixtral": ("mixtral-8x22b", dataclasses.replace(
            mixtral, moe=dataclasses.replace(mixtral.moe,
                                             capacity_factor=1.0)),
            (2, 4), "adamw", ("emb", "body/0/e_wg", "body/0/router",
                              "body/0/wq")),
        # 4 experts over 8: d_ff split inside the experts; the 4 heads
        # whole
        "grok": ("grok-1-314b", reduced(get_arch("grok-1-314b")), (1, 8),
                 "adamw", ("emb", "body/0/e_wo", "body/0/router",
                           "body/0/wo")),
        # Mamba (64 local channels), attention and experts (EP over 2):
        # the first 4 layers of the period (Mamba, Mamba + MoE, Mamba,
        # attention + MoE)
        "jamba": ("jamba-1.5-large-398b", dataclasses.replace(
            reduced(get_arch("jamba-1.5-large-398b")), n_layers=4), (4, 2),
            "adamw", ("emb", "tail/0/x_proj", "tail/0/A_log",
                      "tail/3/e_wo")),
        # mLSTM and sLSTM cells on each rank's local batch
        "xlstm": ("xlstm-125m", reduced(get_arch("xlstm-125m")), (2, 4),
                  "adamw", ("emb", "body/0/up", "body/3/r", "body/3/w")),
        # the gated cross-attention onto 16 vision tokens, xgate opened
        "vlm": ("llama-3.2-vision-11b",
                reduced(get_arch("llama-3.2-vision-11b")), (2, 4), "adamw",
                ("emb", "body/1/xq", "body/1/lnx", "body/0/wq")),
        # the encoder over 24 frames, the cross-attentions onto them
        "whisper": ("whisper-small", reduced(get_arch("whisper-small")),
                    (2, 4), "adamw", ("emb", "encoder/layers/wq",
                                      "xattn_body/0/xk", "body/0/wq")),
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


def case_tree(cfg) -> dict:
    """A case's initial weights (numpy, the JAX layout): the seeded
    draw, a VLM's ``xgate`` opened so its cross-attention counts from the
    first step."""
    from repro_torch.configs import acceptance as A
    from repro_torch.models import seeded_numpy_params

    tree = seeded_numpy_params(cfg, A.LM_SEED)
    return A.open_xgate(tree) if cfg.n_vision_tokens else tree


def elastic_state(arch: str = "granite-3-8b"):
    """A reduced ``arch`` AdamW state at step 3 with random moments: what
    the elastic restore saves (made the same on every rank and in the
    test's process)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.optim import AdamW
    from repro_torch.train import create_train_state
    from repro_torch.utils.tree import tree_map

    cfg = reduced(get_arch(arch))
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


def _elastic(work: str, rank: int, arch: str = "granite-3-8b",
             leaf: str = "wq", name: str = "elastic") -> dict:
    """(2, 4) -> save under ``work/name`` -> (8, 1) and (1, 1): every leaf
    bit for bit."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import (
        distribute,
        named_shardings,
        train_state_pspecs,
    )

    cfg, opt, state = elastic_state(arch)
    directory = os.path.join(work, name)
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
                f"opt/m/body/0/{leaf}": str(
                    on81["opt"]["m"]["body"][0][leaf].placements)}}


def launcher_args(directory: str, *extra, arch: str = "qwen3-4b") -> list:
    return ["--arch", arch, "--reduced", "--batch", "8", "--seq",
            "32", "--steps", "4", "--warmup", "1", "--log-every", "1",
            "--device", "cpu", "--model-axis", "2", "--ckpt", directory,
            "--ckpt-every", "2", *extra]


def _launcher(work: str, rank: int, arch: str = "qwen3-4b") -> dict:
    """``launch.train.main --model-axis 2`` on (4, 2): 4 steps whole, then
    from the first run's checkpoint after step 2 with ``--resume``."""
    import torch.distributed as dist

    from repro_torch.launch import train

    whole, resumed = (os.path.join(work, arch, n)
                      for n in ("whole", "resumed"))
    first = train.main(launcher_args(whole, arch=arch))
    if rank == 0:
        os.makedirs(resumed)
        shutil.copytree(os.path.join(whole, "step_0000000001"),
                        os.path.join(resumed, "step_0000000001"))
    dist.barrier()
    second = train.main(launcher_args(resumed, "--resume", arch=arch))
    return {"whole": first, "resumed": second}


def dropped_case(rank: int) -> dict:
    """The mixtral case's forward on its (2, 4) mesh at its first batch,
    under ``moe.record_routing``: the slots each MoE layer dropped in this
    rank's groups, with the rank's (data, model) coordinate."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs import acceptance as A
    from repro_torch.data.synth_lm import lm_batch_at
    from repro_torch.interop import tree_from_numpy
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model import forward_train
    from repro_torch.models.moe import record_routing
    from repro_torch.sharding.ctx import make_ctx
    from repro_torch.sharding.specs import (
        batch_pspecs,
        distribute,
        param_pspecs,
    )

    _, cfg, (data, model), _, _ = case_configs()["mixtral"]
    mesh = make_mesh_for(model_axis=model, device="cpu")
    ctx = make_ctx(False, tp_size=model, dp_size=data)
    params = distribute(tree_from_numpy(case_tree(cfg), "cpu"),
                        param_pspecs(cfg, ctx, mesh), mesh)
    batch = distribute(lm_batch_at(0, vocab=cfg.vocab, batch=BATCH,
                                   seq_len=SEQ, seed=A.TRAIN_DATA_SEED,
                                   device="cpu"),
                       batch_pspecs(cfg, ShapeConfig("d", SEQ, BATCH,
                                                     "train"), ctx), mesh)
    with torch.no_grad(), record_routing() as seen:
        forward_train(params, batch, cfg, ctx)
    return {"coordinate": tuple(mesh.get_coordinate()),
            "dropped": [int((~r.keep).sum()) for r in seen]}


def scan_case(rank: int) -> dict:
    """``models.layers.local_scan`` against the plain fused scan on the
    whole tensors, on (4, 2) and (2, 4): the output's and the final
    state's largest difference, and each input's gradient's largest
    difference over its largest value (B, S, di, ds = 8, 24, 32, 8; the
    batch over data, the channels over model)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.kernels.selective_scan import mamba_scan_torch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.layers import local_scan
    from repro_torch.sharding.specs import placements

    names = ("xb", "dt_proj", "dt_b", "A", "Bc", "Cc", "z", "D_skip")
    specs = (("data", None, "model"), ("data", None, "model"), ("model",),
             ("model", None), ("data", None, None), ("data", None, None),
             ("data", None, "model"), ("model",))
    out = {}
    for model in (2, 4):
        mesh = make_mesh_for(model_axis=model, device="cpu")
        gen = torch.Generator().manual_seed(model)
        B, S, di, ds = 8, 24, 32, 8
        shapes = ((B, S, di), (B, S, di), (di,), (di, ds), (B, S, ds),
                  (B, S, ds), (B, S, di), (di,))
        ins = [torch.randn(sh, generator=gen) for sh in shapes]
        ins[3] = -torch.exp(ins[3])           # A < 0
        w = torch.randn(B, S, di, generator=gen)
        leaves = [distribute_tensor(t, mesh, placements(sp, mesh),
                                    src_data_rank=None).requires_grad_(True)
                  for t, sp in zip(ins, specs)]
        got, final = local_scan(*leaves)
        gg = torch.autograd.grad((got * distribute_tensor(
            w, mesh, got.placements, src_data_rank=None)).sum().full_tensor(),
            leaves)
        plain = [t.clone().requires_grad_(True) for t in ins]
        want, want_final = mamba_scan_torch(*plain)
        gw = torch.autograd.grad((want * w).sum(), plain)
        out[f"tp{model}"] = {
            "out": float((got.full_tensor() - want).abs().max()),
            "final": float((final.full_tensor() - want_final).abs().max()),
            "placements": str(got.placements),
            **{f"d{n}": float((a.full_tensor() - b).abs().max()
                              / b.abs().max())
               for n, a, b in zip(names, gg, gw)}}
    return out


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

    torch.set_num_threads(1)
    out = {}
    for name, (_, cfg, (data, model), opt, leaves) in case_configs().items():
        mesh = make_mesh_for(model_axis=model, device="cpu")
        assert mesh.shape == (data, model)
        got, launches, _ = A.run_train(
            cfg, case_tree(cfg), "cpu", steps=STEPS, batch=BATCH, seq=SEQ,
            optimizer=opt, mesh=mesh, leaves=leaves)
        out[name] = {"summary": got, "launches": launches}
    out["dropped"] = dropped_case(fmesh.rank)
    out["scan"] = scan_case(fmesh.rank)
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
    out["elastic_moe"] = _elastic(work, fmesh.rank, "mixtral-8x22b", "e_wg",
                                  "elastic_moe")
    out["launcher"] = _launcher(work, fmesh.rank)
    out["launcher_jamba"] = _launcher(work, fmesh.rank,
                                      "jamba-1.5-large-398b")
    return out


__all__ = ["mesh_cases", "case_configs", "case_tree", "elastic_state",
           "launcher_args", "STEPS", "BATCH", "SEQ", "BODY_LEAVES"]
