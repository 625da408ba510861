"""LM training launcher (the JAX package's ``repro.launch.train``): any
``--arch`` (full or ``--reduced``), the deterministic synthetic corpus
(``data.synth_lm``), the optimizer the JAX package picks for the model's
size (AdamW under 100e9 parameters, else Adafactor) on a cosine schedule
with warm-up, asynchronous checkpoints in the JAX package's format and
exact resume (seekable data + monotone step dirs), so a run either package
checkpointed resumes in the other. ``src/repro_torch/examples/train_lm.py``
drives this module.

The same flags as the JAX package's launcher, plus ``--device`` (default:
the CUDA card) and ``--dtype`` (the compute dtype; default: the arch's). Without a process group it trains on one device. In an
initialised process group of W ranks (``torchrun``, or the ranks of
``launch.mesh.spawn_world``; the JAX launcher counts ``jax.devices()``)
it trains on a (data, model) mesh of W / M x M ranks, M =
``--model-axis`` (``launch.mesh.make_mesh_for``): the state is
distributed by ``train_state_pspecs`` (FSDP over ``data``, TP over
``model``), each batch by ``batch_pspecs``, the step runs on DTensors, and
checkpoints are gathered to rank 0 and restore onto any mesh. Every
family trains on a mesh; a VLM's vision tokens and whisper's audio frames
are laid out (dp, None, None) by ``batch_pspecs``, drawn on rank 0 and
broadcast (the corpus keys them by a hash Python salts per process, so
each rank would draw its own). Only rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 20 --batch 4 --seq 1024 --ckpt build/train/gemma [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 200 --batch 8 --seq 256 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m \\
      repro_torch.launch.train --arch qwen3-4b --reduced --model-axis 2 \\
      --steps 20 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m \\
      repro_torch.launch.train --arch jamba-1.5-large-398b --reduced \\
      --model-axis 2 --steps 20 --batch 8 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data.synth_lm import lm_batch_at
from repro_torch.models import count_params_analytic
from repro_torch.optim import cosine_warmup, default_optimizer_for, get_optimizer
from repro_torch.optim.base import plain
from repro_torch.sharding.ctx import UNSHARDED, make_ctx
from repro_torch.train import (
    create_train_state,
    make_train_step,
    train_state_pspecs,
)
from repro_torch.utils.device import exact_matmul, resolve_device


def extras_of(cfg) -> dict:
    """The memory inputs of a batch, name -> shape after the batch axis."""
    extras = {}
    if cfg.n_vision_tokens:
        extras["vision"] = (cfg.n_vision_tokens, cfg.d_model)
    if cfg.enc_dec:
        extras["audio"] = (cfg.n_audio_frames, cfg.d_model)
    return extras


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default=None, choices=[None, "int8"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"],
                    help="compute dtype (default: the arch's)")
    return ap.parse_args(argv)


def _world() -> int:
    """The initialised process group's size, or 0 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 0


def run(args: argparse.Namespace, init=None, cfg=None) -> tuple:
    """Train as ``args`` say; returns (the logged history, the final
    state). ``init``: a parameter tree in the JAX package's layout (f32
    numpy arrays or tensors) to start from instead of the seeded random
    init. ``cfg``: the model's config in place of ``--arch``'s (with
    ``--reduced`` and ``--dtype``), for a model the flags cannot name,
    such as an arch cut to fewer layers."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_matmul()
    world = _world()
    lead = world == 0 or torch.distributed.get_rank() == 0
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
    n_params = count_params_analytic(cfg)
    if lead:
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
              f"(reduced={args.reduced})")

    optimizer = get_optimizer(default_optimizer_for(n_params),
                              lr=cosine_warmup(args.lr, args.warmup,
                                               args.steps))
    mesh, ctx, put = None, UNSHARDED, lambda tree, specs: tree
    if world:
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.sharding.specs import (
            batch_pspecs,
            distribute,
            named_shardings,
        )

        mesh = make_mesh_for(model_axis=args.model_axis, device=dev.type)
        ctx = make_ctx(False, tp_size=args.model_axis,
                       dp_size=world // args.model_axis)
        state_ps = train_state_pspecs(cfg, ctx, optimizer, mesh)
        batch_ps = batch_pspecs(cfg, ShapeConfig("cli", args.seq,
                                                 args.batch, "train"), ctx)
        put = lambda tree, specs: distribute(tree, specs, mesh)  # noqa: E731
    elif args.model_axis != 1:
        raise ValueError(
            f"--model-axis {args.model_axis}: sharding over a model axis "
            "needs a world of ranks: run under torchrun or "
            "launch.mesh.spawn_world")

    if init is None:
        gen = torch.Generator(dev).manual_seed(args.seed)
        state = create_train_state(cfg, optimizer, gen, dev)
    else:
        from repro_torch.interop import tree_from_numpy

        params = tree_from_numpy(init, dev)
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        del params
    start = 0
    s0 = latest_step(args.ckpt) if args.ckpt and args.resume else None
    if s0 is not None:
        state = restore(args.ckpt, s0, state, shardings=named_shardings(
            state_ps, mesh) if mesh is not None else None)
        start = int(plain(state["step"]))
        if lead:
            print(f"resumed from step {start}")
    elif mesh is not None:
        state = put(state, state_ps)

    step_fn = make_train_step(cfg, optimizer, ctx,
                              microbatches=args.microbatches,
                              compress=args.compress)
    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    extras = extras_of(cfg)

    history = []
    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        batch = lm_batch_at(step, vocab=cfg.vocab, batch=args.batch,
                            seq_len=args.seq, seed=args.seed,
                            extras=extras or None, device=dev)
        if mesh is not None:
            for name in extras:
                torch.distributed.broadcast(batch[name], 0)
            batch = put(batch, batch_ps)
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            m.update(step=step, tok_per_s=tokens_done / max(dt, 1e-9))
            history.append(m)
            if lead:
                print(f"step {step:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.2f} "
                      f"tok/s={m['tok_per_s']:,.0f}"
                      + (" SKIPPED" if m["skipped"] else ""))
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, state)
    if ckpt:
        ckpt.wait()
        if world > 1:
            torch.distributed.barrier()   # rank 0's write is complete
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return history, state


def main(argv=None):
    """The launcher. Started by ``torchrun`` (``WORLD_SIZE`` and ``RANK``
    in the environment, no process group yet), it joins that world first:
    nccl with rank r on ``cuda:LOCAL_RANK``, gloo for ``--device cpu``."""
    import os

    import torch.distributed as dist

    args = parse_args(argv)
    joined = "WORLD_SIZE" in os.environ and "RANK" in os.environ \
        and not dist.is_initialized()
    if joined:
        cpu = resolve_device(args.device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl")
    try:
        return run(args)[0]
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
