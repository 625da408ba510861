"""LM training launcher on one card (the JAX package's ``repro.launch.train``):
any ``--arch`` (full or ``--reduced``), the deterministic synthetic corpus
(``data.synth_lm``), the optimizer the JAX package picks for the model's
size (AdamW under 100e9 parameters, else Adafactor) on a cosine schedule
with warm-up, asynchronous checkpoints in the JAX package's format and
exact resume (seekable data + monotone step dirs), so a run either package
checkpointed resumes in the other. ``src/repro_torch/examples/train_lm.py``
drives this module.

The same flags as the JAX package's launcher, plus ``--device`` (default:
the CUDA card). It runs on one device: ``--model-axis`` other than 1 (the
JAX package's tensor-parallel mesh) is refused until the LM half of the
sharding code is ported.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 20 --batch 4 --seq 1024 --ckpt build/train/gemma [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 200 --batch 8 --seq 256 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch, reduced
from repro_torch.data.synth_lm import lm_batch_at
from repro_torch.models import count_params_analytic
from repro_torch.optim import cosine_warmup, default_optimizer_for, get_optimizer
from repro_torch.sharding.ctx import UNSHARDED
from repro_torch.train import create_train_state, make_train_step
from repro_torch.utils.device import exact_matmul, resolve_device


def extras_of(cfg) -> dict:
    """The memory inputs of a batch, name -> shape after the batch axis."""
    extras = {}
    if cfg.n_vision_tokens:
        extras["vision"] = (cfg.n_vision_tokens, cfg.d_model)
    if cfg.enc_dec:
        extras["audio"] = (cfg.n_audio_frames, cfg.d_model)
    return extras


def main(argv=None):
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
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        raise ValueError(
            f"--model-axis {args.model_axis}: tensor parallelism needs the "
            "LM half of the sharding code (param / batch / train-state "
            "specs and the production mesh), not ported yet; this launcher "
            "trains on one device")

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_matmul()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    n_params = count_params_analytic(cfg)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"(reduced={args.reduced})")

    optimizer = get_optimizer(default_optimizer_for(n_params),
                              lr=cosine_warmup(args.lr, args.warmup,
                                               args.steps))
    gen = torch.Generator(dev).manual_seed(args.seed)
    state = create_train_state(cfg, optimizer, gen, dev)
    start = 0
    if args.ckpt and args.resume:
        s0 = latest_step(args.ckpt)
        if s0 is not None:
            state = restore(args.ckpt, s0, state)
            start = int(state["step"])
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, optimizer, UNSHARDED,
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
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            m.update(step=step, tok_per_s=tokens_done / max(dt, 1e-9))
            history.append(m)
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.2f} tok/s={m['tok_per_s']:,.0f}"
                  + (" SKIPPED" if m["skipped"] else ""))
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, state)
    if ckpt:
        ckpt.wait()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
