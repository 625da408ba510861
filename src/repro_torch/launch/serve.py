"""Batched serving from the command line: prefill a batch of prompts,
decode N tokens, report tokens/s (the JAX package's ``launch/serve.py``,
same flags).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --reduced --batch 4 --prompt-len 64 --gen 32 --device cpu

It runs on the CUDA card unless ``--device`` names another device. A VLM's
vision tokens and an encoder-decoder's audio frames are 0.02 times a
standard normal, drawn after the prompt from the same seeded generator,
as the JAX package draws them from its prompt's key.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import DecoderLM, init_params
from repro_torch.models.spec import memory_input
from repro_torch.train.serve_step import generate
from repro_torch.utils.device import exact_matmul, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5,
                    help="timed generate repetitions (median reported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    exact_matmul()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen_params = torch.Generator(device=dev).manual_seed(args.seed)
    model = DecoderLM.from_tree(cfg, init_params(cfg, gen_params, dev))
    gen_prompt = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen_prompt, device=dev,
                           dtype=torch.int32)
    extras = {}
    name, n = memory_input(cfg)
    if name:
        extras[name] = 0.02 * torch.randn(
            args.batch, n, cfg.d_model, generator=gen_prompt, device=dev)
    sample = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def run():
        out = generate(model, prompt, args.gen,
                       temperature=args.temperature, generator=sample,
                       extras=extras or None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    out = run()                           # warm-up (builds the kernel)
    times = []
    for _ in range(max(args.iters, 1)):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    med, p10, p90 = (float(v) for v in
                     np.percentile(np.asarray(times), [50, 10, 90]))
    toks = args.batch * args.gen
    print(f"arch={cfg.name} device={dev} generated {toks} tokens/iter over "
          f"{len(times)} iters: median {med:.3f}s ({toks/med:,.1f} tok/s, "
          f"p10-p90 {toks/p90:,.1f}-{toks/p10:,.1f} tok/s); "
          f"sample: {out[0, :16].tolist()}")
    return out


if __name__ == "__main__":
    main()
