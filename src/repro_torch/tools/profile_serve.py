"""Where serving's time goes on the card: prefill and decode under
torch.profiler.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_serve \
        [--arch gemma3-1b | --case serve_jamba_8l | --case serve_mixtral_4l] \
        [--batch 4] [--prompt-len 1024] [--steps 8]

Builds the arch at full width in its own dtype (or the model of an
acceptance case in bf16: the jamba hybrid of ``acceptance.jamba_config``,
no experts, 1 or 8 layers; mixtral-8x22b of ``acceptance.mixtral_config``,
1 or 4 layers, its experts at the published capacity factor) with random
weights (``models.init_params`` on the card), then, for one prefill of
``--batch`` prompts of ``--prompt-len`` tokens and for ``--steps``
decode steps after it, times the work on the host clock around a
synchronised run and once more under ``torch.profiler`` with CPU and CUDA
activities (``profile``; a VLM's or an encoder-decoder's prompt comes with
the memory of ``acceptance.lm_memory``). Prints one JSON line per phase:
host ms, CUDA kernels, device time, the device's busy share, the launches of each hand-written kernel
(flash_attn, selective_scan) as its wrapper counts them and, from the
trace, by entry (``selective_scan_fused_kernel`` is the Mamba mixer's
fused scan), the device time of the MoE experts' products (the kernels
inside the profiler range ``moe.EXPERTS_RANGE`` on the card's timeline)
and its share of the device time,
and the top CUDA kernels and host ops. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def experts_device_us(prof, per: int):
    """Device us per repetition of the kernels that ran inside the
    profiler range ``moe.EXPERTS_RANGE``: those inside its spans on the
    card's timeline (the range's own total in ``key_averages`` counts its
    kernels twice, once through that span). None without such a span."""
    import torch

    from repro_torch.models.moe import EXPERTS_RANGE

    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range for e in cuda if e.name == EXPERTS_RANGE]
    if not spans:
        return None
    return sum(e.time_range.elapsed_us() for e in cuda
               if e.name != EXPERTS_RANGE and any(
                   s.start <= e.time_range.start and e.time_range.end <= s.end
                   for s in spans)) / per


def profile(model, prompt, steps: int, extras=None, top: int = 10) -> dict:
    """For one prefill of ``prompt`` (with the memory ``extras``, if the
    model attends to one) and for ``steps`` decode steps after it: host ms
    around a synchronised run, then under ``torch.profiler`` (after a
    warm-up) the profiled host ms, ``profile_tick.device_summary`` and the
    hand-written kernels' launches, each per prefill or per decode step.
    Returns ``{"prefill": {...}, "decode": {...}}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch import kernels
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.tools.profile_tick import device_summary

    S, n = prompt.shape[1], steps

    def run_prefill():
        return prefill(model, prompt, cache_seq_len=S + n, extras=extras)

    def run_decode(state):
        logits, cache = state
        for i in range(n):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits, cache = decode_step(model, cache, tok, S + i)
        return logits, cache

    out = {}
    for name, per, fn in (("prefill", 1, lambda _: run_prefill()),
                          ("decode", n, run_decode)):
        state = run_prefill()
        fn(state)                          # warm-up
        torch.cuda.synchronize()
        state = run_prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(state)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / per
        state = run_prefill()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(state)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        summary = device_summary(prof, wall_us, per, top)
        experts_us = experts_device_us(prof, per)
        out[name] = {
            "per": per, "host_ms": host_ms,
            "host_ms_profiled": wall_us / 1e3 / per,
            "flash_attn_launches": kernels.LAUNCHES["flash_attn"] / per,
            "selective_scan_launches":
                kernels.LAUNCHES["selective_scan"] / per,
            "moe_experts_device_us": experts_us,
            "moe_experts_device_share": (
                experts_us / summary["device_us"]
                if experts_us is not None and summary["device_us"]
                else None),
            **summary}
    return out


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import acceptance, get_arch
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.utils.device import exact_matmul

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--case", choices=(acceptance.JAMBA_CASE,
                                       acceptance.JAMBA_PATH_CASE,
                                       acceptance.MIXTRAL_CASE,
                                       acceptance.MIXTRAL_PATH_CASE),
                    help="the model of this serving case, in bf16 "
                         "(instead of --arch)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA device", file=sys.stderr)
        return 1

    exact_matmul()
    dev = torch.device("cuda")
    if args.case in (acceptance.MIXTRAL_CASE, acceptance.MIXTRAL_PATH_CASE):
        n_layers = (1 if args.case == acceptance.MIXTRAL_CASE
                    else acceptance.MIXTRAL_PATH_LAYERS)
        cfg = acceptance.mixtral_config(n_layers, "bfloat16")
    elif args.case:
        n_layers = (1 if args.case == acceptance.JAMBA_CASE
                    else acceptance.JAMBA_PATH_LAYERS)
        cfg = acceptance.jamba_config(n_layers, "bfloat16")
    else:
        cfg = get_arch(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = DecoderLM.from_tree(cfg, init_params(cfg, gen))
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    extras = {k: torch.tensor(v, device=dev) for k, v in
              acceptance.lm_memory(cfg, args.batch).items()}
    for name, rec in profile(model, prompt, args.steps, extras or None,
                             args.top).items():
        print(json.dumps({
            "arch": cfg.name, "case": args.case, "layers": cfg.n_layers,
            "dtype": cfg.dtype, "phase": name, "batch": args.batch,
            "prompt_len": args.prompt_len,
            "device": torch.cuda.get_device_name(0), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
