"""End-to-end LM training example (the JAX package's
``examples/train_lm.py``): a ~100M-parameter member of the xLSTM family
for a few hundred steps on the synthetic corpus, with asynchronous
checkpoints and exact resume, through ``repro_torch.launch.train``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm          # ~100M, 300 steps
  PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.tiny:
        argv = ["--arch", "xlstm-125m", "--reduced", "--steps", "30",
                "--batch", "4", "--seq", "64", "--ckpt", args.ckpt,
                "--ckpt-every", "10", "--log-every", "5"]
    else:
        # full xlstm-125m (the ~100M-class assigned arch)
        argv = ["--arch", "xlstm-125m", "--steps", str(args.steps),
                "--batch", "4", "--seq", "256", "--ckpt", args.ckpt,
                "--ckpt-every", "50", "--log-every", "10"]
    if args.device:
        argv += ["--device", args.device]
    history = train_mod.main(argv)
    losses = [h["loss"] for h in history]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'decreasing' if losses[-1] < losses[0] else 'check config'})")
    return history


if __name__ == "__main__":
    main()
