"""PyTorch/CUDA port of the MIT SuperCloud digital twin (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module and public names, runs on one NVIDIA H100 by default (pass
``device="cpu"`` to ``build_statics`` for the plain PyTorch path), and
imports neither ``jax`` nor anything of ``repro``. Each TPU kernel of the
reference becomes a hand-written Hopper kernel under ``kernels/``.
"""
