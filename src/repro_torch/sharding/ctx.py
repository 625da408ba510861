"""The one-card sharding context of the LM training path (the JAX
package's ``sharding/ctx.py``), with only the fields one card reads.

- ``remat``: what the training forward recomputes in the backward pass
  (``torch.utils.checkpoint``, non-reentrant): ``"block"`` each
  superblock of the body (``period`` layers) and each encoder layer,
  ``"none"`` nothing. The tail is never recomputed, as in the JAX
  package.
- ``logit_chunk``: the sequence chunk of the LM loss; each chunk's (B,
  chunk, V) logits are recomputed in the backward pass, never all held.
The defaults are the JAX package's. Its mesh fields (``dp``, ``tp``,
``fsdp``, ...), ``cast_params_bf16`` (FSDP's cast before the gather; a
bfloat16 model here always casts its masters inside the step) and
the attention blocks have no reader here: the kernel tiles itself, and
the backward recomputes the plain attention whole. Nor does its per-layer
remat (``"layer"``), which nothing on one card selects.
"""

from __future__ import annotations

from dataclasses import dataclass

REMATS = ("none", "block")


@dataclass(frozen=True)
class ShardCtx:
    remat: str = "block"
    logit_chunk: int = 1024

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")


UNSHARDED = ShardCtx()
