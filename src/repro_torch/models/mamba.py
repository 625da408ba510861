"""The Mamba (selective state-space) mixer (the JAX package's
``models/mamba.py``).

Parallel (prefill and training) path: ``mamba_apply``, whose scan and the
elementwise work around it (dt's bias and softplus, the casts to f32 and
back, the gated D skip) go through the fused ``mamba_scan`` kernel
wrapper (the kernel on the card, its plain version on the CPU). On a
mesh (``ShardCtx``) the activations are DTensors laid out as the JAX
package constrains them: the conv's input and the scan's output
(dp, None, tp), the channels split over ``model``; ``x_proj`` is
row-parallel, so dt's low-rank input, B and C are summed over ``model``
before the scan, which runs on each rank's channels
(``layers.local_scan``). Decode path:
``mamba_decode``, the O(1) recurrent update of the (conv, ssm) cache,
plain PyTorch as it is jnp in the JAX package; its causal conv is an
einsum over (conv cache, x), as there.

Casts follow the JAX package: the projections and the causal conv run in
the compute dtype (``w`` holds them already cast, with ``A_log`` kept f32,
``model.DecoderLayer.weights``), the scan's inputs are cast to f32 and its
output back, and the cache is f32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan import selective_scan_step
from repro_torch.models import spec as S
from repro_torch.models.layers import normed, rms_norm, scan
from repro_torch.sharding.ctx import UNSHARDED, ShardCtx

Weights = Mapping[str, torch.Tensor]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along the sequence, tap by tap in x's dtype.
    x: (B, S, di); w: (dc, di); b: (di,); ``init`` (B, dc - 1, di) are the
    steps before x (zeros when None)."""
    dc = w.shape[0]
    if init is None:
        # zeros laid out as x (a DTensor's too)
        pad = torch.cat([torch.zeros_like(x[:, :1])] * (dc - 1), dim=1)
    else:
        pad = init.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _x_proj(w: Weights, xc: torch.Tensor, cfg: ModelConfig,
            ctx: ShardCtx = UNSHARDED):
    """(step sizes before their bias and softplus (..., di), B (..., ds), C
    (..., ds)) from the conv's output, in its dtype; B and C are views of
    one projection, summed over ``model`` on a mesh."""
    dr, ds = S.dt_rank(cfg), cfg.ssm.d_state
    proj = ctx.constrain(xc @ w["x_proj"], "dp", None, None)
    dt_low, Bc, Cc = torch.split(proj, [dr, ds, ds], dim=-1)
    return dt_low @ w["dt_w"], Bc, Cc


def _dt_b_c(w: Weights, xc: torch.Tensor, cfg: ModelConfig):
    """(softplus'd step sizes (..., di), B (..., ds), C (..., ds)) from the
    conv's output, in its dtype."""
    dt_proj, Bc, Cc = _x_proj(w, xc, cfg)
    return F.softplus(dt_proj + w["dt_b"]), Bc, Cc


def mamba_apply(w: Weights, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False, ctx: ShardCtx = UNSHARDED):
    """x: (B, S, D) -> (B, S, D), and with ``return_state`` the layer's
    decode cache ``{"conv": (B, dc - 1, di), "ssm": (B, di, ds)}``, f32."""
    h = normed(x, w["ln1"], cfg.norm_eps, ctx)
    xz = h @ w["in_proj"]                                   # (B, S, 2di)
    xb_raw, z = (ctx.constrain(t, "dp", None, "tp")
                 for t in torch.chunk(xz, 2, dim=-1))
    xb = F.silu(_causal_conv(xb_raw, w["conv_w"], w["conv_b"]))
    dt_proj, Bc, Cc = _x_proj(w, xb, cfg, ctx)
    A = -torch.exp(w["A_log"].float())                      # (di, ds)
    y, final = scan(xb, dt_proj, w["dt_b"], A, Bc, Cc, z, w["D_skip"])
    out = ctx.constrain(y, "dp", None, "tp") @ w["out_proj"]
    if not return_state:
        return out
    dc = cfg.ssm.d_conv
    conv = xb_raw[:, -(dc - 1):].float()
    if conv.shape[1] < dc - 1:   # a prompt shorter than the conv's history
        conv = F.pad(conv, (0, 0, dc - 1 - conv.shape[1], 0))
    return out, {"conv": conv.contiguous(), "ssm": final}


def mamba_cache_spec(cfg: ModelConfig, batch: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{"conv", "ssm"}`` -> (shape, dtype) of a Mamba layer's cache."""
    di = S.d_inner(cfg)
    return {"conv": ((batch, cfg.ssm.d_conv - 1, di), torch.float32),
            "ssm": ((batch, di, cfg.ssm.d_state), torch.float32)}


def mamba_decode(w: Weights, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D). Advances ``cache`` (``conv`` and ``ssm``) by one token
    in place (the JAX package returns updated copies) and returns (out
    (B, 1, D), cache)."""
    dt_ = x.dtype
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    xz = h @ w["in_proj"]
    xb, z = torch.chunk(xz, 2, dim=-1)                      # (B, 1, di)
    conv_in = torch.cat([cache["conv"].to(dt_), xb], dim=1)  # (B, dc, di)
    xc = torch.einsum("bcd,cd->bd", conv_in, w["conv_w"]) + w["conv_b"]
    xc = F.silu(xc)                                         # (B, di)
    dtv, Bc, Cc = _dt_b_c(w, xc, cfg)
    A = -torch.exp(w["A_log"].float())
    y, ssm = selective_scan_step(cache["ssm"], xc.float(), dtv.float(), A,
                                 Bc.float(), Cc.float())
    y = y.to(dt_) + xc * w["D_skip"]
    out = (y[:, None, :] * F.silu(z)) @ w["out_proj"]
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache
