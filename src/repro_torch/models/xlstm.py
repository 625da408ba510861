"""The xLSTM cells (the JAX package's ``models/xlstm.py``): the
chunkwise-parallel mLSTM (matrix memory) and the strictly sequential sLSTM
(scalar memory, recurrent gate mixing), both with the exp input gate
stabilised by a running max exponent ``m``.

The JAX package computes both in plain jnp (no TPU kernel), so the port
runs plain PyTorch ops: the mLSTM's chunks go through a Python loop where
the JAX package has ``lax.scan``, the sLSTM's steps through one over the
sequence (about 20 small kernels a step on the card).

Casts follow the JAX package: the projections and the causal conv run in
the compute dtype; q, k, v, the gates, the recurrence and the caches are
f32. ``w`` is a layer's weights (``model.DecoderLayer.weights``): matrices
in the compute dtype, norm scales and the sLSTM's ``r`` and ``b`` f32 (the
JAX package reads them in f32).

Caches: an mLSTM layer's ``{"C" (B, nh, dh, dh), "n" (B, nh, dh), "m"
(B, nh), "conv" (B, 3, di)}``, an sLSTM layer's ``{"c", "n", "h", "m"}``,
each (B, D); all f32.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec as S
from repro_torch.models.layers import rms_norm
from repro_torch.models.mamba import _causal_conv

NEG = -1e30
CONV_STEPS = 3    # the mLSTM's conv history: its 4 taps less the current step

Weights = Mapping[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, nh, d // nh)


# ---------------------------------------------------------------------------
# mLSTM
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = S.d_inner(cfg)
    return di, cfg.n_heads, di // cfg.n_heads


def _chunk_step(carry, qi, ki, vi, li, lf, tri):
    """One chunk of L steps: its outputs before the inner norm (B, L, nh,
    dh) and the carry ``(C, n, m)`` at its end."""
    C, n, m = carry                                    # (B,nh,dh,dh) ...
    Fl = torch.cumsum(lf, dim=1)                       # (B,L,nh)
    Fc = Fl[:, -1]                                     # (B,nh)
    # intra-chunk log-weights w[t, s] = Fl_t - Fl_s + li_s (s <= t)
    w = Fl[:, :, None, :] - Fl[:, None, :, :] + li[:, None, :, :]
    w = torch.where(tri[None, :, :, None], w, NEG)     # (B,L,L,nh)
    m_intra = torch.amax(w, dim=2)                     # (B,L,nh)
    m_inter = Fl + m[:, None, :]                       # the carry's exponent
    m_new = torch.maximum(m_intra, m_inter)
    qk = torch.einsum("blhd,bshd->blsh", qi, ki)
    p = torch.exp(w - m_new[:, :, None, :]) * qk
    num_intra = torch.einsum("blsh,bshd->blhd", p, vi)
    den_intra = torch.sum(p, dim=2)
    scale_inter = torch.exp(m_inter - m_new)
    num_inter = torch.einsum("blhd,bhde->blhe", qi, C) * scale_inter[..., None]
    den_inter = torch.einsum("blhd,bhd->blh", qi, n) * scale_inter
    num = num_intra + num_inter
    den = den_intra + den_inter
    hpre = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    # the carry at the chunk's end
    m_end = torch.maximum(m + Fc, torch.amax(Fc[:, None] - Fl + li, dim=1))
    dec_old = torch.exp(m + Fc - m_end)                # (B,nh)
    wk_end = torch.exp(Fc[:, None] - Fl + li - m_end[:, None])   # (B,L,nh)
    C = C * dec_old[..., None, None] + torch.einsum(
        "blhd,blhe,blh->bhde", ki, vi, wk_end)
    n = n * dec_old[..., None] + torch.einsum("blhd,blh->bhd", ki, wk_end)
    return hpre, (C, n, m_end)


def _conv_state(xm: torch.Tensor) -> torch.Tensor:
    """The conv's last CONV_STEPS inputs, f32; a prompt shorter than that
    is led by zeros (the JAX package keeps fewer steps there)."""
    conv = xm[:, -CONV_STEPS:].float()
    if conv.shape[1] < CONV_STEPS:
        conv = F.pad(conv, (0, 0, CONV_STEPS - conv.shape[1], 0))
    return conv.contiguous()


def mlstm_apply(w: Weights, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), and with ``return_state`` the layer's
    decode cache. The sequence runs in chunks of ``cfg.ssm.chunk`` steps
    (fewer when S is shorter); a ragged last chunk is padded with steps
    of no input (log input gate -1e30) and no decay, which leave the carry
    untouched."""
    B, Sq, _ = x.shape
    di, nh, dh = _mlstm_dims(cfg)
    dt = x.dtype
    L = min(cfg.ssm.chunk, Sq)
    pad = (-Sq) % L
    nc = (Sq + pad) // L

    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    xm, z = torch.chunk(h @ w["up"], 2, dim=-1)             # (B, S, di)
    xc = F.silu(_causal_conv(xm, w["conv_w"], w["conv_b"]))
    q = _heads(xc @ w["wq"], nh).float()
    k = _heads(xc @ w["wk"], nh).float() / math.sqrt(dh)
    v = _heads(xm @ w["wv"], nh).float()
    logi = (xc @ w["gi"]).float()                           # (B, S, nh)
    logf = F.logsigmoid((xc @ w["gf"]).float())
    if pad:
        def padded(a, value=0.0):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad), value=value)

        q, k, v = padded(q), padded(k), padded(v)
        logi, logf = padded(logi, NEG), padded(logf)

    def chunks(a):     # (B, S, ...) -> (nc, B, L, ...)
        return a.reshape(B, nc, L, *a.shape[2:]).transpose(0, 1)

    qc, kc, vc, lic, lfc = (chunks(a) for a in (q, k, v, logi, logf))
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    carry = (torch.zeros(B, nh, dh, dh, device=x.device),
             torch.zeros(B, nh, dh, device=x.device),
             torch.full((B, nh), NEG, device=x.device))
    hs = []
    for c in range(nc):
        hpre, carry = _chunk_step(carry, qc[c], kc[c], vc[c], lic[c],
                                  lfc[c], tri)
        hs.append(hpre)
    hseq = torch.stack(hs, dim=1).reshape(B, nc * L, di)[:, :Sq].to(dt)
    hseq = rms_norm(hseq, w["ln_inner"], cfg.norm_eps)
    out = (hseq * F.silu(z)) @ w["down"]
    if not return_state:
        return out
    C, n, m = carry
    return out, {"C": C, "n": n, "m": m, "conv": _conv_state(xm)}


def mlstm_cache_spec(cfg: ModelConfig, batch: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    di, nh, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"C": ((batch, nh, dh, dh), f32), "n": ((batch, nh, dh), f32),
            "m": ((batch, nh), f32), "conv": ((batch, CONV_STEPS, di), f32)}


def mlstm_decode(w: Weights, x: torch.Tensor, cache: Cache, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, D). Advances ``cache`` by one token (its entries replaced
    by the new states) and returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    di, nh, dh = _mlstm_dims(cfg)
    dt = x.dtype
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    xm, z = torch.chunk(h @ w["up"], 2, dim=-1)             # (B, 1, di)
    conv_in = torch.cat([cache["conv"].to(dt), xm], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", conv_in, w["conv_w"])
                + w["conv_b"])                              # (B, di)
    q = (xc @ w["wq"]).reshape(B, nh, dh).float()
    k = (xc @ w["wk"]).reshape(B, nh, dh).float() / math.sqrt(dh)
    v = (xm[:, 0] @ w["wv"]).reshape(B, nh, dh).float()
    li = (xc @ w["gi"]).float()                             # (B, nh)
    lf = F.logsigmoid((xc @ w["gf"]).float())

    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf + m, li)
    a = torch.exp(lf + m - m_new)
    b = torch.exp(li - m_new)
    C_new = C * a[..., None, None] + b[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = n * a[..., None] + b[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    hvec = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    hvec = rms_norm(hvec.reshape(B, di).to(dt), w["ln_inner"], cfg.norm_eps)
    out = (hvec[:, None, :] * F.silu(z)) @ w["down"]
    cache.update(C=C_new, n=n_new, m=m_new, conv=conv_in[:, 1:].float())
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
def _slstm_cell(r: torch.Tensor, gates_x: torch.Tensor, carry, nh: int,
                dh: int):
    """One step. gates_x: (B, 4D), x W + b; carry: (c, n, h, m). The
    recurrent term is per head, (B, nh, 4 dh), then read as (B, 4D) and
    split into the four gates, so a gate's columns cross heads."""
    c, n, hprev, m = carry
    B = gates_x.shape[0]
    rec = torch.einsum("bhd,hde->bhe", hprev.reshape(B, nh, dh),
                       r).reshape(B, 4 * nh * dh)
    ip, fp, zp, op = torch.chunk(gates_x + rec, 4, dim=-1)
    log_f = F.logsigmoid(fp)
    m_new = torch.maximum(log_f + m, ip)
    a = torch.exp(log_f + m - m_new)
    b = torch.exp(ip - m_new)
    c_new = a * c + b * torch.tanh(zp)
    n_new = a * n + b
    h_new = torch.sigmoid(op) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_out(w: Weights, hseq: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """The cell's hidden states (compute dtype) through the inner norm and
    the gated up / down projection."""
    hseq = rms_norm(hseq, w["ln_inner"], cfg.norm_eps)
    u1, u2 = torch.chunk(hseq @ w["up"], 2, dim=-1)
    return (F.silu(u1) * u2) @ w["down"]


def slstm_apply(w: Weights, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), one cell step per position, and with
    ``return_state`` the layer's decode cache."""
    B, Sq, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    gates_x = (h @ w["w"]).float() + w["b"].float()         # (B, S, 4D)
    zeros = torch.zeros(B, D, device=x.device)
    carry = (zeros, zeros, zeros, torch.full((B, D), NEG, device=x.device))
    hs = []
    for t in range(Sq):
        carry = _slstm_cell(w["r"].float(), gates_x[:, t], carry, nh,
                            dh)
        hs.append(carry[2])
    out = _slstm_out(w, torch.stack(hs, dim=1).to(x.dtype), cfg)
    if not return_state:
        return out
    c, n, hn, m = carry
    return out, {"c": c, "n": n, "h": hn, "m": m}


def slstm_cache_spec(cfg: ModelConfig, batch: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    shape = ((batch, cfg.d_model), torch.float32)
    return {"c": shape, "n": shape, "h": shape, "m": shape}


def slstm_decode(w: Weights, x: torch.Tensor, cache: Cache, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, D). Advances ``cache`` by one token (its entries replaced
    by the new states) and returns (out (B, 1, D), cache)."""
    D = x.shape[-1]
    nh = cfg.n_heads
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    gx = (h[:, 0] @ w["w"]).float() + w["b"].float()
    c, n, hn, m = _slstm_cell(w["r"].float(), gx,
                              (cache["c"], cache["n"], cache["h"],
                               cache["m"]), nh, D // nh)
    out = _slstm_out(w, hn.to(x.dtype), cfg)[:, None, :]
    cache.update(c=c, n=n, h=hn, m=m)
    return out, cache
