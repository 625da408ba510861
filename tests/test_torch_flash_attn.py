"""The flash-attention kernel's plain PyTorch version against the JAX
package's oracle (``kernels/ref.py::attention_ref``) and its Pallas kernel
(``kernels/ops.py::flash_attention``, interpret mode), on the CPU, over the
JAX package's own sweep (``tests/test_kernels.py``): GQA, Sq < Sk,
non-causal, sliding windows; f32 to 2e-5 and bf16 to 2e-2. The bf16
kernel's one extra rounding (P in bf16 before P.V), emulated here, stays
within the same 2e-2. Also the wrapper's checks, its choice of entry and
its CPU path. The kernels themselves run only on the card:
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.layers import attention_full

from repro_torch import kernels
from repro_torch.kernels import flash_attn as pfa
from repro_torch.models import layers

# (b, sq, sk, h, kv, hd, causal, window, block_q, block_k) as in the JAX
# package's sweep; the blocks are the Pallas kernel's
SWEEP = [
    (2, 128, 128, 4, 2, 16, True, 0, 32, 64),
    (1, 256, 256, 4, 4, 32, True, 64, 64, 64),
    (2, 64, 128, 2, 1, 16, True, 0, 32, 32),
    (1, 64, 64, 8, 8, 64, False, 0, 64, 64),
    (1, 512, 512, 2, 2, 16, True, 128, 128, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, sq, sk, h, kv, hd, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window,bq,bk", SWEEP)
def test_plain_version_matches_reference_and_pallas(b, sq, sk, h, kv, hd,
                                                    causal, window, bq, bk,
                                                    dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, sq, sk, h, kv, hd)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in arrays)
    want_ref = ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    want_pallas = ops.flash_attention(jq, jk, jv, causal, window, bq, bk)
    kernels.reset_launches()
    got = pfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert kernels.LAUNCHES["flash_attn"] == 0     # CPU: the plain version
    assert got.dtype == tdt and got.shape == tq.shape
    torch.testing.assert_close(
        got, pfa.attention_torch(tq, tk, tv, causal=causal, window=window),
        rtol=0.0, atol=0.0)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (100, 230, True, 37),     # ragged, queries end where the keys end
    (70, 70, False, 20),      # a window without the causal mask
    (1, 49, True, 16),        # one query
])
def test_plain_version_matches_reference_off_the_pallas_grid(sq, sk, causal,
                                                             window):
    """Shapes the Pallas kernel's block divisibility refuses; the port
    takes any Sq <= Sk."""
    arrays = _inputs(2, sq, sk, 4, 2, 16, seed=sq)
    want = ref.attention_ref(*(jnp.asarray(a) for a in arrays),
                             causal=causal, window=window)
    got = layers.attention(*(torch.tensor(a) for a in arrays), causal=causal,
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _bf16_kernel_rounding(q, k, v, *, causal, window):
    """The bf16 kernel's arithmetic in plain torch: bf16 inputs, f32
    Q.K^T and softmax, the probabilities rounded to bf16 for P.V (the
    tensor cores' operand type), P.V summed in f32 and divided by the f32
    row sums, the output rounded to bf16."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * pfa.scale_of(hd)
    dist = (torch.arange(sq)[:, None] + (sk - sq)) - torch.arange(sk)[None, :]
    live = torch.ones_like(dist, dtype=torch.bool)
    if causal:
        live &= dist >= 0
    if window > 0:
        live &= dist < window
    s = s.masked_fill(~live, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.bfloat16().float(), v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, h, hd).bfloat16()


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window", [
    *(case[:8] for case in SWEEP),
    (1, 48, 80, 2, 1, 256, True, 16),   # gemma3-1b-shaped: hd 256, MQA,
])                                      # a window, Sq < Sk
def test_bf16_probabilities_stay_within_the_bf16_tolerance(b, sq, sk, h, kv,
                                                           hd, causal,
                                                           window):
    """Rounding P to bf16 before P.V, as the bf16 kernel does, keeps the
    output within 2e-2 of the f32-probability oracle: the error budget of
    the kernel's rounding, shown before any card run."""
    arrays = _inputs(b, sq, sk, h, kv, hd, seed=hd + sq)
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in arrays)
    got = _bf16_kernel_rounding(tq, tk, tv, causal=causal, window=window)
    want = ref.attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                             causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(
        got.float(),
        pfa.attention_torch(tq, tk, tv, causal=causal, window=window).float(),
        atol=2e-2, rtol=2e-2)


def _qkv(dtype=torch.float32, b=1, sq=8, sk=8, h=4, kv=2, hd=16):
    return (torch.zeros(b, sq, h, hd, dtype=dtype),
            torch.zeros(b, sk, kv, hd, dtype=dtype),
            torch.zeros(b, sk, kv, hd, dtype=dtype))


@pytest.mark.parametrize("bad,err", [
    (lambda: tuple(t.to(torch.float16) for t in _qkv()), TypeError),
    (lambda: (_qkv()[0], *_qkv(torch.bfloat16)[1:]), TypeError),
    (lambda: (_qkv()[0].to(torch.int32), *_qkv()[1:]), TypeError),
    (lambda: _qkv(hd=24), ValueError),                  # no instantiation
    (lambda: _qkv(h=3, kv=2), ValueError),              # H % Kv
    (lambda: _qkv(sq=9, sk=8), ValueError),             # Sq > Sk
    (lambda: (_qkv()[0], _qkv()[1], _qkv(sk=9)[2]), ValueError),
    (lambda: (_qkv()[0][0], *_qkv()[1:]), ValueError),  # rank
    (lambda: (_qkv(b=2)[0], *_qkv()[1:]), ValueError),  # batch
    (lambda: (_qkv(sq=8, h=4, hd=16)[0].transpose(1, 2).contiguous()
              .transpose(1, 2), *_qkv()[1:]), ValueError),  # not contiguous
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        pfa.flash_attention(*bad(), causal=True, window=0)


def test_wrapper_refuses_a_negative_window():
    with pytest.raises(ValueError):
        pfa.flash_attention(*_qkv(), causal=True, window=-1)


@pytest.mark.parametrize("dtype,entry", [(torch.float32, "flash_attn_f32"),
                                         (torch.bfloat16, "flash_attn_bf16")])
def test_the_dtype_picks_the_kernel_entry(dtype, entry):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one."""
    assert pfa.kernel_entry(*_qkv(dtype)) == entry


def _offset_by_one(t):
    """``t``'s values in a contiguous tensor one element past an aligned
    address."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_bf16_entry_refuses_what_tma_cannot_read(which):
    """The bf16 kernel's tensor maps need 16-byte aligned addresses and
    byte strides: a tensor one element off an aligned address, or with a
    row stride of 34 bytes, is refused before any launch. The f32 entry
    reads with plain loads and takes the same shifted tensors."""
    qkv = list(_qkv(torch.bfloat16))
    qkv[which] = _offset_by_one(qkv[which])
    assert qkv[which].is_contiguous() and qkv[which].data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte"):
        pfa.kernel_entry(*qkv)
    padded = list(_qkv(torch.bfloat16))
    shape = padded[which].shape
    padded[which] = torch.zeros(*shape[:-1], 17, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="16-byte"):
        pfa.kernel_entry(*padded)
    f32 = list(_qkv())
    f32[which] = _offset_by_one(f32[which])
    assert pfa.kernel_entry(*f32) == "flash_attn_f32"


def test_cpu_path_takes_unaligned_bf16():
    """The alignment rule is the kernel's: on the CPU the plain version
    runs on the same shifted tensors."""
    q, k, v = (_offset_by_one(t) for t in _qkv(torch.bfloat16))
    got = pfa.flash_attention(q, k, v, causal=True, window=0)
    assert torch.equal(got, pfa.attention_torch(q, k, v, causal=True,
                                                window=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd", [(2, 21, 16, 4, 2, 16),
                                            (1, 40, 24, 4, 4, 16),
                                            (1, 9, 24, 8, 2, 64)])
def test_plain_attention_takes_sq_over_sk_without_a_mask(b, sq, sk, h, kv,
                                                         hd, dtype):
    """``flash_attention``'s CPU path (the plain version) against the JAX
    package's ``attention_full`` without a mask, Sq > Sk and Sq < Sk."""
    tol = 2e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                             (b, sk, kv, hd)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = attention_full(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=False, window=0)
    got = pfa.flash_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                              causal=False, window=0)
    assert got.dtype == tdt and got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 4),
                                           (True, 4)])
def test_wrapper_still_refuses_masked_sq_over_sk(causal, window):
    q = torch.zeros(1, 9, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="causal or windowed"):
        pfa.flash_attention(q, kv, kv, causal=causal, window=window)
