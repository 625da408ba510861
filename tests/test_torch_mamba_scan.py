"""The Mamba mixer's fused scan entry (``kernels/selective_scan.py::
mamba_scan``) on the CPU, where it runs its plain version
``mamba_scan_torch``:

- bit for bit the composite ``models/mamba.py::mamba_apply`` ran around
  the signature entry before the fusion, in f32 and bf16;
- against the JAX package's mixer segment (``src/repro/models/mamba.py``,
  dt's bias and softplus through the gated D skip) with its scan both
  ways, ``impl="xla"`` (the jnp oracle) and ``impl="pallas"`` (the Pallas
  kernel in interpret mode): f32 within ``atol = rtol = 1e-5`` (the
  mixer's tolerance, ``tests/test_torch_mamba.py``), bf16 within bf16's
  2e-2;
- the wrapper's refusals. The kernel itself runs only on the card:
  ``tests/test_torch_kernels_cuda.py``.

Inputs are laid out as the mixer makes them: z the second half of
in_proj's output, Bc and Cc slices of x_proj's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops, ref

from repro_torch import kernels
from repro_torch.kernels import selective_scan as pss
from repro_torch.tools import compare_scan

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DT_RANK = 4
CHUNK = 16
# (ba, s, di, ds): the reduced jamba's widths over 2.5 chunks, one step,
# and the other d_states
CASES = [(2, 40, 128, 8), (1, 1, 64, 16), (2, 24, 32, 4), (1, 33, 64, 32)]


def _arrays(ba, s, di, ds, seed=3):
    """f32 numpy inputs: xz (ba, s, 2 di), proj (ba, s, dt_rank + 2 ds),
    xb, dt_proj around the init's softplus range (one channel above
    softplus's threshold of 20), dt_b, A = -(1..ds), D_skip."""
    rng = np.random.default_rng(seed)
    dt_proj = rng.normal(0.0, 0.5, (ba, s, di))
    dt_proj[..., 0] = 30.0
    f = np.float32
    return dict(
        xz=rng.normal(size=(ba, s, 2 * di)).astype(f),
        proj=rng.normal(size=(ba, s, DT_RANK + 2 * ds)).astype(f),
        xb=rng.normal(size=(ba, s, di)).astype(f),
        dt_proj=dt_proj.astype(f),
        dt_b=rng.uniform(-6.9, -2.3, di).astype(f),
        A=-np.broadcast_to(np.arange(1, ds + 1, dtype=f), (di, ds)).copy(),
        D_skip=rng.normal(size=di).astype(f))


def _torch_inputs(arrays, dtype):
    """(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip) as the mixer passes them:
    views into xz and proj, A in f32, the rest in ``dtype``."""
    t = {k: torch.tensor(v) for k, v in arrays.items()}
    t = {k: (v if k == "A" else v.to(dtype)) for k, v in t.items()}
    ds = t["A"].shape[1]
    _, z = torch.chunk(t["xz"], 2, dim=-1)
    _, Bc, Cc = torch.split(t["proj"], [DT_RANK, ds, ds], dim=-1)
    return (t["xb"], t["dt_proj"], t["dt_b"], t["A"], Bc, Cc, z,
            t["D_skip"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ba,s,di,ds", CASES)
def test_plain_version_is_the_mixers_composite(dtype, ba, s, di, ds):
    """The lines ``mamba_apply`` ran around ``selective_scan`` before they
    were fused: equal bits, so the CPU path does not move."""
    xb, dt_proj, dt_b, A, Bc, Cc, z, D = _torch_inputs(
        _arrays(ba, s, di, ds), dtype)
    dtv = F.softplus(dt_proj + dt_b)
    y, want_final = pss.selective_scan(
        xb.float().contiguous(), dtv.float().contiguous(), A.contiguous(),
        Bc.float().contiguous(), Cc.float().contiguous())
    y = y.to(dtype) + xb * D
    want = y * F.silu(z)
    kernels.reset_launches()
    got, final = pss.mamba_scan(xb, dt_proj, dt_b, A, Bc, Cc, z, D)
    assert kernels.LAUNCHES["selective_scan"] == 0     # the plain version
    assert got.dtype == dtype and final.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(final, want_final)


def _jax_segment(arrays, dtype, impl):
    """The JAX package's mixer from dt's softplus to the gate
    (``src/repro/models/mamba.py:58-80``), dt_low @ dt_w given."""
    dt_ = JAX_DTYPE[dtype]
    a = {k: jnp.asarray(v) if k == "A" else jnp.asarray(v).astype(dt_)
         for k, v in arrays.items()}
    ds = a["A"].shape[1]
    di = a["xb"].shape[-1]
    z = a["xz"][..., di:]
    Bc = a["proj"][..., DT_RANK:DT_RANK + ds]
    Cc = a["proj"][..., DT_RANK + ds:]
    dtv = jax.nn.softplus(a["dt_proj"] + a["dt_b"])
    f32 = jnp.float32
    args = (a["xb"].astype(f32), dtv.astype(f32), a["A"], Bc.astype(f32),
            Cc.astype(f32))
    if impl == "pallas":
        y, final = ops.selective_scan(*args, CHUNK)
    else:
        y, final = ref.selective_scan_ref(*args, chunk=CHUNK)
    y = y.astype(dt_) + a["xb"] * a["D_skip"]
    return y * jax.nn.silu(z), final


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ba,s,di,ds", CASES[:2])
def test_matches_the_jax_mixer_segment(impl, dtype, ba, s, di, ds):
    arrays = _arrays(ba, s, di, ds)
    want, want_final = _jax_segment(arrays, dtype, impl)
    got, final = pss.mamba_scan(*_torch_inputs(arrays, dtype))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               atol=tol, rtol=tol)


def _good(dtype=torch.float32, ds=8):
    return list(_torch_inputs(_arrays(2, 8, 32, ds), dtype))


@pytest.mark.parametrize("bad,err", [
    (lambda t: [t[0].half()] + t[1:], TypeError),                  # fp16
    (lambda t: [a.half() for a in t], TypeError),                  # all fp16
    (lambda t: t[:1] + [t[1].to(torch.bfloat16)] + t[2:], TypeError),  # mixed
    (lambda t: t[:3] + [t[3].to(torch.bfloat16)] + t[4:], TypeError),  # A
    (lambda t: t[:1] + [t[1][:, :4]] + t[2:], ValueError),         # dt shape
    (lambda t: t[:2] + [t[2][:8]] + t[3:], ValueError),            # dt_b
    (lambda t: t[:3] + [t[3][:8]] + t[4:], ValueError),            # A rows
    (lambda t: t[:4] + [t[4][..., :4]] + t[5:], ValueError),       # Bc width
    (lambda t: t[:6] + [t[6][:, :4]] + t[7:], ValueError),         # z shape
    (lambda t: t[:7] + [t[7][:8]], ValueError),                    # D_skip
    (lambda t: [t[0].transpose(0, 1).contiguous().transpose(0, 1)]
     + t[1:], ValueError),                                         # xb strides
    (lambda t: t[:5] + [t[5].transpose(0, 2).contiguous()
                        .transpose(0, 2)] + t[6:], ValueError),    # Cc strides
    (lambda t: t[:3] + [t[3][:, :6].contiguous()]
     + [t[4][..., :6], t[5][..., :6]] + t[6:], ValueError),        # d_state 6
    (lambda t: [a[:, :0] if a.dim() == 3 else a for a in t],
     ValueError),                                                  # S = 0
    (lambda t: [t[0].unsqueeze(0)] + t[1:], ValueError),           # rank
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        pss.mamba_scan(*bad(_good()))


class _OnDevice(torch.Tensor):
    """A tensor that reports ``device`` and holds no data (a device with
    no kernel here; meta tensors are traced, ``launch.dryrun``)."""

    @staticmethod
    def __new__(cls, like, device):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, strides=like.stride(), dtype=like.dtype,
            device=torch.device(device))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"no operation on this device: {func}")


def test_wrapper_refuses_other_devices():
    t = _good()
    with pytest.raises(ValueError, match="no kernel for hpu"):
        pss.mamba_scan(*(_OnDevice(a, "hpu") for a in t))
    with pytest.raises(ValueError):
        pss.mamba_scan(t[0].to("meta"), *t[1:])


@pytest.mark.parametrize("ds", [4, 8])
def test_b_and_c_rows_a_tensor_map_cannot_read_are_copied(ds):
    """Bc of the reduced jamba in bf16 (rows of 40 bytes) and at d_state 4
    (24): copied into rows padded to 16 bytes, with the same values."""
    proj = torch.randn(2, 8, 4 + 2 * ds).to(torch.bfloat16)
    Bc = proj[..., 4:4 + ds]
    assert not pss._tma_readable(Bc)
    got = pss._tma_rows(Bc)
    assert pss._tma_readable(got) and torch.equal(got, Bc)
    assert got.stride(1) * got.element_size() % 16 == 0
    ready = pss._tma_rows(got)
    assert ready.data_ptr() == got.data_ptr()          # no second copy


@pytest.mark.parametrize("name", sorted(
    n for n, (side, _) in compare_scan.TRIALS.items() if side == "change"))
def test_compare_scan_trials_edit_the_kernel(name):
    """Each design trial of ``tools/compare_scan.py`` on this tree finds
    each text it replaces once in ``csrc/selective_scan.cu``, so the trial
    builds what it names."""
    source = (Path(pss.__file__).parent / "csrc" / "selective_scan.cu"
              ).read_text()
    for old, new in compare_scan.TRIALS[name][1]:
        assert source.count(old) == 1 and old != new
