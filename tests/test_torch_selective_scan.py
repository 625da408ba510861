"""The selective-scan kernel's plain PyTorch version against the JAX
package's oracle (``kernels/ref.py::selective_scan_ref``, a chunked
associative scan) and its Pallas kernel (``kernels/ops.py::
selective_scan``, interpret mode), on the CPU, over the JAX package's own
sweep (``tests/test_kernels.py``) and sequence lengths that no chunk
divides. Also the decode step, the wrapper's checks and its CPU path. The
kernel itself runs only on the card: ``tests/test_torch_kernels_cuda.py``.

Tolerance: y and the final state within ``atol = rtol = 1e-4``, the JAX
package's own kernel-vs-oracle tolerance. The port's scan adds step by
step, the oracle in chunks (an associative scan inside each) and the
Pallas kernel step by step in its own order; the largest differences seen
here over this sweep are 1.4e-6 in y and 2.4e-7 in the state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref

from repro_torch import kernels
from repro_torch.kernels import selective_scan as pss

TOL = 1e-4
# (ba, s, di, ds, chunk): the JAX package's sweep, then lengths no chunk
# divides (the JAX side pads them with dt = 0), a single step, and the
# reduced jamba's widths at a 640-token prompt's ragged 2.5 chunks
SWEEP = [
    (2, 64, 128, 8, 16),
    (1, 128, 512, 16, 64),
    (3, 32, 256, 4, 32),
    (2, 50, 128, 8, 16),
    (1, 1, 64, 16, 16),
    (2, 40, 128, 8, 16),
]


def _inputs(ba, s, di, ds, seed=7):
    """The JAX package's sweep inputs: x normal, dt uniform in [1e-3, 0.1],
    A = -uniform(0.5, 2), B and C normal; all f32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ba, s, di)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (ba, s, di)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (di, ds)).astype(np.float32),
            rng.normal(size=(ba, s, ds)).astype(np.float32),
            rng.normal(size=(ba, s, ds)).astype(np.float32))


@pytest.mark.parametrize("ba,s,di,ds,chunk", SWEEP)
def test_plain_version_matches_reference_and_pallas(ba, s, di, ds, chunk):
    arrays = _inputs(ba, s, di, ds)
    j = [jnp.asarray(a) for a in arrays]
    want_ref = ref.selective_scan_ref(*j, chunk=chunk)
    want_pallas = ops.selective_scan(*j, chunk)
    kernels.reset_launches()
    got = pss.selective_scan(*(torch.tensor(a) for a in arrays))
    assert kernels.LAUNCHES["selective_scan"] == 0   # CPU: the plain version
    assert got[0].shape == (ba, s, di) and got[1].shape == (ba, di, ds)
    assert all(t.dtype == torch.float32 for t in got)
    for want in (want_ref, want_pallas):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=TOL)


def test_plain_version_is_the_step_recurrence():
    """y and the state of the plain version are the decode step's, step
    after step (the sum over d_state in another order: f32 rounding)."""
    arrays = [torch.tensor(a) for a in _inputs(2, 24, 32, 8, seed=3)]
    x, dt, A, B, C = arrays
    y, final = pss.selective_scan_torch(*arrays)
    state = torch.zeros(2, 32, 8)
    for t in range(24):
        yt, state = pss.selective_scan_step(state, x[:, t], dt[:, t], A,
                                            B[:, t], C[:, t])
        torch.testing.assert_close(y[:, t], yt, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(final, state, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("ba,di,ds", [(2, 128, 8), (1, 64, 16)])
def test_step_matches_reference_step(ba, di, ds):
    rng = np.random.default_rng(ba + di)
    state = rng.normal(size=(ba, di, ds)).astype(np.float32)
    x, dt, A, B, C = _inputs(ba, 1, di, ds, seed=ba + di)
    x, dt, B, C = x[:, 0], dt[:, 0], B[:, 0], C[:, 0]
    want_y, want_s = ref.selective_scan_step_ref(
        *(jnp.asarray(a) for a in (state, x, dt, A, B, C)))
    got_y, got_s = pss.selective_scan_step(
        *(torch.tensor(a) for a in (state, x, dt, A, B, C)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-6)


def _good(ba=2, s=8, di=16, ds=8):
    return [torch.tensor(a) for a in _inputs(ba, s, di, ds)]


@pytest.mark.parametrize("bad,err", [
    (lambda t: [t[0].double()] + t[1:], TypeError),               # dtype
    (lambda t: [t[0], t[1][:, :4]] + t[2:], ValueError),           # dt shape
    (lambda t: t[:2] + [t[2][:8]] + t[3:], ValueError),            # A rows
    (lambda t: t[:3] + [t[3][..., :4]] + t[4:], ValueError),       # B width
    (lambda t: t[:4] + [t[4].transpose(0, 1).contiguous()
                        .transpose(0, 1)], ValueError),            # strides
    (lambda t: t[:2] + [t[2][:, :6]] + [t[3][..., :6], t[4][..., :6]],
     ValueError),                                                  # d_state 6
    (lambda t: [a[:, :0] for a in t[:2]] + t[2:3]
     + [a[:, :0] for a in t[3:]], ValueError),                     # S = 0
    (lambda t: [t[0].unsqueeze(0)] + t[1:], ValueError),           # rank
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        pss.selective_scan(*bad(_good()))


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


def test_wrapper_refuses_other_devices_and_mixed_devices():
    t = _good()
    with pytest.raises(ValueError, match="no kernel for hpu"):
        pss.selective_scan(*(_OnDevice(a, "hpu") for a in t))
    with pytest.raises(ValueError):
        pss.selective_scan(t[0].to("meta"), *t[1:])
