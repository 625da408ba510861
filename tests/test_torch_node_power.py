"""The port's ``node_power`` kernel (the node power chain from load
fractions) against the reference: on the CPU its wrapper runs the plain
version ``node_chain``, which must match the JAX package's oracle
``ref.node_power_ref`` and its Pallas kernel ``node_power_pallas``
(interpret mode) to rtol=1e-5. The CUDA kernel runs only on the card:
``test_torch_kernels_cuda.py`` holds it against this plain version there.
"""

import numpy as np
import pytest
import torch

from _torch_parity import RTOL

from repro.kernels import ref
from repro.kernels.node_power import node_power_pallas
from repro_torch import kernels
from repro_torch.kernels import node_power as npw

CHAIN = dict(rect_peak=0.965, rect_load=0.55, rect_curv=0.12, conv_eff=0.975)


def _inputs(seed, E, N):
    """Fractions in [0, 1], some nodes down, node constants of TX-GAIA's
    range; node_max_w includes zeros (the chain floors it at 1 W)."""
    rng = np.random.default_rng(seed)
    cf = rng.random((E, N), dtype=np.float32)
    gf = rng.random((E, N), dtype=np.float32)
    idle = rng.uniform(80, 350, N).astype(np.float32)
    cd = rng.uniform(100, 400, N).astype(np.float32)
    gd = rng.uniform(0, 600, N).astype(np.float32)
    up = rng.integers(0, 2, (E, N)).astype(np.float32)
    mx = (idle + cd + gd) * rng.uniform(0.8, 1.2, N).astype(np.float32)
    mx[::17] = 0.0
    return cf, gf, idle, cd, gd, up, mx


@pytest.mark.parametrize("N", [100, 672])
@pytest.mark.parametrize("E", [1, 4])
def test_plain_matches_ref_oracle_and_pallas_kernel(E, N):
    args = _inputs(E * 1000 + N, E, N)
    t = tuple(torch.tensor(a) for a in args)
    before = dict(kernels.LAUNCHES)
    got = npw.node_power(*t, **CHAIN)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing
    for g, w in zip(got, npw.node_chain(*t, **CHAIN)):
        assert torch.equal(g, w)
    want_ref = ref.node_power_ref(*args, **CHAIN)
    want_pallas = node_power_pallas(*args, block_n=64, interpret=True,
                                    **CHAIN)
    for name, g, wr, wp in zip(("it", "input"), got, want_ref, want_pallas):
        assert g.shape == (E, N) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=RTOL,
                                   err_msg=f"{name} vs node_power_ref")
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), rtol=RTOL,
                                   err_msg=f"{name} vs node_power_pallas")


@pytest.mark.parametrize("broken", ["dtype", "frac_shape", "up_shape",
                                    "node_vec", "one_dim", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(broken):
    t = [torch.tensor(a) for a in _inputs(3, 2, 40)]
    err = ValueError
    if broken == "dtype":
        t[0], err = t[0].double(), TypeError
    elif broken == "frac_shape":
        t[1] = t[1][:, :-1]
    elif broken == "up_shape":
        t[5] = t[5][:1]
    elif broken == "node_vec":
        t[6] = t[6][:-1]
    elif broken == "one_dim":
        t[0], t[1], t[5] = t[0][0], t[1][0], t[5][0]
    else:
        # no kernel and no fallback off the CPU: a tensor elsewhere raises
        t = [a.to("meta") for a in t]
    with pytest.raises(err):
        npw.node_power(*t, **CHAIN)
