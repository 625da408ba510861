"""The fused power-scatter kernel of the port against the reference.

``power_scatter_torch`` (the plain PyTorch version the CPU path runs)
must match the JAX package's oracle ``ref.power_scatter_ref`` and its
Pallas kernel ``power_scatter_pallas`` (interpret mode, as the
reference's own tests run it) to rtol=1e-5. The CUDA kernel itself runs
only on the card: ``test_torch_kernels_cuda.py`` holds it against this
plain version there.
"""

import numpy as np
import pytest
import torch

from _torch_parity import RTOL

from repro.kernels import ref
from repro.kernels.node_power import power_scatter_pallas
from repro_torch.kernels import node_power as npw

CHAIN = dict(rect_peak=0.965, rect_load=0.55, rect_curv=0.12, conv_eff=0.975)


def _inputs(seed=0, N=100, JK=192, E=None):
    """The inputs of test_perf_path.py's kernel test: slots with id -1
    (zero amounts there) and down nodes; E adds a replica axis."""
    rng = np.random.default_rng(seed)
    lead = () if E is None else (E,)
    place = rng.integers(-1, N, lead + (JK,)).astype(np.int32)
    cabs = (rng.uniform(0, 8, lead + (JK,)) * (place >= 0)).astype(np.float32)
    gabs = (rng.uniform(0, 2, lead + (JK,)) * (place >= 0)).astype(np.float32)
    capc = rng.uniform(8, 48, N).astype(np.float32)
    capg = rng.uniform(1, 4, N).astype(np.float32)
    idle = rng.uniform(80, 300, N).astype(np.float32)
    cd = rng.uniform(100, 400, N).astype(np.float32)
    gd = rng.uniform(0, 600, N).astype(np.float32)
    up = rng.integers(0, 2, lead + (N,)).astype(np.float32)
    mx = idle + cd + gd
    return place, cabs, gabs, capc, capg, idle, cd, gd, up, mx


def _torch_args(args, device="cpu"):
    return tuple(torch.tensor(a, device=device) for a in args)


def test_plain_matches_ref_oracle_and_pallas_kernel():
    args = _inputs()
    want_ref = ref.power_scatter_ref(*args, **CHAIN)
    want_pallas = power_scatter_pallas(*args, block_n=64, interpret=True,
                                       **CHAIN)
    t = _torch_args(args)
    # the port's functions take a leading replica axis: E = 1
    lifted = (t[0][None], t[1][None], t[2][None], *t[3:8], t[8][None], t[9])
    got = npw.power_scatter_torch(*lifted, **CHAIN)
    for name, g, wr, wp in zip(("it", "input", "cpu_frac", "gpu_frac"), got,
                               want_ref, want_pallas):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(wr), rtol=RTOL,
                                   err_msg=f"{name} vs power_scatter_ref")
        np.testing.assert_allclose(g[0].numpy(), np.asarray(wp), rtol=RTOL,
                                   err_msg=f"{name} vs power_scatter_pallas")


def test_wrapper_on_cpu_is_the_plain_version():
    t = _torch_args(_inputs(seed=1, E=2))
    got = npw.power_scatter(*t, **CHAIN)
    want = npw.power_scatter_torch(*t, **CHAIN)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_batched_replicas_match_per_replica_loop():
    t = _torch_args(_inputs(seed=2, E=3))
    got = npw.power_scatter(*t, **CHAIN)
    for e in range(3):
        one = (t[0][e:e + 1], t[1][e:e + 1], t[2][e:e + 1], *t[3:8],
               t[8][e:e + 1], t[9])
        want = npw.power_scatter(*one, **CHAIN)
        for g, w in zip(got, want):
            assert torch.equal(g[e:e + 1], w)


def test_onehot_and_index_add_scatters_agree():
    """The plain version sums with index_add_ on the CPU and with a
    one-hot select + reduction on the card; both formulations, run here,
    agree (bitwise up to summation order)."""
    place, cabs = _torch_args(_inputs(seed=3, E=4)[:2])
    a = npw._scatter_index_add(place, cabs, 100)
    b = npw._scatter_onehot(place, cabs, 100)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL)
    # an id outside [0, N) drops out in both, like the -1 slots
    bad = place.clone()
    bad[0, 0] = 100
    np.testing.assert_allclose(npw._scatter_onehot(bad, cabs, 100).numpy(),
                               npw._scatter_index_add(bad, cabs, 100).numpy(),
                               rtol=RTOL)


@pytest.mark.parametrize("broken", ["dtype", "shape", "node_up", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(broken):
    t = list(_torch_args(_inputs(seed=4, E=1)))
    if broken == "dtype":
        t[0] = t[0].long()
        err = TypeError
    elif broken == "shape":
        t[1] = t[1][:, :-1]
        err = ValueError
    elif broken == "node_up":
        t[8] = t[8][0]
        err = ValueError
    else:
        # no kernel and no fallback off the CPU: a tensor elsewhere raises
        t = [a.to("meta") for a in t]
        err = ValueError
    with pytest.raises(err):
        npw.power_scatter(*t, **CHAIN)


def test_power_chain_matches_reference_mid_episode():
    """compute_power (fused) and node_loads + power_from_fracs (two-pass)
    of the port against the reference's, on a reference mid-episode
    state carried across by interop."""
    import jax

    import repro.configs.sim as rcfg
    import repro.core as R
    import repro.core.power as RP
    import repro_torch.configs.sim as pcfg
    import repro_torch.core.power as PP
    from repro_torch import interop
    from _torch_parity import assert_tree_close, make_pair, ref_numpy

    rc, pc = rcfg.tiny_cluster(), pcfg.tiny_cluster()
    rst, rs, _, _, _, _ = make_pair(rc, pc, 40, 600.0, seed=1,
                                    mean_dur_s=300.0)
    rs, _ = jax.jit(lambda s: R.run_episode(rc, rst, s, 90, "fcfs"))(rs)
    pst = interop.statics_from_numpy(jax.device_get(rst), device="cpu")
    ps = interop.state_from_numpy(ref_numpy(rs), device="cpu")
    assert int((ps.placement >= 0).sum()) > 0
    want = RP.compute_power(rc, rs, rst, use_kernel=True)
    assert_tree_close(want, PP.compute_power(pc, ps, pst), "fused")
    ru, rg = RP.job_utilization(rc, rs, rst)
    pu, pg = PP.job_utilization(pc, ps, pst)
    for name, w, g in zip(("cpu_frac", "gpu_frac"),
                          RP.node_loads(rc, rs, rst, ru, rg),
                          PP.node_loads(pc, ps, pst, pu, pg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   err_msg=name)
    two_pass = PP.power_from_fracs(pc, ps, pst,
                                   *PP.node_loads(pc, ps, pst, pu, pg))
    assert_tree_close(want, two_pass, "two-pass")
    place, cabs, gabs = PP.placement_amounts(ps, pu, pg)
    assert (cabs[place < 0] == 0).all() and (gabs[place < 0] == 0).all()
