"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs an NVIDIA card: it is marked ``cuda`` and
skips elsewhere (a skip is no pass). The file imports no JAX, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import node_power as npw
from repro_torch.kernels import rack_thermal as prt

RTOL = 1e-5
CHAIN = dict(rect_peak=0.965, rect_load=0.55, rect_curv=0.12, conv_eff=0.975)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: pytest -m cuda")
    return torch.device("cuda")


def _inputs(device, E, N=672, JK=4096, seed=5):
    rng = np.random.default_rng(seed)
    place = rng.integers(-1, N, (E, JK)).astype(np.int32)
    cabs = (rng.uniform(0, 24, (E, JK)) * (place >= 0)).astype(np.float32)
    gabs = (rng.uniform(0, 2, (E, JK)) * (place >= 0)).astype(np.float32)
    node = [rng.uniform(lo, hi, N).astype(np.float32)
            for lo, hi in ((8, 48), (1, 4), (80, 300), (100, 400), (0, 600))]
    up = rng.integers(0, 2, (E, N)).astype(np.float32)
    mx = node[2] + node[3] + node[4]
    arrays = (place, cabs, gabs, *node, up, mx)
    return tuple(torch.tensor(a, device=device) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 64])
def test_power_scatter_kernel_matches_plain_version(cuda_device, E):
    t = _inputs(cuda_device, E)
    before = kernels.LAUNCHES["power_scatter"]
    got = npw.power_scatter(*t, **CHAIN)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["power_scatter"] == before + 1
    want = npw.power_scatter_torch(*t, **CHAIN)
    # the CPU plain version sums in the kernel's order
    cpu = npw.power_scatter_torch(*(a.cpu() for a in t), **CHAIN)
    for g, w, c in zip(got, want, cpu):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=0.0)
        torch.testing.assert_close(g.cpu(), c, rtol=RTOL, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 64])
def test_rack_thermal_kernel_matches_plain_version(cuda_device, E):
    """TX-GAIA's racks (672 nodes, 32 a rack): the kernel against the
    plain version on the card (one-hot sums, rtol) and on the CPU, which
    adds each rack's nodes in the kernel's ascending order: bitwise."""
    rng = np.random.default_rng(E)
    n, r = 672, 21
    arrays = (rng.uniform(0, 2500, (E, n)).astype(np.float32),
              (np.arange(n) // 32).astype(np.int32),
              rng.uniform(18, 40, (E, r)).astype(np.float32),
              rng.uniform(14, 24, E).astype(np.float32),
              (20.0 / rng.uniform(3e4, 6e4, r)).astype(np.float32))
    t = tuple(torch.tensor(a, device=cuda_device) for a in arrays)
    before = kernels.LAUNCHES["rack_thermal"]
    got = prt.rack_thermal(*t, alpha=0.0083)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rack_thermal"] == before + 1
    want = prt.rack_thermal_torch(*t, alpha=0.0083)
    cpu = prt.rack_thermal_torch(*(a.cpu() for a in t), alpha=0.0083)
    for g, w, c in zip(got, want, cpu):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=0.0)
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 64])
def test_node_power_kernel_matches_plain_version(cuda_device, E):
    rng = np.random.default_rng(E + 7)
    n = 672
    node = [rng.uniform(lo, hi, n).astype(np.float32)
            for lo, hi in ((80, 350), (100, 400), (0, 600))]
    arrays = (rng.random((E, n), dtype=np.float32),
              rng.random((E, n), dtype=np.float32), *node,
              rng.integers(0, 2, (E, n)).astype(np.float32),
              node[0] + node[1] + node[2])
    t = tuple(torch.tensor(a, device=cuda_device) for a in arrays)
    before = kernels.LAUNCHES["node_power"]
    got = npw.node_power(*t, **CHAIN)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["node_power"] == before + 1
    want = npw.node_chain(*t, **CHAIN)
    cpu = npw.node_chain(*(a.cpu() for a in t), **CHAIN)
    for g, w, c in zip(got, want, cpu):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=0.0)
        torch.testing.assert_close(g.cpu(), c, rtol=RTOL, atol=0.0)


def _card_vs_cpu(device, case, ticks):
    import repro_torch.core as C
    from repro_torch.configs import acceptance

    cfg = acceptance.config(case)
    jobs, bank = acceptance.workload(cfg)
    runs = {}
    for dev in ("cpu", device):
        st = C.build_statics(cfg, bank, device=dev)
        s = C.load_jobs(C.init_state(cfg, st, 0), jobs)
        kernels.reset_launches()
        fs, _ = C.run_episode(cfg, st, s, ticks, "replay", summary_only=True)
        runs[str(dev)] = (fs, dict(kernels.LAUNCHES))
    return runs["cpu"], runs["cuda"]


@pytest.mark.cuda
def test_main_path_on_the_card_matches_the_cpu_path(cuda_device):
    """200 ticks of TX-GAIA replay on the card and on the CPU: integer
    state equal, floats to rtol=1e-5, one kernel launch per tick."""
    (cpu, n_cpu), (gpu, n_gpu) = _card_vs_cpu(cuda_device,
                                              "replay_tx_gaia_1h", 200)
    assert n_cpu["power_scatter"] == 0 and n_gpu["power_scatter"] == 200
    for f in cpu._fields:
        a, b = getattr(cpu, f), getattr(gpu, f).cpu()
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=RTOL, atol=0.0, msg=f)
        else:
            assert torch.equal(a, b), f


@pytest.mark.cuda
def test_thermal_stress_on_the_card_matches_the_cpu_path(cuda_device):
    """The thermal stress hour's first 900 ticks (by then the trip has
    gated dispatch and the throttle has fired) on the card and on the
    CPU: integer state equal, floats to rtol=1e-5 (job progress as work
    done, ``dur_est - work_left``), one launch of each kernel per tick."""
    (cpu, n_cpu), (gpu, n_gpu) = _card_vs_cpu(
        cuda_device, "replay_tx_gaia_1h_thermal_stress", 900)
    assert n_cpu == {k: 0 for k in n_cpu}
    assert n_gpu == {"power_scatter": 900, "rack_thermal": 900,
                     "node_power": 0}
    assert float(gpu.thermal_throttle_s) == 320.0
    for f in cpu._fields:
        a, b = getattr(cpu, f), getattr(gpu, f).cpu()
        if f == "work_left":
            a, b = cpu.dur_est - a, gpu.dur_est.cpu() - b
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=RTOL, atol=0.0, msg=f)
        else:
            assert torch.equal(a, b), f
