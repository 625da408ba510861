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
from repro_torch.kernels import flash_attn as pfa
from repro_torch.kernels import node_power as npw
from repro_torch.kernels import rack_thermal as prt
from repro_torch.kernels import selective_scan as pss

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


# (b, sq, sk, h, kv, hd, causal, window): the JAX package's kernel sweep
# (tests/test_kernels.py), then gemma3-1b's prefill shapes (head_dim 256,
# MQA; causal and causal + window 512; a ragged 1025-token prompt),
# qwen3-4b's GQA, and the bf16 kernel's tile edges: hd 128 (two TMA boxes
# a row, 128-key stages) with Sq < Sk and a window, and hd 256 (four
# boxes, 64-key stages) without the causal mask at B > 1
FLASH_CASES = [
    (2, 128, 128, 4, 2, 16, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 64, 128, 2, 1, 16, True, 0),
    (1, 64, 64, 8, 8, 64, False, 0),
    (1, 512, 512, 2, 2, 16, True, 128),
    (1, 100, 230, 4, 1, 16, True, 37),
    (4, 1024, 1024, 4, 1, 256, True, 0),
    (4, 1024, 1024, 4, 1, 256, True, 512),
    (2, 1025, 1025, 4, 1, 256, True, 512),
    (2, 1024, 1024, 32, 8, 128, True, 0),
    (1, 100, 230, 8, 2, 128, True, 37),
    (2, 300, 300, 4, 2, 256, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window", FLASH_CASES)
def test_flash_attn_kernel_matches_plain_version(cuda_device, b, sq, sk, h,
                                                 kv, hd, causal, window,
                                                 dtype):
    """The kernel against ``attention_torch`` on the card, at the JAX
    package's tolerances (f32 2e-5, bf16 2e-2); two calls bitwise equal."""
    rng = np.random.default_rng(sq + hd)
    q, k, v = (torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=cuda_device).to(dtype)
               for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                             (b, sk, kv, hd)))
    before = kernels.LAUNCHES["flash_attn"]
    got = pfa.flash_attention(q, k, v, causal=causal, window=window)
    again = pfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attn"] == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = pfa.attention_torch(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (ba, s, di, ds): the JAX package's sweep (tests/test_kernels.py), one
# step, lengths that no 256-step chunk divides, channels that no 128-thread
# block divides, and jamba's prefill widths (di 16384, ds 16)
SCAN_CASES = [
    (2, 64, 128, 8),
    (1, 128, 512, 16),
    (3, 32, 256, 4),
    (2, 1, 16384, 16),
    (2, 300, 200, 16),
    (1, 257, 96, 32),
    (4, 1024, 16384, 16),
    (2, 1025, 16384, 16),
]


def _scan_inputs(device, ba, s, di, ds, seed=11):
    """x normal, dt in the init's softplus range [1e-3, 0.1], A the
    model's -(1..ds) per channel, B and C normal; f32."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(ba, s, di)).astype(np.float32),
              rng.uniform(1e-3, 0.1, (ba, s, di)).astype(np.float32),
              -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                               (di, ds)).copy(),
              rng.normal(size=(ba, s, ds)).astype(np.float32),
              rng.normal(size=(ba, s, ds)).astype(np.float32))
    return tuple(torch.tensor(a, device=device) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("ba,s,di,ds", SCAN_CASES)
def test_selective_scan_kernel_matches_plain_version(cuda_device, ba, s, di,
                                                     ds):
    """The kernel against ``selective_scan_torch`` on the card (the same
    order of operations: atol = rtol = 1e-5 on outputs of order 1), two
    calls bitwise equal, one launch each."""
    t = _scan_inputs(cuda_device, ba, s, di, ds)
    before = kernels.LAUNCHES["selective_scan"]
    got = pss.selective_scan(*t)
    again = pss.selective_scan(*t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selective_scan"] == before + 2
    assert got[0].shape == (ba, s, di) and got[1].shape == (ba, di, ds)
    want = pss.selective_scan_torch(*t)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=RTOL, atol=RTOL)


@pytest.mark.cuda
def test_selective_scan_wrapper_raises_on_bad_inputs(cuda_device):
    x, dt, A, B, C = _scan_inputs(cuda_device, 2, 8, 64, 16)
    before = kernels.LAUNCHES["selective_scan"]
    for bad, err in (
            ((x.double(), dt, A, B, C), TypeError),
            ((x, dt, A[:, :6].contiguous(), B[..., :6].contiguous(),
              C[..., :6].contiguous()), ValueError),          # d_state 6
            ((x, dt.transpose(0, 1).contiguous().transpose(0, 1), A, B, C),
             ValueError),                                     # strides
            ((x, dt, A, B.cpu(), C), ValueError),             # devices
            ((x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0]), ValueError)):
        with pytest.raises(err):
            pss.selective_scan(*bad)
    assert kernels.LAUNCHES["selective_scan"] == before


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
                     "node_power": 0, "flash_attn": 0, "selective_scan": 0}
    assert float(gpu.thermal_throttle_s) == 320.0
    for f in cpu._fields:
        a, b = getattr(cpu, f), getattr(gpu, f).cpu()
        if f == "work_left":
            a, b = cpu.dur_est - a, gpu.dur_est.cpu() - b
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=RTOL, atol=0.0, msg=f)
        else:
            assert torch.equal(a, b), f
