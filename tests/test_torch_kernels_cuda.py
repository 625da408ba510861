"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs an NVIDIA card: it is marked ``cuda`` and
skips elsewhere (a skip is no pass). The file imports no JAX, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import flash_attn as pfa
from repro_torch.kernels import node_power as npw
from repro_torch.kernels import rack_thermal as prt
from repro_torch.kernels import selective_scan as pss
from repro_torch.kernels.throttle import Throttle

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


# (E, N, JK): the main path's shapes, a table wider than one 4096-slot
# tile and not a multiple of it, and more nodes than one 1024-node chunk
SCATTER_SHAPES = [(3, 672, 4800), (2, 1500, 700), (64, 672, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,JK", SCATTER_SHAPES)
def test_power_scatter_kernel_tiles_and_chunks(cuda_device, E, N, JK):
    """Shapes that loop over slot tiles and node chunks, with one node
    holding a long run of slots: bitwise against the CPU plain version."""
    t = list(_inputs(cuda_device, E, N=N, JK=JK, seed=E + N))
    t[0][:, ::3] = 7                      # node 7 takes a third of the slots
    t[1][:, ::3] = 1.5
    t[2][:, ::3] = 0.25
    got = npw.power_scatter(*t, **CHAIN)
    again = npw.power_scatter(*t, **CHAIN)
    cpu = npw.power_scatter_torch(*(a.cpu() for a in t), **CHAIN)
    for g, a, c in zip(got, again, cpu):
        assert torch.equal(g, a)
        assert torch.equal(g.cpu(), c)


TICK_CHAIN = dict(rect_peak=0.965, rect_load=0.55, rect_curv=0.12,
                  conv_eff=0.975)


def _tick_consts(thermal):
    return npw.TickConsts(
        trace_quanta=10.0, **TICK_CHAIN, cop_base=5.2, cop_wetbulb_coef=-0.08,
        wetbulb_ref_c=18.0, cop_min=1.5, thermal=thermal,
        throttle=Throttle(24.0, 10.0, 0.6, 0.4), nameplate_w=3.0e5,
        cop_load_coef=1.2, cop_load_ref=0.5)


def _tick_inputs(device, E, J, K, N, R, thermal, seed, Q=12, layout="mixed",
                 W=0):
    """Statics and E replicas' per-tick state: ~70% of jobs running, a
    third of the slots -1, outlet temperatures across the throttle ramp.
    ``layout``: "mixed" (ids anywhere), "half" (the upper half of the
    nodes holds no slot), "hot" (every job on node 3). ``W`` > 0: a
    banked (W, J, Q) trace and each replica's workload id after the
    wetbulb."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    place = rng.integers(0, N, (E, J, K))
    if layout == "half":
        place = place % max(N // 2, 1)
    elif layout == "hot":
        place[:, :, 0] = 3
    place[rng.random((E, J, K)) < 0.33] = -1
    node_cpu = rng.uniform(8, 48, N)
    bank = (W, J, Q) if W else (J, Q)
    statics = [rng.random(bank).astype(f32), rng.random(bank).astype(f32),
               node_cpu.astype(f32), rng.uniform(0, 4, N).astype(f32),
               rng.uniform(80, 300, N).astype(f32),
               rng.uniform(100, 400, N).astype(f32),
               rng.uniform(0, 600, N).astype(f32),
               rng.uniform(700, 1400, N).astype(f32),
               rng.uniform(1e3, 2e4, N).astype(f32),
               rng.integers(0, R, N).astype(np.int32)]
    state = [rng.choice([1, 2, 2, 2, 3], (E, J)).astype(np.int32),
             rng.uniform(100, 3600, E).astype(f32),
             rng.uniform(0, 3000, (E, J)).astype(f32),
             place.astype(np.int32),
             rng.uniform(1, 24, (E, 3, J)).astype(f32),
             (rng.random((E, N)) > 0.05).astype(f32),
             rng.uniform(18, 38, (E, R)).astype(f32),
             rng.uniform(5, 28, E).astype(f32)]
    if W:
        state.append(rng.integers(0, W, E).astype(np.int32))

    def on(dev):
        ts = npw.tick_statics(*(torch.tensor(a, device=dev) for a in statics),
                              n_slots=K, n_racks=R, n_res=3,
                              consts=_tick_consts(thermal))
        return ts, [torch.tensor(a, device=dev) for a in state]

    return on(device), on("cpu")


# (E, J, K, N, R, layout): the main path's TX-GAIA shapes; nodes with no
# slot; every job on one node (the longest run after the sort); a table of
# 4800 slots (over one tile, not a multiple of it) on 1500 nodes (two
# node chunks) and 40 racks
TICK_CASES = [(1, 256, 16, 672, 21, "mixed"), (3, 256, 16, 672, 21, "half"),
              (3, 300, 16, 672, 21, "hot"), (3, 600, 8, 1500, 40, "mixed"),
              (64, 256, 16, 672, 21, "mixed")]


@pytest.mark.cuda
@pytest.mark.parametrize("thermal", [False, True])
@pytest.mark.parametrize("E,J,K,N,R,layout", TICK_CASES)
def test_power_tick_kernel_matches_plain_version(cuda_device, E, J, K, N, R,
                                                 layout, thermal):
    """The fused tick against ``power_tick_torch`` on the card (rtol) and
    on the CPU: node values and job factors bitwise (each node adds its
    slots in ascending order, as ``index_add_`` does), the block sums to
    rtol; two calls bitwise equal; one launch each."""
    (ts, st), (cts, cst) = _tick_inputs(cuda_device, E, J, K, N, R, thermal,
                                        seed=E * 7 + J + N)
    before = kernels.LAUNCHES["power_scatter"]
    got = npw.power_tick(ts, *st)
    again = npw.power_tick(ts, *st)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["power_scatter"] == before + 2
    want = npw.power_tick_torch(ts, *st)
    cpu = npw.power_tick_torch(cts, *cst)
    for i, (g, a, w, c) in enumerate(zip(got, again, want, cpu)):
        if c is None:
            assert g is None and w is None
            continue
        assert torch.equal(g, a), i
        torch.testing.assert_close(g, w, rtol=RTOL, atol=0.0)
        if i == 2:
            torch.testing.assert_close(g.cpu(), c, rtol=RTOL, atol=0.0)
        else:
            assert torch.equal(g.cpu(), c), i
    # one replica without a leading axis, as the main path calls it
    one = npw.power_tick(ts, *(x[0] for x in st))
    for g, o in zip(got, one):
        assert (g is None and o is None) or torch.equal(g[0], o)


@pytest.mark.cuda
@pytest.mark.parametrize("thermal", [False, True])
@pytest.mark.parametrize("E", [1, 64, 1024])
def test_power_tick_banked_kernel_matches_plain_version(cuda_device, E,
                                                        thermal):
    """A fleet's tick over a banked (3, J, Q) trace, each replica reading
    its workload's slice inside the kernel: one launch, node values and
    job factors bitwise against the CPU plain version, the block sums to
    rtol; a replica whose id lies outside the bank gets NaN and reads
    nothing, the others are unchanged."""
    (ts, st), (cts, cst) = _tick_inputs(cuda_device, E, 256, 16, 672, 21,
                                        thermal, seed=E + 3, W=3)
    before = kernels.LAUNCHES["power_scatter"]
    got = npw.power_tick(ts, *st)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["power_scatter"] == before + 1
    cpu = npw.power_tick_torch(cts, *cst)
    for i, (g, c) in enumerate(zip(got, cpu)):
        if c is None:
            assert g is None
        elif i == 2:
            torch.testing.assert_close(g.cpu(), c, rtol=RTOL, atol=0.0)
        else:
            assert torch.equal(g.cpu(), c), i
    bad = st[-1].clone()
    bad[0] = 3
    out = npw.power_tick(ts, *st[:-1], bad)
    assert all(bool(torch.isnan(o[0]).all()) for o in out if o is not None)
    for o, g in zip(out, got):
        assert o is None or torch.equal(o[1:], g[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,R", [(1, 672, 21), (3, 672, 21),
                                   (64, 672, 21), (3, 1500, 40)])
def test_rack_tick_kernel_matches_plain_version(cuda_device, E, N, R):
    """The fused thermal tail against ``rack_tick_torch`` on the card
    (rtol) and on the CPU (bitwise: each rack adds its own nodes in
    ascending order), racks interleaved; two calls bitwise equal."""
    from repro_torch.core.state import rack_csr

    rng = np.random.default_rng(E + N)
    node_rack = rng.integers(0, R, N)
    ptr, nodes = rack_csr(node_rack, R)
    consts = prt.RackConsts(4.0, 14.0, 0.0083, 1.0,
                            Throttle(24.0, 10.0, 0.6, 0.4))
    arrays = (rng.uniform(150, 1500, (E, N)), rng.uniform(0.5, 1.0, E),
              rng.uniform(5, 28, E), rng.uniform(18, 38, (E, R)),
              rng.uniform(20, 40, E))

    r_th = (20.0 / rng.uniform(3e4, 6e4, R)).astype(np.float32)
    tens = {dev: [torch.tensor(a.astype(np.float32), device=dev)
                  for a in arrays] for dev in ("cpu", "cuda")}
    rs = {dev: prt.rack_statics(
        torch.tensor(ptr, device=dev), torch.tensor(nodes, device=dev),
        torch.tensor(node_rack.astype(np.int32), device=dev),
        torch.tensor(r_th, device=dev), consts=consts) for dev in tens}
    before = kernels.LAUNCHES["rack_thermal"]
    got = prt.rack_tick(rs["cuda"], *tens["cuda"])
    again = prt.rack_tick(rs["cuda"], *tens["cuda"])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rack_thermal"] == before + 2
    want = prt.rack_tick_torch(rs["cuda"], *tens["cuda"])
    cpu = prt.rack_tick_torch(rs["cpu"], *tens["cpu"])
    for g, a, w, c in zip(got, again, want, cpu):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=RTOL, atol=0.0)
        assert torch.equal(g.cpu(), c)
    assert float(got[1].max()) == 1.0     # some rack is on the ramp


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
    """The kernel against ``selective_scan_torch`` on the card (atol =
    rtol = 1e-5 on outputs of order 1: the kernel's exponential is
    ``ex2.approx`` and its state update and sum over states fmaf), two
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


# the fused entry: (ba, s, di, ds) over every d_state, lengths no tile
# divides, channels no block divides, and jamba's prefill widths
MAMBA_SCAN_CASES = [
    (2, 64, 128, 4),
    (2, 300, 200, 8),
    (1, 257, 96, 16),
    (2, 33, 256, 32),
    (4, 1024, 16384, 16),
]
# the output: f32 the signature entry's 1e-5; bf16 two bf16 ulps at order
# 1. The final state is f32 in both: 1e-5
MAMBA_SCAN_TOL = {torch.float32: RTOL, torch.bfloat16: 1.6e-2}


def _mamba_inputs(device, dtype, ba, s, di, ds, seed=13):
    """The fused entry's inputs as the mixer passes them: z the second
    half of an in_proj output (ba, s, 2 di), Bc and Cc slices of an x_proj
    output (ba, s, 8 + 2 ds); dt_proj + dt_b in the init's softplus range,
    with channel 0 above softplus's threshold (dt ~ 25); A = -(1..ds); A
    in f32, the rest in ``dtype``."""
    rng = np.random.default_rng(seed)
    dt_proj = rng.normal(0.0, 0.5, (ba, s, di))
    dt_proj[..., 0] = 30.0

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(
            dtype)

    xb = t(rng.normal(size=(ba, s, di)))
    xz = t(rng.normal(size=(ba, s, 2 * di)))
    proj = t(rng.normal(size=(ba, s, 8 + 2 * ds)))
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds))
    return (xb, t(dt_proj), t(rng.uniform(-6.9, -2.3, di)),
            torch.tensor(A.copy(), device=device), proj[..., 8:8 + ds],
            proj[..., 8 + ds:], xz[..., di:], t(rng.normal(size=di)))


def _terms(xb, dt_proj, dt_b, A, Bc, Cc, z, D_skip):
    """The size of what y's sum adds, times the gate: ``sum_n |s_n C_n|
    * |silu(z)|`` (Ba, S, di), bounded by the scan of |x|, |B| and |C|
    (its decays are the same and positive)."""
    dtv = F.softplus(dt_proj + dt_b).float()
    size, _ = pss.selective_scan_torch(xb.float().abs(), dtv, A,
                                       Bc.float().abs(), Cc.float().abs())
    return size * F.silu(z.float()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ba,s,di,ds", MAMBA_SCAN_CASES)
def test_mamba_scan_kernel_matches_plain_version(cuda_device,
                                                 record_property, dtype, ba,
                                                 s, di, ds):
    """The fused kernel against ``mamba_scan_torch`` on the card: the
    output within ``MAMBA_SCAN_TOL`` (the share of outputs that differ at
    all is recorded), the f32 final state within 1e-5 in both dtypes; z
    and Bc, Cc read in place as strided views; two calls bitwise equal,
    one launch each. Channel 0, above softplus's threshold, sums ds terms
    near 25 |x B C| that cancel to y: there the two orders of summation
    part by rounding of the terms' size, and its output is held to the
    tolerance times (1 + |out| + sum_n |s_n C_n| |silu(z)|)."""
    t = _mamba_inputs(cuda_device, dtype, ba, s, di, ds)
    assert not t[6].is_contiguous() and not t[4].is_contiguous()
    before = kernels.LAUNCHES["selective_scan"]
    got = pss.mamba_scan(*t)
    again = pss.mamba_scan(*t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selective_scan"] == before + 2
    assert got[0].shape == (ba, s, di) and got[0].dtype == dtype
    assert got[1].shape == (ba, di, ds) and got[1].dtype == torch.float32
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = pss.mamba_scan_torch(*t)
    record_property("differing_share",
                    float((got[0] != want[0]).float().mean()))
    tol = MAMBA_SCAN_TOL[dtype]
    out, ref = got[0].float(), want[0].float()
    torch.testing.assert_close(out[..., 1:], ref[..., 1:], rtol=tol,
                               atol=tol)
    err0 = (out[..., 0] - ref[..., 0]).abs()
    bound0 = tol * (1 + ref[..., 0].abs() + _terms(*t)[..., 0])
    assert bool((err0 <= bound0).all()), (
        f"channel 0: error {float(err0.max())}, "
        f"{int((err0 > bound0).sum())} over the bound")
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=RTOL)


@pytest.mark.cuda
def test_mamba_scan_wrapper_raises_on_bad_inputs(cuda_device):
    """What TMA cannot read (a z view off 16 bytes) and inputs on two
    devices: refused before any launch."""
    t = list(_mamba_inputs(cuda_device, torch.bfloat16, 2, 8, 64, 16))
    wide = torch.zeros(2, 8, 129, dtype=torch.bfloat16, device=cuda_device)
    before = kernels.LAUNCHES["selective_scan"]
    for bad in (t[:6] + [wide[..., 65:]] + t[7:],   # z misaligned
                t[:4] + [t[4].cpu()] + t[5:]):
        with pytest.raises(ValueError):
            pss.mamba_scan(*bad)
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


@pytest.mark.cuda
def test_fleet_on_the_card_matches_the_cpu_path(cuda_device):
    """Nine replicas of the thermal stress fleet (policies x scenarios,
    ``acceptance.fleet_grid``), 600 ticks on the card and on the CPU (by
    then a job has completed on each and the throttle has fired): integer
    state equal, floats to rtol=1e-5 (progress as work done), one launch
    of each tick kernel per tick for all replicas."""
    import repro_torch.core as C
    from repro_torch.configs import acceptance
    from repro_torch.core.fleet import run_fleet

    cfg = acceptance.config("replay_tx_gaia_1h_thermal_stress")
    jobs, bank = acceptance.workload(cfg)
    _, pol, scn = acceptance.fleet_grid(cfg)
    idx = torch.arange(0, 72, 8)       # every policy, each scenario
    pol = type(pol)(*(x[idx] for x in pol))
    scn = type(scn)(*(type(f)(*(x[idx] for x in f)) for f in scn))
    runs = {}
    for dev in ("cpu", cuda_device):
        st = C.build_statics(cfg, bank, device=dev)
        s = C.load_jobs(C.init_state(cfg, st, 0), jobs)
        kernels.reset_launches()
        fs, _ = run_fleet(cfg, st, s, 600, policies=pol, scenarios=scn,
                          summary_only=True)
        runs[str(dev)] = (fs, dict(kernels.LAUNCHES))
    (cpu, _), (gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert n_gpu["power_scatter"] == 600 and n_gpu["rack_thermal"] == 600
    assert bool((cpu.n_completed > 0).all())
    assert bool((cpu.thermal_throttle_s > 0).all())
    for f in cpu._fields:
        a, b = getattr(cpu, f), getattr(gpu, f).cpu()
        if f == "work_left":
            a, b = cpu.dur_est - a, gpu.dur_est.cpu() - b
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=RTOL, atol=0.0, msg=f)
        else:
            assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rl_tx_gaia", "rl_tx_gaia_thermal_stress"])
def test_rl_env_step_on_the_card_matches_the_cpu_path(cuda_device, case):
    """The RL case's 8 environments as one batched state, driven by the
    action script on the card and on the CPU (``acceptance.run_rl_script``):
    dones, integer digests and completions equal, rewards, info fields
    and observations within rtol=1e-5, one launch of each tick kernel per
    batched tick."""
    from repro_torch.configs import acceptance
    from repro_torch.envs import SchedEnv

    cfg = acceptance.rl_config(case)
    runs = {}
    for dev in ("cpu", cuda_device):
        env = SchedEnv(cfg, acceptance.rl_workloads(cfg), device=dev,
                       **acceptance.rl_env_kwargs())
        kernels.reset_launches()
        runs[str(dev)] = (acceptance.run_rl_script(env, case),
                          dict(kernels.LAUNCHES))
    (cpu, _), (gpu, n_gpu) = runs["cpu"], runs["cuda"]
    ticks = acceptance.RL_SCRIPT_STEPS[case] * acceptance.RL_SIM_STEPS
    assert n_gpu["power_scatter"] == ticks
    assert n_gpu["rack_thermal"] == (ticks if cfg.thermal_enabled else 0)
    acceptance.check_rl(case, gpu, pins=cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["replay_tx_gaia_1h",
                                  "replay_tx_gaia_1h_thermal_stress"])
def test_macro_on_the_card_equals_per_tick(cuda_device, case):
    """900 ticks of a replay hour macro-stepped on the card under
    sync-debug "error" (only the engine's counted reads pass): every
    state and telemetry field bitwise equal to the per-tick run on the
    card (``macro_steps`` aside), one ``power_tick`` launch per tick
    issued, and the reads within 1 + ceil(issued / 16) per macro step."""
    import math

    import repro_torch.core as C
    from repro_torch.configs import acceptance
    from repro_torch.core import sim
    from repro_torch.utils import device as D

    cfg = acceptance.config(case)
    jobs, bank = acceptance.workload(cfg)
    st = C.build_statics(cfg, bank, device=cuda_device)
    s = C.load_jobs(C.init_state(cfg, st, 0), jobs)
    f1, t1 = C.run_episode(cfg, st, s, 900, "replay", summary_only=True)
    kernels.reset_launches()
    sim.reset_macro_ticks()
    D.reset_host_reads()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f2, t2 = C.run_episode(cfg, st, s, 900, "replay", macro=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    events, fast = sim.MACRO_TICKS["event"], sim.MACRO_TICKS["fast"]
    assert events == float(t2.macro_steps) < 900
    assert kernels.LAUNCHES["power_scatter"] == events + fast
    assert D.HOST_READS["count"] <= events + events + math.ceil(fast / 16)
    for a, b, skip in ((f1, f2, ()), (t1, t2, ("macro_steps",))):
        for f in a._fields:
            if f not in skip and getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("macro", [False, True])
def test_snapshotted_run_on_the_card_equals_the_plain_run(cuda_device,
                                                         tmp_path, macro):
    """200 ticks of ``tiny_cluster`` with faults and serving on the card,
    snapshotted every 50 s under sync-debug "error": the state and the
    telemetry (``macro_steps`` aside, macro-stepped) bitwise equal to the
    run without snapshots; one counted read for the fingerprint and one a
    snapshot on top of the macro engine's."""
    import repro_torch.core as C
    from repro_torch.configs.sim import tiny_cluster
    from repro_torch.data import synth_workload
    from repro_torch.utils import device as D

    cfg = tiny_cluster(node_mtbf_hours=0.3, serving_enabled=True,
                       serving_nodes=4)
    jobs, bank = synth_workload(cfg, 32, 1200.0, seed=0)
    st = C.build_statics(cfg, bank, device=cuda_device)
    s = C.load_jobs(C.init_state(cfg, st, 0), jobs)
    mode = dict(macro=True) if macro else dict(summary_only=True)
    D.reset_host_reads()
    f1, t1 = C.run_episode(cfg, st, s, 200, "fcfs", **mode)
    plain_reads = D.HOST_READS["count"]
    D.reset_host_reads()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f2, t2 = C.run_episode(cfg, st, s, 200, "fcfs",
                               snapshot_every_s=50.0,
                               snapshot_dir=str(tmp_path), **mode)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not macro:
        assert D.HOST_READS["count"] == plain_reads + 1 + 4
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == \
        "step_0000000200"
    for a, b, skip in ((f1, f2, ()), (t1, t2, ("macro_steps",))):
        for f in a._fields:
            if f not in skip and getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
