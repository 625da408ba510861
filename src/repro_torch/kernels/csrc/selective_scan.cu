// Selective scan (the Mamba mixer's state-space recurrence) for Hopper
// (sm_90a), on CUDA cores in f32.
//
// Replaces the TPU kernel `selective_scan_pallas` of the JAX package
// (src/repro/kernels/mamba_scan.py:61; body `_scan_kernel` at :26,
// `pl.pallas_call` at :87). Same function: for x, dt (Ba, S, di), A
// (di, ds), B, C (Ba, S, ds), all f32, per batch row b and channel d,
// starting from s = 0:
//   s[n]       = exp(dt_t * A[d, n]) * s[n] + (dt_t * x_t) * B_t[n]
//   y[b, t, d] = sum_n s[n] * C_t[n]            (n = 0, 1, ..., ds - 1)
// and writes y (Ba, S, di) and the final state (Ba, di, ds), both f32.
//
// What bounds it. At jamba's prefill (Ba 4, S 1024, di 16384, ds 16) it
// reads x and dt (537 MB) and writes y (268 MB): ~810 MB, 0.24 ms at
// 3.35 TB/s. It also takes Ba*S*di*ds = 1.07e9 exponentials, which the
// SFUs (16 a clock on each of the 132 SMs) need about as long for. So this
// kernel is bound by bytes and exponentials together; its first version
// aims to be right and deterministic, not at that bound.
//
// Design, kept simple:
// - the TPU kernel's chunk grid axis carried the (bdi, ds) state in VMEM
//   from one chunk to the next; blocks on Hopper run in no order, so here
//   one thread owns one (batch row, channel) and walks the whole sequence
//   itself: its ds state values and its row of A stay in registers, and
//   there is no chunking and no padding (any S);
// - a block of 128 threads covers 128 consecutive channels of one batch
//   row, so each step's x and dt loads are coalesced across the block,
//   and the next step's pair is loaded before this step's arithmetic;
// - B_t and C_t are the same for every channel of a row: the block stages
//   them through shared memory, 64 steps at a time, and every thread reads
//   them as broadcasts;
// - expf, not __expf; built with --fmad=false, so each product and sum
//   rounds on its own, in the plain version's order; the sum over n runs
//   from 0 up, so two calls give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kSteps = 64;      // time steps of B and C staged at once

template <int DS>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ x,       // (Ba, S, di)
    const float* __restrict__ dt,      // (Ba, S, di)
    const float* __restrict__ A,       // (di, DS)
    const float* __restrict__ B,       // (Ba, S, DS)
    const float* __restrict__ C,       // (Ba, S, DS)
    float* __restrict__ y,             // (Ba, S, di)
    float* __restrict__ final_state,   // (Ba, di, DS)
    int seq, int di) {
  __shared__ float s_b[kSteps * DS];
  __shared__ float s_c[kSteps * DS];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;

  float a[DS];
  float s[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * DS + n] : 0.0f;
    s[n] = 0.0f;
  }

  const size_t row0 = static_cast<size_t>(b) * seq;   // first step of row b
  size_t off = row0 * di + d;                         // x/dt/y index of step t
  float x_next = live ? x[off] : 0.0f;
  float dt_next = live ? dt[off] : 0.0f;

  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    const int count = min(kSteps, seq - t0);
    __syncthreads();   // the previous tile is no longer read
    for (int i = threadIdx.x; i < count * DS; i += kThreads) {
      s_b[i] = B[(row0 + t0) * DS + i];
      s_c[i] = C[(row0 + t0) * DS + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float xt = x_next;
      const float dtt = dt_next;
      if (t0 + j + 1 < seq) {
        x_next = x[off + di];
        dt_next = dt[off + di];
      }
      const float dtx = dtt * xt;
      const float* bt = s_b + j * DS;
      const float* ct = s_c + j * DS;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float decay = expf(dtt * a[n]);
        s[n] = decay * s[n] + dtx * bt[n];
      }
      float acc = s[0] * ct[0];
#pragma unroll
      for (int n = 1; n < DS; ++n) acc = acc + s[n] * ct[n];
      y[off] = acc;
      off += di;
    }
  }
  if (live) {
    float* out = final_state + (static_cast<size_t>(b) * di + d) * DS;
#pragma unroll
    for (int n = 0; n < DS; ++n) out[n] = s[n];
  }
}

template <int DS>
int launch_ds(const float* x, const float* dt, const float* A, const float* B,
              const float* C, float* y, float* final_state, int batch,
              int seq, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<DS><<<grid, kThreads, 0, stream>>>(
      x, dt, A, B, C, y, final_state, seq, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) and return the launch's
// CUDA error code: a refused launch never runs, and only this code reports
// it. The caller allocates y and final_state and checks shapes, types and
// contiguity; d_state must be 4, 8, 16 or 32.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, void* y,
                                     void* final_state, int batch, int seq,
                                     int di, int ds, void* stream) {
  if (batch == 0 || seq == 0 || di == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(B);
  const auto* cf = static_cast<const float*>(C);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(final_state);
  switch (ds) {
    case 4:
      return launch_ds<4>(xf, dtf, af, bf, cf, yf, sf, batch, seq, di, s);
    case 8:
      return launch_ds<8>(xf, dtf, af, bf, cf, yf, sf, batch, seq, di, s);
    case 16:
      return launch_ds<16>(xf, dtf, af, bf, cf, yf, sf, batch, seq, di, s);
    case 32:
      return launch_ds<32>(xf, dtf, af, bf, cf, yf, sf, batch, seq, di, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
