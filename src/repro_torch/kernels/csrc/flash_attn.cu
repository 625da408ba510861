// Flash-attention forward for Hopper (sm_90a), on CUDA cores in f32.
//
// Replaces the TPU kernel `flash_attention_fwd` of the JAX package
// (src/repro/kernels/flash_attn.py:105; body `_fwd_kernel` at :34,
// `pl.pallas_call` at :134). Same function: for q (B, Sq, H, hd) and k, v
// (B, Sk, Kv, hd), f32 or bf16, it writes o (B, Sq, H, hd) in q's type:
//   kv head          h / (H / Kv)  (GQA; no repeated KV in memory)
//   s[i, j]        = (q_i . k_j) * scale                       in f32
//   q_pos          = i + (Sk - Sq)   (queries end where the keys end)
//   live(i, j)     = (!causal || q_pos - j >= 0) && (!window || q_pos - j < window)
//   o_i            = sum_j softmax_j(s[i, :] over live j) v_j  in f32
// P.V is summed in f32, as the Pallas kernel and `ref.attention_ref` do.
//
// What bounds it. At gemma3-1b's prefill (B 4, S 1024, H 4, Kv 1, hd 256,
// causal) the live pairs need ~8.6 GFLOP against ~12.6 MB of inputs and
// output: 0.0087 ms of bf16 tensor-core work against 0.0038 ms of HBM
// traffic, so operations bound it. This first version runs on CUDA cores
// in f32 (a later one moves the two products to wgmma), so it is many times
// slower than that bound.
//
// Design, kept simple:
// - one block of 256 threads (16 x 16) per (64-row q tile, head, batch);
//   the Q tile is staged once into shared memory as f32;
// - a loop over the 64-key K/V tiles that the causal diagonal and the
//   window leave live, in ascending order, each staged into shared memory;
//   no atomics, so two runs give the same bits;
// - thread (ty, tx) owns rows ty + 16 r (r < 4): score columns tx + 16 c
//   (c < 4) and output columns tx + 16 c (c < hd / 16); a row's running
//   max and sum are reduced across its 16 lanes with shuffles;
// - masked scores get p = 0 explicitly (the Pallas kernel's -1e30 fill
//   would put exp(0) = 1 into the sum of a row whose first live tile holds
//   none of its keys), and a row with no live key yet keeps m = -inf;
// - head_dim 256 needs 214 KB of shared memory (Q, K, V and P tiles, rows
//   padded by one float against bank conflicts): above 48 KB only as
//   dynamic shared memory, after cudaFuncSetAttribute;
// - any Sq <= Sk: the ragged q tile and key tile are masked, not padded.
// - expf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// reduce over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const T* __restrict__ q,   // (B, Sq, H, HD)
    const T* __restrict__ k,   // (B, Sk, Kv, HD)
    const T* __restrict__ v,   // (B, Sk, Kv, HD)
    T* __restrict__ o,         // (B, Sq, H, HD)
    int sq, int sk, int n_heads, int n_kv, int causal, int window,
    float scale) {
  constexpr int LD = HD + 1;     // padded row of a Q/K/V tile
  constexpr int LP = kBK + 1;    // padded row of the P tile
  constexpr int DC = HD / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int q_off = sk - sq;

  // strides in elements: (B, S, heads, HD) row-major
  const size_t q_pos_stride = static_cast<size_t>(n_heads) * HD;
  const size_t k_pos_stride = static_cast<size_t>(n_kv) * HD;
  const T* qb = q + (static_cast<size_t>(b) * sq * n_heads + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * sk * n_kv + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * sk * n_kv + kvh) * HD;
  T* ob = o + (static_cast<size_t>(b) * sq * n_heads + h) * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    const int row = q0 + i;
    Qs[i * LD + d] = row < sq ? to_f32(qb[row * q_pos_stride + d]) : 0.0f;
  }

  // keys any row of this tile may see: [k_begin, k_end)
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + q_off + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 + q_off - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's K, V and P are read; Q is staged
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int key = k0 + j;
      const bool in = key < sk;
      Ks[j * LD + d] = in ? to_f32(kb[key * k_pos_stride + d]) : 0.0f;
      Vs[j * LD + d] = in ? to_f32(vb[key * k_pos_stride + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = Qs[(ty + 16 * r) * LD + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q_pos = q0 + ty + 16 * r + q_off;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = k0 + tx + 16 * c;
        const int dist = q_pos - key;
        const bool live = key < sk && (!causal || dist >= 0) &&
                          (window <= 0 || dist < window);
        s[r][c] = live ? s[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float alpha = 1.0f;
      float part = 0.0f;
      if (m_new == -INFINITY) {  // no live key for this row yet
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
      } else {
        alpha = expf(m[r] - m_new);  // 0 while m[r] is still -inf
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[r][c] = s[r][c] == -INFINITY ? 0.0f : expf(s[r][c] - m_new);
          part += s[r][c];
        }
      }
      l[r] = l[r] * alpha + row_sum(part);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        Ps[(ty + 16 * r) * LP + tx + 16 * c] = s[r][c];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[DC];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = Ps[(ty + 16 * r) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[row * q_pos_stride + tx + 16 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int batch, int sq, int sk, int n_heads, int n_kv, int causal,
              int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_attn_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, n_heads, n_kv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int n_heads, int n_kv, int hd, int causal,
           int window, float scale, void* stream) {
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                              causal, window, scale, s);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                              causal, window, scale, s);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                              causal, window, scale, s);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                               causal, window, scale, s);
    case 256:
      return launch_hd<T, 256>(q, k, v, o, batch, sq, sk, n_heads, n_kv,
                               causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) and return the launch's
// CUDA error code: a refused launch never runs, and only this code reports
// it. The caller allocates o and checks shapes, types and contiguity.
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int sq, int sk, int n_heads, int n_kv,
                                     int hd, int causal, int window,
                                     float scale, void* stream) {
  return launch<float>(q, k, v, o, batch, sq, sk, n_heads, n_kv, hd, causal,
                       window, scale, stream);
}

extern "C" int flash_attn_bf16_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int sq, int sk, int n_heads, int n_kv,
                                      int hd, int causal, int window,
                                      float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, sq, sk, n_heads, n_kv, hd,
                               causal, window, scale, stream);
}
