// Flash-attention forward for Hopper (sm_90a): a bf16 kernel on the tensor
// cores (wgmma, TMA) and an f32 kernel on the CUDA cores.
//
// Replaces the TPU kernel `flash_attention_fwd` of the JAX package
// (src/repro/kernels/flash_attn.py:105; body `_fwd_kernel` at :34,
// `pl.pallas_call` at :134). Same function: for q (B, Sq, H, hd) and k, v
// (B, Sk, Kv, hd), f32 or bf16, it writes o (B, Sq, H, hd) in q's type:
//   kv head          h / (H / Kv)  (GQA; no repeated KV in memory)
//   s[i, j]        = (q_i . k_j) * scale                       in f32
//   q_pos          = i + (Sk - Sq)   (queries end where the keys end)
//   live(i, j)     = (!causal || q_pos - j >= 0) &&
//                    (!window || q_pos - j < window)
//   o_i            = sum_j softmax_j(s[i, :] over live j) v_j  in f32
// Only the key tiles that the causal diagonal and the window leave live are
// visited; masked scores get p = 0 exactly (the Pallas kernel's -1e30 fill
// would put exp(0) = 1 into the sum of a row whose first live tile holds
// none of its keys), and a row with no live key yet keeps m = -inf. Any
// Sq <= Sk; Sq > Sk without causal or window (a cross-attention onto a
// shorter memory), where q_off < 0 is never read: only the causal and
// window terms use it, and keys past Sk (zeros from TMA, or from the f32
// tile loads) are masked by `key < sk` in every tile that holds one. No
// atomics: two runs give the same bits.
//
// What bounds it. At gemma3-1b's prefill (B 4, S 1024, H 4, Kv 1, hd 256,
// causal) the live pairs need ~8.6 GFLOP against ~12.6 MB of inputs and
// output: 0.0087 ms of bf16 tensor-core work against 0.0038 ms of HBM
// traffic, so the tensor cores' rate bounds it.
//
// The bf16 kernel (flash_attn_bf16_kernel), built for that bound:
// - one block of 384 threads per (128-row q tile, head, batch): warpgroup
//   0 is the producer (one thread starts the TMA loads; setmaxnreg hands its
//   registers to the others), warpgroups 1 and 2 each own 64 query rows;
// - TMA loads Q once and K, V into a ring of 2 stages (64 keys a stage at
//   hd 256, 128 below), through 4-D tensor maps (hd, heads, S, B) built on
//   the host: rows past Sq or Sk read as zeros, never the next batch row.
//   mbarriers signal full stages; the consumers' 8 warps release a K
//   stage once S is in and a V stage once P.V is, so the next K load
//   starts a tile early;
// - S = Q.K^T is wgmma with Q and K both K-major in shared memory; P =
//   exp2(s * scale * log2(e) - m) is rounded to bf16 and packed, in
//   registers, into the A operand of the second wgmma, O += P.V, with V
//   MN-major in shared memory. Both sum in f32; the online softmax's max,
//   sum and rescale stay in f32 registers. P in bf16 is the one rounding
//   the f32 paths lack (the JAX package's `attention_full` casts P to v's
//   type too): the plain version keeps P in f32 and holds this kernel to
//   2e-2;
// - inside a warpgroup, the softmax of key tile i runs while the tensor
//   cores still sum P_{i-1}.V_{i-1} (started behind S_i); the two
//   warpgroups interleave on the tensor cores as well;
// - boxes of at most 64 bf16 values a row, with 128-, 64- or 32-byte
//   swizzle (hd >= 64, 32, 16) matched by the wgmma descriptors (see
//   hopper.cuh); hd 128 and 256 load as 2 or 4 boxes along hd;
// - causal q tiles run latest first (they have the most live key tiles),
//   so the short tiles fill in behind the long ones;
// - the output is stored from registers, rows past Sq masked.
//
// The f32 kernel (flash_attn_f32_kernel) is the CUDA-core reference path:
// one block of 256 threads (16 x 16) per (64-row q tile, head, batch), Q,
// K, V and P tiles in shared memory as f32 (214 KB at hd 256, rows padded
// by one float against bank conflicts), each thread owning 4 rows and
// hd / 16 output columns, both products with fmaf and P kept in f32, as
// the Pallas kernel and `ref.attention_ref` do; expf, not __expf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

// ===========================================================================
// f32: CUDA cores
// ===========================================================================
namespace cuda_cores {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread

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

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_f32_kernel(
    const float* __restrict__ q,   // (B, Sq, H, HD)
    const float* __restrict__ k,   // (B, Sk, Kv, HD)
    const float* __restrict__ v,   // (B, Sk, Kv, HD)
    float* __restrict__ o,         // (B, Sq, H, HD)
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
  const float* qb = q + (static_cast<size_t>(b) * sq * n_heads + h) * HD;
  const float* kb = k + (static_cast<size_t>(b) * sk * n_kv + kvh) * HD;
  const float* vb = v + (static_cast<size_t>(b) * sk * n_kv + kvh) * HD;
  float* ob = o + (static_cast<size_t>(b) * sq * n_heads + h) * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    const int row = q0 + i;
    Qs[i * LD + d] = row < sq ? qb[row * q_pos_stride + d] : 0.0f;
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
      Ks[j * LD + d] = in ? kb[key * k_pos_stride + d] : 0.0f;
      Vs[j * LD + d] = in ? vb[key * k_pos_stride + d] : 0.0f;
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
      ob[row * q_pos_stride + tx + 16 * c] = acc[r][c] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int n_heads, int n_kv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_f32_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_attn_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, n_heads,
      n_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_cores

// ===========================================================================
// bf16: tensor cores (wgmma), TMA, a producer warpgroup
// ===========================================================================
namespace tensor_cores {

constexpr int kBQ = 128;             // query rows per block
constexpr int kStages = 2;           // K/V ring
constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
// setmaxnreg moves registers only within the block's own pool, the 168 a
// thread it was launched with (384 x 168 = 64,512): 128 x 40 + 256 x 232
// fills it; asking for more blocks the consumers forever
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "setmaxnreg asks for more registers than the block holds");
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // bytes a box row
  static constexpr int BOX = SW / 2;         // bf16 values a box row
  static constexpr int NBOX = HD / BOX;      // boxes along hd
  static constexpr int BK = HD == 256 ? 64 : 128;   // keys a stage
  static constexpr int LAYOUT = hopper::layout_type(SW);
  static constexpr int Q_BYTES = kBQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one K or V stage
  // tiles, then 1 + 4 * kStages mbarriers; 1024 bytes to align the start
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One consumer thread's part of a 64-row slice of the q tile: its two
// rows' running max and sum, the O accumulator, the scores of the newest
// key tile and the bf16 P of the tile before it.
template <int HD>
struct Consumer {
  using T = Tile<HD>;
  static constexpr int BK = T::BK;

  int row0;                // this thread's rows: row0 and row0 + 8
  int col;                 // its first column in each 8-column block
  int pos_lo, pos_hi;      // q positions of the warpgroup's 64 rows
  int q_off, sk, causal, window;
  float scale_log2;
  uint32_t q_addr;         // the warpgroup's Q rows in shared memory
  float acc[HD / 2];
  float m[2], l[2];        // running max of the raw scores, row-sum parts
  float s[BK / 2];
  uint32_t p[BK / 16][4];

  // S = Q . K^T of the key tile in `k_stage`, started, not waited for
  __device__ __forceinline__ void start_scores(const uint8_t* k_stage) {
    const uint32_t k_addr = hopper::smem_addr(k_stage);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // box kk * 16 / BOX, 32 bytes a k16 step along its rows
      const uint32_t bx = kk * 16 / T::BOX;
      const uint32_t off = (kk * 16 % T::BOX) * 2;
      hopper::wgmma_ss<BK>(
          s,
          hopper::make_desc(q_addr + bx * kBQ * T::SW + off, 16, 8 * T::SW,
                            T::LAYOUT),
          hopper::make_desc(k_addr + bx * BK * T::SW + off, 16, 8 * T::SW,
                            T::LAYOUT),
          kk > 0);
    }
  }

  // O += P . V of the key tile in `v_stage`, started, not waited for
  __device__ __forceinline__ void start_pv(const uint8_t* v_stage) {
    const uint32_t v_addr = hopper::smem_addr(v_stage);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<HD>(
          acc, p[kk],
          hopper::make_desc(v_addr + kk * 16 * T::SW, BK * T::SW, 8 * T::SW,
                            T::LAYOUT));
  }

  // the online softmax of the scores of the key tile at k0, in the log2
  // domain, in place: s becomes f32 P; returns the rescale of O per row
  __device__ __forceinline__ void softmax(int k0, float (&alpha)[2]) {
    // a key tile wholly inside the limits of all 64 rows needs no mask
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > pos_lo) ||
                        (window > 0 && pos_hi - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          if (masked) {
            const int key = k0 + 8 * j + col + e;
            const int dist = row0 + 8 * r + q_off - key;
            const bool live = key < sk && (!causal || dist >= 0) &&
                              (window <= 0 || dist < window);
            x = live ? x : -INFINITY;
          }
          mx[r] = fmaxf(mx[r], x);
        }
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const bool none = mx[r] == -INFINITY;   // no live key for this row yet
      shift[r] = none ? 0.0f : mx[r] * scale_log2;
      // 0 while m[r] is still -inf
      alpha[r] = none ? 1.0f : ex2(m[r] * scale_log2 - shift[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          x = ex2(__fmaf_rn(x, scale_log2, -shift[r]));  // masked: 2^-inf = 0
          l[r] += x;
        }
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= alpha[r];
        acc[4 * j + 2 * r + 1] *= alpha[r];
      }
  }

  // P in bf16, as the A operand of P.V: k16 slice kk is columns
  // 16 kk .. 16 kk + 15 of S, accumulator blocks j = 2 kk and 2 kk + 1
  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }

  // registers written outside wgmma are final before the next wgmma
  __device__ __forceinline__ void fence_all() {
    hopper::fence_regs(s);
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(p[kk]);
  }
};

// the consumers' 8 warps release a stage: one arrival each
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(bar);
}

// Key tile i (of t_begin + i) flows through the warpgroup as: S_i started;
// P_{i-1} . V_{i-1} started behind it; S_i waited for (K_i released) and
// its softmax run while P_{i-1} . V_{i-1} is still on the tensor cores;
// then that product waited for (V_{i-1} released), O rescaled, P_i packed.
template <int HD>
__device__ __forceinline__ void consume(
    uint8_t* sQ, uint8_t* sK, uint8_t* sV, uint64_t* q_full,
    uint64_t* k_full, uint64_t* v_full, uint64_t* k_empty,
    uint64_t* v_empty, __nv_bfloat16* __restrict__ o, int b, int h, int q0,
    int t_begin, int t_end, int sq, int sk, int n_heads, int causal,
    int window, float scale_log2) {
  using T = Tile<HD>;
  constexpr int BK = T::BK;
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: 64 rows each
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  Consumer<HD> c;
  c.col = 2 * (lane % 4);
  c.row0 = q0 + 64 * cw + 16 * warp + lane / 4;
  c.q_off = sk - sq;
  c.pos_lo = q0 + 64 * cw + c.q_off;
  c.pos_hi = c.pos_lo + 63;
  c.sk = sk;
  c.causal = causal;
  c.window = window;
  c.scale_log2 = scale_log2;
  c.q_addr = hopper::smem_addr(sQ) + cw * 64 * T::SW;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) c.acc[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    c.m[r] = -INFINITY;
    c.l[r] = 0.0f;
  }
  float alpha[2];
  const int n = t_end - t_begin;
  hopper::mbar_wait(q_full, 0);

  if (n > 0) {
    hopper::mbar_wait(&k_full[0], 0);
    c.fence_all();
    hopper::wgmma_fence();
    c.start_scores(sK);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    c.fence_all();
    release(&k_empty[0]);
    c.softmax(t_begin * BK, alpha);   // O is still 0: no rescale
    c.pack();
  }
  for (int i = 1; i < n; ++i) {
    const int stage = i % kStages, prev = (i - 1) % kStages;
    hopper::mbar_wait(&k_full[stage], (i / kStages) & 1);
    c.fence_all();
    hopper::wgmma_fence();
    c.start_scores(sK + stage * T::KV_BYTES);
    hopper::wgmma_commit();
    hopper::mbar_wait(&v_full[prev], ((i - 1) / kStages) & 1);
    c.start_pv(sV + prev * T::KV_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();           // S_i is in
    hopper::fence_regs(c.s);
    release(&k_empty[stage]);
    c.softmax((t_begin + i) * BK, alpha);
    hopper::wgmma_wait<0>();           // P_{i-1} . V_{i-1} is in
    c.fence_all();
    release(&v_empty[prev]);
    c.rescale(alpha);
    c.pack();
  }
  if (n > 0) {
    const int last = (n - 1) % kStages;
    hopper::mbar_wait(&v_full[last], ((n - 1) / kStages) & 1);
    c.fence_all();
    hopper::wgmma_fence();
    c.start_pv(sV + last * T::KV_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    c.fence_all();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = c.l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    const int row = c.row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* out =
        o + (static_cast<size_t>(b) * sq + row) * n_heads * HD +
        static_cast<size_t>(h) * HD + c.col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          c.acc[4 * j + 2 * r] * inv, c.acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attn_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (hd, H, Sq, B), box 64 rows
    const __grid_constant__ CUtensorMap tm_k,   // (hd, Kv, Sk, B), box BK rows
    const __grid_constant__ CUtensorMap tm_v,   // as tm_k
    __nv_bfloat16* __restrict__ o,              // (B, Sq, H, HD)
    int sq, int sk, int n_heads, int n_kv, int causal, int window,
    float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + T::Q_BYTES;
  uint8_t* sV = sK + kStages * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // causal q tiles latest first: they have the most live key tiles
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kBQ;
  const int q_off = sk - sq;
  // keys any row of this tile may see: [k_begin, k_end)
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + q_off + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 + q_off - window + 1) : 0;
  const int t_begin = k_begin / T::BK;
  const int t_end = (k_end + T::BK - 1) / T::BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], kConsumerWarps);
      hopper::mbar_init(&v_empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kvh = h / (n_heads / n_kv);
      hopper::mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int bx = 0; bx < T::NBOX; ++bx)
          hopper::tma_load_4d(sQ + bx * kBQ * T::SW + half * 64 * T::SW,
                              &tm_q, q_full, bx * T::BOX, h, q0 + 64 * half,
                              b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int stage = i % kStages;
        const uint32_t free = ((i / kStages) & 1) ^ 1;
        hopper::mbar_wait(&k_empty[stage], free);
        hopper::mbar_arrive_expect_tx(&k_full[stage], T::KV_BYTES);
        for (int bx = 0; bx < T::NBOX; ++bx)
          hopper::tma_load_4d(
              sK + stage * T::KV_BYTES + bx * T::BK * T::SW, &tm_k,
              &k_full[stage], bx * T::BOX, kvh, t * T::BK, b);
        hopper::mbar_wait(&v_empty[stage], free);
        hopper::mbar_arrive_expect_tx(&v_full[stage], T::KV_BYTES);
        for (int bx = 0; bx < T::NBOX; ++bx)
          hopper::tma_load_4d(
              sV + stage * T::KV_BYTES + bx * T::BK * T::SW, &tm_v,
              &v_full[stage], bx * T::BOX, kvh, t * T::BK, b);
      }
    }
  } else {                  // two consumer warpgroups
    hopper::setmaxnreg_inc<kConsumerRegs>();
    consume<HD>(sQ, sK, sV, q_full, k_full, v_full, k_empty, v_empty, o, b,
                h, q0, t_begin, t_end, sq, sk, n_heads, causal, window,
                scale_log2);
  }
}

using hopper::EncodeTiled;

// a 4-D map of a contiguous (batch, seq, heads, hd) bf16 tensor, boxes of
// `box_rows` positions of one head and `box` values along hd
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int batch, int seq, int heads, int hd, int box_rows, int box,
              int sw) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2,
                                 cuuint64_t(heads) * hd * 2,
                                 cuuint64_t(seq) * heads * hd * 2};
  const cuuint32_t boxes[4] = {cuuint32_t(box), 1, cuuint32_t(box_rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, boxes, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int n_heads, int n_kv, int causal, int window,
           float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bf16_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, batch, sq, n_heads, HD, 64, T::BOX, T::SW) ||
      !make_map(encode, &tm_k, k, batch, sk, n_kv, HD, T::BK, T::BOX, T::SW) ||
      !make_map(encode, &tm_v, v, batch, sk, n_kv, HD, T::BK, T::BOX, T::SW))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_heads, batch, (sq + kBQ - 1) / kBQ);
  flash_attn_bf16_kernel<HD><<<grid, kThreads, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), sq, sk, n_heads, n_kv,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tensor_cores

// one launch function per head dim of HEAD_DIMS
#define FLASH_ATTN_DISPATCH(NS)                                            \
  switch (hd) {                                                            \
    case 16:                                                               \
      return NS::launch<16>(q, k, v, o, batch, sq, sk, n_heads, n_kv,      \
                            causal, window, scale, s);                     \
    case 32:                                                               \
      return NS::launch<32>(q, k, v, o, batch, sq, sk, n_heads, n_kv,      \
                            causal, window, scale, s);                     \
    case 64:                                                               \
      return NS::launch<64>(q, k, v, o, batch, sq, sk, n_heads, n_kv,      \
                            causal, window, scale, s);                     \
    case 128:                                                              \
      return NS::launch<128>(q, k, v, o, batch, sq, sk, n_heads, n_kv,     \
                             causal, window, scale, s);                    \
    case 256:                                                              \
      return NS::launch<256>(q, k, v, o, batch, sq, sk, n_heads, n_kv,     \
                             causal, window, scale, s);                    \
    default:                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
  }

}  // namespace

// Launch on `stream` (PyTorch's current stream) and return the launch's
// CUDA error code: a refused launch never runs, and only this code reports
// it. The caller allocates o and checks shapes, types, contiguity and (for
// bf16, whose tensor maps need it) 16-byte alignment.
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int sq, int sk, int n_heads, int n_kv,
                                     int hd, int causal, int window,
                                     float scale, void* stream) {
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_ATTN_DISPATCH(cuda_cores)
}

extern "C" int flash_attn_bf16_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int sq, int sk, int n_heads, int n_kv,
                                      int hd, int causal, int window,
                                      float scale, void* stream) {
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_ATTN_DISPATCH(tensor_cores)
}
