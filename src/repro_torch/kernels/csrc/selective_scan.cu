// Selective scan (the Mamba mixer's state-space recurrence) for Hopper
// (sm_90a): the TPU kernel's signature in f32, and the mixer's fused entry
// in bf16 or f32.
//
// Replaces the TPU kernel `selective_scan_pallas` of the JAX package
// (src/repro/kernels/mamba_scan.py:61; body `_scan_kernel` at :26,
// `pl.pallas_call` at :87). Same function: for x, dt (Ba, S, di), A
// (di, ds), B, C (Ba, S, ds), per batch row b and channel d, from s = 0:
//   s[n]       = exp(dt_t * A[d, n]) * s[n] + (dt_t * x_t) * B_t[n]
//   y[b, t, d] = sum_n s[n] * C_t[n]
// in f32, writing y (Ba, S, di) and the final state (Ba, di, ds) in f32.
//
// The fused entry (mamba_scan_launch) also does the mixer's elementwise
// work around the scan (models/mamba.py::mamba_apply), in the compute
// type T (bf16 or f32), rounding to T where the plain version rounds:
//   prologue  dt = T(softplus(T(dt_proj + dt_bias)))  (f32 inside, PyTorch's
//             threshold 20), g = T(silu(z)); x, dt, B, C widened to f32;
//   scan      as above, in f32;
//   epilogue  out = T(T(T(y) + T(x * D)) * g)
// and writes out (Ba, S, di) in T and the final state in f32. z is the
// second half of in_proj's output and B, C slices of x_proj's: each is
// read in place through its row and batch strides (the wrapper copies B
// and C, which are tiny, where a tensor map cannot read them so).
//
// What bounds it. At jamba's prefill (Ba 4, S 1024, di 16384, ds 16) the
// scan takes Ba*S*di*ds = 1.07e9 exponentials: 0.257 ms on the SFUs (16 a
// clock on each of the 132 SMs). The signature entry moves 0.81 GB (0.24
// ms at 3.35 TB/s); the bf16 fused entry 0.54 GB (0.16 ms) and 2.0e8 more
// transcendentals (softplus's exp and log1p, silu's exp). So the SFUs
// bound both, and everything else has to hide behind them.
//
// Design:
// - one block per (batch row, tile of CH channels), 256 consumer threads
//   and one producer warp. A channel's ds states are split over L lanes of
//   a warp (CH = 256 / L), each lane holding ds / L states and its row of A
//   (scaled by log2(e)) in registers; for L > 1, y_t's partial sums meet in
//   a shuffle butterfly. L is 1 up to ds 16 and 2 at ds 32 (16 states a
//   lane): at jamba's prefill L = 1 ran fastest (tools/compare_scan.py's
//   trials; 2 blocks, 16 warps an SM already keep the SFUs busy, and L = 2,
//   4 only add shuffles and loads of the same B and C values);
// - time stays sequential in each thread. A chunked parallel scan would
//   evaluate every exponential again to carry the state into each chunk,
//   and the exponentials are the bound: it would double it;
// - decay = ex2.approx(dt * A * log2(e)): one MUFU op, where expf is one
//   plus range reduction on the FMA pipe. The state update and y's sum are
//   fmaf (the build's --fmad=false contracts nothing), y adds a lane's
//   states from n = 0 up (a chain of fmaf: a fixed pairwise tree of
//   products and adds was no faster in the trials, since the SFUs, not
//   the chain's latency, bound the step) and the lanes in a fixed
//   butterfly, and nothing is atomic: two calls give equal bits;
// - the producer warp's lane 0 stages STEPS x CH tiles of x, dt (and z)
//   and STEPS rows of B and C by TMA (3-D tensor maps (width, S, Ba):
//   steps past S and channels past di read as zeros; B and C through their
//   own row strides) into a ring of 3 to 6 stages behind mbarriers; in
//   bf16 the warp then widens B and C to f32 in the stage, a tile behind
//   the loads, so that no lane waits on a load. The consumers walk time in
//   shared memory; in the fused entry each warp first runs the prologue
//   over its own channels of the stage, in place;
// - y (or out) is written over x in the stage, and the producer stores the
//   stage's tile by TMA (rows past S, channels past di not written); the
//   stage's next x load waits only for that store to have read it;
// - any S and di, no padding; ds 4, 8, 16 or 32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;             // consumer threads per block
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kTileBytes = 4096;            // x's (dt's, z's) tile in a stage
constexpr int kSmemPerSM = 220 * 1024;      // shared memory the ring may take
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and widened again: the plain version's rounding at a step.
// For bf16 by integer arithmetic (round to nearest even, as
// __float2bfloat16_rn; NaN passes as it is), which the H100 ran faster
// here than the conversion and the widening back; the stores keep the
// conversion instruction, which ran faster there than this
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    const uint32_t u = __float_as_uint(v);
    const float r =
        __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
    return v == v ? r : v;
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softplus (PyTorch's threshold 20) and silu in f32, before the rounding to
// T. softplus with PyTorch's own expf and log1pf in both types, so that dt,
// which the state carries, has the plain version's bits; silu, which only
// the output sees, with PyTorch's expf and division in f32 and, for bf16,
// whose 8-bit rounding follows, with ex2/rcp.approx (relative errors near
// 1e-7)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}
template <typename T>
__device__ __forceinline__ float silu(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v / (1.0f + expf(-v));
  else
    return v * rcp_approx(1.0f + ex2_approx(-v * kLog2e));
}

// N consecutive floats of shared memory, 16 or 8 bytes at a time
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

constexpr int round128(int n) { return (n + 127) / 128 * 128; }

// the lanes that share a channel's DS states
constexpr int lanes_for(int ds) { return ds == 32 ? 2 : 1; }

// the shapes of one instantiation: DS states, T in memory
template <int DS, typename T, bool kFused>
struct Tile {
  static constexpr int L = lanes_for(DS);
  static constexpr int E = int(sizeof(T));
  static constexpr int N = DS / L;                  // states per lane
  static constexpr int CH = kConsumers / L;         // channels per block
  static constexpr int CW = 32 / L;                 // channels per warp
  static constexpr int STEPS = kTileBytes / (CH * E);
  static constexpr int TENSORS = kFused ? 3 : 2;    // x, dt (, z)
  // B and C as loaded: rows of BW values (a TMA box row is a multiple of
  // 16 bytes; values past ds read as zeros), then, in bf16, widened to f32
  static constexpr int BW = DS * E >= 16 ? DS : 16 / E;
  static constexpr bool WIDEN = !std::is_same<T, float>::value;
  static constexpr int BC_RAW = round128(STEPS * BW * E);
  static constexpr int BC_F32 = WIDEN ? round128(STEPS * DS * 4) : 0;
  static constexpr int TX = TENSORS * kTileBytes + 2 * STEPS * BW * E;
  static constexpr int STAGE = TENSORS * kTileBytes + 2 * BC_RAW + 2 * BC_F32;
  static constexpr int MIN_BLOCKS = N <= 8 ? 4 : 2;
  static constexpr int STAGES_FIT = kSmemPerSM / MIN_BLOCKS / STAGE;
  static constexpr int STAGES =
      STAGES_FIT < 3 ? 3 : STAGES_FIT > 6 ? 6 : STAGES_FIT;
  static constexpr int SMEM = STAGES * STAGE + 3 * STAGES * 8 + 128;
  static_assert(N >= 1 && DS % L == 0 && 32 % L == 0, "lanes");
  static_assert(CH <= 256 && STEPS >= 1 && STEPS <= 256, "TMA box");
};

struct ScanArgs {
  const float* A;          // (di, DS), f32
  const void* dt_bias;     // (di,) in T: fused entry only
  const void* d_skip;      // (di,) in T: fused entry only
  float* final_state;      // (Ba, di, DS)
  int seq, di;
};

// the tensor maps of one launch: (width, S, Ba) views, boxes of (CH or BW)
// x STEPS; z is the fused entry's only
struct Maps {
  CUtensorMap x, dt, z, b, c, y;
};

template <int DS, typename T, bool kFused>
__device__ __forceinline__ void scan_block(const Maps& m, const ScanArgs& a) {
  using G = Tile<DS, T, kFused>;
  constexpr int L = G::L, N = G::N, CH = G::CH, STEPS = G::STEPS;
  constexpr int NS = G::STAGES;
  // aligned by an offset from the shared window's address, so that the
  // compiler still knows the pointers as shared (LDS/STS, not generic)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((128 - (hopper::smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * G::STAGE);
  uint64_t* widened = full + NS;   // bf16: B and C widened to f32
  uint64_t* done = widened + NS;   // consumed, and y written over x
  // a stage: x (y is written over it), dt, [z], B, C as loaded, [B, C f32]
  auto stage_of = [&](int st) { return smem + st * G::STAGE; };
  constexpr int OFF_B = G::TENSORS * kTileBytes;
  constexpr int OFF_C = OFF_B + G::BC_RAW;
  constexpr int OFF_BF = OFF_C + G::BC_RAW;
  constexpr int OFF_CF = OFF_BF + G::BC_F32;

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int seq = a.seq;
  const int n_tiles = (seq + STEPS - 1) / STEPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&widened[s], 32);
      hopper::mbar_init(&done[s], kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp: lane 0 drives the TMA; in bf16 all lanes widen
    // each tile's B and C once it has landed, a tile behind the loads ----
    auto widen = [&](int k) {
      const int st = k % NS;
      uint8_t* stage = stage_of(st);
      hopper::mbar_wait(&full[st], (k / NS) & 1);
      const T* rb = reinterpret_cast<const T*>(stage + OFF_B);
      const T* rc = reinterpret_cast<const T*>(stage + OFF_C);
      float* fb = reinterpret_cast<float*>(stage + OFF_BF);
      float* fc = reinterpret_cast<float*>(stage + OFF_CF);
      for (int i = lane; i < STEPS * DS; i += 32) {
        const int raw = (i / DS) * G::BW + i % DS;
        fb[i] = to_f32(rb[raw]);
        fc[i] = to_f32(rc[raw]);
      }
      hopper::mbar_arrive(&widened[st]);
    };
    for (int k = 0; k < n_tiles; ++k) {
      const int st = k % NS;
      uint8_t* stage = stage_of(st);
      const int t0 = k * STEPS;
      if (k >= NS) {   // the stage's last tile is consumed: store its y
        hopper::mbar_wait(&done[st], (k / NS - 1) & 1);
        if (lane == 0) {
          hopper::tma_store_3d(&m.y, stage, d0, t0 - NS * STEPS, b);
          hopper::bulk_commit();
        }
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[st], G::TX);
        hopper::tma_load_3d(stage + kTileBytes, &m.dt, &full[st], d0, t0, b);
        if constexpr (kFused)
          hopper::tma_load_3d(stage + 2 * kTileBytes, &m.z, &full[st], d0,
                              t0, b);
        hopper::tma_load_3d(stage + OFF_B, &m.b, &full[st], 0, t0, b);
        hopper::tma_load_3d(stage + OFF_C, &m.c, &full[st], 0, t0, b);
        // x goes where the store reads y from: after the store has read it
        hopper::bulk_wait_read<0>();
        hopper::tma_load_3d(stage, &m.x, &full[st], d0, t0, b);
      }
      if constexpr (G::WIDEN) {
        if (k > 0) widen(k - 1);
      }
    }
    if constexpr (G::WIDEN) widen(n_tiles - 1);
    for (int k = n_tiles > NS ? n_tiles - NS : 0; k < n_tiles; ++k) {
      const int st = k % NS;
      hopper::mbar_wait(&done[st], (k / NS) & 1);
      if (lane == 0) {
        hopper::tma_store_3d(&m.y, stage_of(st), d0, k * STEPS, b);
        hopper::bulk_commit();
      }
    }
    if (lane == 0) hopper::bulk_wait<0>();
    return;
  }

  // ---- consumers: lane group q of channel c holds states [q N, q N + N) ----
  const int cw = warp * G::CW;          // this warp's first channel
  const int c = cw + lane / L;          // the step loop's channel
  const int q = lane % L;
  const int d = d0 + c;
  const bool live = d < a.di;
  float A2[N], s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float av = live ? a.A[int64_t(d) * DS + q * N + n] : 0.0f;
    A2[n] = av * kLog2e;
    s[n] = 0.0f;
  }
  // the prologue's channel (lanes take the warp's channels row by row) and
  // the epilogue's D
  const int cp = cw + lane % G::CW;
  float bias = 0.0f, dskip = 0.0f;
  if constexpr (kFused) {
    const T* bp = static_cast<const T*>(a.dt_bias);
    const T* dp = static_cast<const T*>(a.d_skip);
    if (d0 + cp < a.di) bias = to_f32(bp[d0 + cp]);
    if (live) dskip = to_f32(dp[d]);
  }

  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % NS;
    uint8_t* stage = stage_of(st);
    T* sx = reinterpret_cast<T*>(stage);
    T* sdt = sx + CH * STEPS;
    T* sz = sdt + CH * STEPS;
    const float* sb =
        reinterpret_cast<const float*>(stage + (G::WIDEN ? OFF_BF : OFF_B));
    const float* sc =
        reinterpret_cast<const float*>(stage + (G::WIDEN ? OFF_CF : OFF_C));
    const int count = min(STEPS, seq - k * STEPS);
    hopper::mbar_wait(&full[st], (k / NS) & 1);
    if constexpr (G::WIDEN) hopper::mbar_wait(&widened[st], (k / NS) & 1);

    if constexpr (kFused) {   // softplus'd dt and silu(z), in place
      for (int j = lane / G::CW; j < count; j += L) {
        const int i = j * CH + cp;
        const float v = round_to<T>(to_f32(sdt[i]) + bias);
        sdt[i] = from_f32<T>(softplus(v));
        sz[i] = from_f32<T>(silu<T>(to_f32(sz[i])));
      }
      __syncwarp();
    }

#pragma unroll 2
    for (int j = 0; j < count; ++j) {
      const int i = j * CH + c;
      const float xt = to_f32(sx[i]);
      const float dtt = to_f32(sdt[i]);
      const float dtx = dtt * xt;
      float bv[N], cv[N];
      load_row<N>(bv, sb + j * DS + q * N);
      load_row<N>(cv, sc + j * DS + q * N);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        s[n] = __fmaf_rn(ex2_approx(dtt * A2[n]), s[n], dtx * bv[n]);
      }
      // y: this lane's states from n = 0 up, then the lanes' butterfly
      float y = s[0] * cv[0];
#pragma unroll
      for (int n = 1; n < N; ++n) y = __fmaf_rn(s[n], cv[n], y);
#pragma unroll
      for (int m = 1; m < L; m <<= 1) y += __shfl_xor_sync(0xffffffffu, y, m);
      if (q == 0) {
        if constexpr (kFused) {
          const float sum = round_to<T>(round_to<T>(y) +
                                        round_to<T>(xt * dskip));
          sx[i] = from_f32<T>(sum * to_f32(sz[i]));
        } else {
          sx[i] = from_f32<T>(y);
        }
      }
    }
    hopper::fence_proxy_async();   // y in the stage, for the TMA store
    hopper::mbar_arrive(&done[st]);
  }

  if (live) {
    float* out = a.final_state + (int64_t(b) * a.di + d) * DS + q * N;
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = s[n];
  }
}

// the TPU kernel's signature: x, dt, B, C and y in f32 (m.z unused)
template <int DS>
__global__ void __launch_bounds__(kThreads,
                                  (Tile<DS, float, false>::MIN_BLOCKS))
    selective_scan_kernel(const __grid_constant__ Maps maps,
                          const ScanArgs args) {
  scan_block<DS, float, false>(maps, args);
}

// the mixer's fused entry, in T
template <int DS, typename T>
__global__ void __launch_bounds__(kThreads, (Tile<DS, T, true>::MIN_BLOCKS))
    selective_scan_fused_kernel(const __grid_constant__ Maps maps,
                                const ScanArgs args) {
  scan_block<DS, T, true>(maps, args);
}

// a (width, S, Ba) map of a tensor whose rows are `row` and batch rows
// `batch_stride` elements apart, boxes of `box_w` x `box_steps`
template <typename T>
bool make_map(hopper::EncodeTiled encode, CUtensorMap* map, const void* base,
              int width, int seq, int batch, int64_t row,
              int64_t batch_stride, int box_w, int box_steps) {
  const cuuint64_t dims[3] = {cuuint64_t(width), cuuint64_t(seq),
                              cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(row) * sizeof(T),
                                 cuuint64_t(batch_stride) * sizeof(T)};
  const cuuint32_t boxes[3] = {cuuint32_t(box_w), cuuint32_t(box_steps), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, tma_type<T>(), 3, const_cast<void*>(base), dims, strides,
                boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensors of one launch: x, dt and y contiguous (Ba, S, di); z, B and C
// with rows and batch rows the given numbers of elements apart (z: fused
// entry only)
struct Launch {
  const void *x, *dt, *z, *b, *c;
  void* y;
  int64_t z_row, z_batch, b_row, b_batch, c_row, c_batch;
  int batch;
  ScanArgs args;
};

template <int DS, typename T, bool kFused>
constexpr auto kernel_of() {
  if constexpr (kFused)
    return &selective_scan_fused_kernel<DS, T>;
  else
    return &selective_scan_kernel<DS>;
}

template <int DS, typename T, bool kFused>
int launch(const Launch& p, cudaStream_t stream) {
  using G = Tile<DS, T, kFused>;
  const auto kernel = kernel_of<DS, T, kFused>();
  static bool configured = false;   // the attribute is set once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int di = p.args.di, seq = p.args.seq, ba = p.batch;
  const int64_t plane = int64_t(seq) * di;
  Maps m;
  bool ok =
      make_map<T>(encode, &m.x, p.x, di, seq, ba, di, plane, G::CH, G::STEPS) &&
      make_map<T>(encode, &m.dt, p.dt, di, seq, ba, di, plane, G::CH,
                  G::STEPS) &&
      make_map<T>(encode, &m.y, p.y, di, seq, ba, di, plane, G::CH,
                  G::STEPS) &&
      make_map<T>(encode, &m.b, p.b, DS, seq, ba, p.b_row, p.b_batch, G::BW,
                  G::STEPS) &&
      make_map<T>(encode, &m.c, p.c, DS, seq, ba, p.c_row, p.c_batch, G::BW,
                  G::STEPS);
  if (kFused)
    ok = ok && make_map<T>(encode, &m.z, p.z, di, seq, ba, p.z_row, p.z_batch,
                           G::CH, G::STEPS);
  else
    m.z = m.x;   // not read
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + G::CH - 1) / G::CH, ba);
  kernel<<<grid, kThreads, G::SMEM, stream>>>(m, p.args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFused>
int dispatch(int ds, const Launch& p, cudaStream_t stream) {
  switch (ds) {
    case 4: return launch<4, T, kFused>(p, stream);
    case 8: return launch<8, T, kFused>(p, stream);
    case 16: return launch<16, T, kFused>(p, stream);
    case 32: return launch<32, T, kFused>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) and return the launch's
// CUDA error code: a refused launch never runs, and only this code reports
// it. The caller allocates the outputs and checks shapes, types, strides
// and the 16-byte alignment the tensor maps need; ds is 4, 8, 16 or 32.

// The TPU kernel's signature: x, dt contiguous f32; B, C f32 with the
// given row and batch strides
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, void* y,
                                     void* final_state, int batch, int seq,
                                     int di, int ds, int b_row, int b_batch,
                                     int c_row, int c_batch, void* stream) {
  if (batch == 0 || seq == 0 || di == 0) return 0;
  const ScanArgs args{static_cast<const float*>(A), nullptr, nullptr,
                      static_cast<float*>(final_state), seq, di};
  const Launch p{x,     dt,      nullptr, B,     C,       y,     0,
                 0,     b_row,   b_batch, c_row, c_batch, batch, args};
  return dispatch<float, false>(ds, p, static_cast<cudaStream_t>(stream));
}

// The Mamba mixer's fused entry: xb, dt_proj contiguous (Ba, S, di) in T
// (bf16 when `bf16`, else f32); B, C, z in T with the given row and batch
// strides; dt_bias, d_skip (di,) in T; A (di, ds) f32; out (Ba, S, di) in T
extern "C" int mamba_scan_launch(const void* xb, const void* dt_proj,
                                 const void* dt_bias, const void* A,
                                 const void* B, const void* C, const void* z,
                                 const void* d_skip, void* out,
                                 void* final_state, int batch, int seq,
                                 int di, int ds, int bf16, int b_row,
                                 int b_batch, int c_row, int c_batch,
                                 int z_row, int z_batch, void* stream) {
  if (batch == 0 || seq == 0 || di == 0) return 0;
  const ScanArgs args{static_cast<const float*>(A), dt_bias, d_skip,
                      static_cast<float*>(final_state), seq, di};
  const Launch p{xb,    dt_proj, z,     B,       C,       out,   z_row,
                 z_batch, b_row, b_batch, c_row, c_batch, batch, args};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16, true>(ds, p, s)
              : dispatch<float, true>(ds, p, s);
}
