// Rack heat scatter + first-order RC outlet-temperature update for Hopper
// (sm_90a), one block per replica, in two entries:
//
// - `rack_thermal` replaces the TPU kernel `rack_thermal_pallas` of the
//   JAX package (src/repro/kernels/rack_thermal.py:47; body
//   `_rack_thermal_kernel` at :26, `pl.pallas_call` at :78). Same
//   function, per replica e and rack r:
//     heat[e,r] = sum_n heat_w[e,n] * [node_rack[n] == r]
//     T_ss      = supply[e] + heat[e,r] * r_th[r]
//     T'[e,r]   = T[e,r] + alpha * (T_ss - T[e,r])
//   and writes (T', heat), each (E, R) f32. It takes the rack of each node
//   and orders the nodes by rack with the counting sort of
//   segment_sum.cuh (one block of 1024 threads, one thread per rack).
// - `rack_tick`, the thermal tail of the replay tick: node heat is the
//   post-cap input power (node_input * r), the supply temperature comes
//   from the wetbulb, and besides the RC step it gives the tick's
//   throttled seconds (dt when any rack's throttle from the pre-update
//   temperatures is below 1), the hottest new outlet and the new peak. The
//   racks are static, so it walks the CSR that core/state.py::build_statics
//   makes once (rack_ptr, rack_nodes, ascending inside each rack): one
//   thread per rack adds its own 32 nodes, not 672 compares. Its plain
//   version is kernels/rack_thermal.py::rack_tick_torch.
//
// What bounds it. At TX-GAIA shapes (N = 672 nodes, R = 21 racks) one
// replica moves ~6 KB, ~2 ns at 3.35 TB/s, and ~1.4 K f32 operations.
// Neither bounds it: the thermal tick calls it once at E = 1, so its time
// is the launch and a few dependent loads.
//
// Both entries add each rack's nodes in ascending node order, as the CPU
// plain version's `index_add_` does; built with --fmad=false, the rack sums
// and temperatures have the CPU's bits. No atomics.

#include <cuda_runtime.h>

#include "segment_sum.cuh"
#include "throttle.cuh"

// The racks and the thermal config, fixed for a simulation: made once by
// the wrapper (kernels/rack_thermal.py::RackStatics, which mirrors this
// layout field for field) and passed by value to every launch.
struct RackStatics {
  const int* rack_ptr;       // (R + 1,)
  const int* rack_nodes;     // (N,)
  const float* r_th;         // (R,)
  int n_nodes, n_racks;
  float approach, supply_min, alpha, dt;
  Throttle throttle;
};

namespace {

using Smem = seg::Smem<1>;
constexpr int kTickBlock = 256;

__global__ void __launch_bounds__(seg::kBlock) rack_thermal_kernel(
    const float* __restrict__ heat_w,     // (E, N)
    const int* __restrict__ node_rack,    // (N,)
    const float* __restrict__ outlet,     // (E, R)
    const float* __restrict__ supply,     // (E,)
    const float* __restrict__ r_th,       // (R,)
    float* __restrict__ new_outlet,       // (E, R)
    float* __restrict__ rack_heat,        // (E, R)
    int n_nodes, int n_racks, float alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t node0 = static_cast<size_t>(e) * n_nodes;
  const float sup = supply[e];

  for (int r0 = 0; r0 < n_racks; r0 += seg::kBlock) {
    const int nk = min(seg::kBlock, n_racks - r0);
    float acc[1] = {0.0f};
    for (int base = 0; base < n_nodes; base += seg::kTile) {
      const int count = min(seg::kTile, n_nodes - base);
      for (int i = tid; i < count; i += seg::kBlock) {
        const int r = node_rack[base + i];
        s.key[i] = (r >= r0 && r - r0 < nk) ? r - r0 : -1;
        s.val[0][i] = heat_w[node0 + base + i];
      }
      seg::add_tile<1>(s, count, nk, acc);
    }
    if (tid < nk) {
      const int rack = r0 + tid;
      const size_t out = static_cast<size_t>(e) * n_racks + rack;
      const float t = outlet[out];
      const float t_ss = sup + acc[0] * r_th[rack];
      new_outlet[out] = t + alpha * (t_ss - t);
      rack_heat[out] = acc[0];
    }
  }
}

__global__ void __launch_bounds__(kTickBlock) rack_thermal_tick_kernel(
    const float* __restrict__ node_input,  // (E, N)
    const float* __restrict__ cap_r,       // (E,) the cap's scale r
    const float* __restrict__ wetbulb,     // (E,)
    const float* __restrict__ outlet,      // (E, R) pre-update
    const float* __restrict__ peak,        // (E,)
    float* __restrict__ out,               // new_outlet (E, R), scalars (3, E)
    int n_rep, RackStatics c) {
  __shared__ float s_max[kTickBlock / 32];
  __shared__ int s_hot[kTickBlock / 32];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_nodes = c.n_nodes, n_racks = c.n_racks;
  const int* __restrict__ rack_ptr = c.rack_ptr;
  const int* __restrict__ rack_nodes = c.rack_nodes;
  const float* __restrict__ r_th = c.r_th;
  const float* heat_w = node_input + static_cast<size_t>(e) * n_nodes;
  const float r = cap_r[e];
  const float sup = fmaxf(wetbulb[e] + c.approach, c.supply_min);
  float hottest = __int_as_float(static_cast<int>(0xff800000u));  // -inf
  int hot = 0;
  for (int rack = tid; rack < n_racks; rack += kTickBlock) {
    float heat = 0.0f;
    const int end = rack_ptr[rack + 1];
    for (int i = rack_ptr[rack]; i < end; ++i)
      heat += heat_w[rack_nodes[i]] * r;
    const size_t o = static_cast<size_t>(e) * n_racks + rack;
    const float t = outlet[o];
    const float t_ss = sup + heat * r_th[rack];
    const float t_new = t + c.alpha * (t_ss - t);
    out[o] = t_new;
    hottest = fmaxf(hottest, t_new);
    hot |= throttle(c.throttle, t) < 1.0f;
  }
  for (int d = 16; d > 0; d >>= 1) {
    hottest = fmaxf(hottest, __shfl_xor_sync(0xffffffffu, hottest, d));
    hot |= __shfl_xor_sync(0xffffffffu, hot, d);
  }
  if ((tid & 31) == 0) {
    s_max[tid >> 5] = hottest;
    s_hot[tid >> 5] = hot;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kTickBlock / 32; ++w) {
      hottest = fmaxf(hottest, s_max[w]);
      hot |= s_hot[w];
    }
    // each scalar a row of E, so a fleet's peak comes back contiguous
    float* scal = out + static_cast<size_t>(n_rep) * n_racks + e;
    scal[0] = hot ? c.dt : 0.0f;
    scal[n_rep] = hottest;
    scal[2 * static_cast<size_t>(n_rep)] = fmaxf(peak[e], hottest);
  }
}

bool thermal_ready[64];

}  // namespace

// Each entry launches on `stream` (PyTorch's current stream of the
// tensors' device; `rack_tick` makes that device current itself, the
// other needs the caller to) and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it. The caller allocates every output and checks the shapes.
extern "C" int rack_thermal_launch(
    const void* heat_w, const void* node_rack, const void* outlet,
    const void* supply, const void* r_th, void* new_outlet, void* rack_heat,
    int n_rep, int n_nodes, int n_racks, float alpha, void* stream) {
  if (n_rep == 0 || n_racks == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!thermal_ready[dev]) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(rack_thermal_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    thermal_ready[dev] = true;
  }
  rack_thermal_kernel<<<n_rep, seg::kBlock, sizeof(Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heat_w), static_cast<const int*>(node_rack),
      static_cast<const float*>(outlet), static_cast<const float*>(supply),
      static_cast<const float*>(r_th), static_cast<float*>(new_outlet),
      static_cast<float*>(rack_heat), n_nodes, n_racks, alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rack_tick_launch(
    const RackStatics* st, const void* node_input, const void* cap_r,
    const void* wetbulb, const void* outlet, const void* peak, void* out,
    int n_rep, int device, void* stream) {
  if (n_rep == 0 || st->n_racks == 0) return 0;
  const seg::DeviceGuard guard(device);
  if (guard.err != 0) return guard.err;
  rack_thermal_tick_kernel<<<n_rep, kTickBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(node_input), static_cast<const float*>(cap_r),
      static_cast<const float*>(wetbulb), static_cast<const float*>(outlet),
      static_cast<const float*>(peak), static_cast<float*>(out), n_rep, *st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rack_tick_statics_size() {
  return static_cast<int>(sizeof(RackStatics));
}
