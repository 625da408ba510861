// Rack heat scatter + first-order RC outlet-temperature update for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `rack_thermal_pallas` of the JAX package
// (src/repro/kernels/rack_thermal.py:47; body `_rack_thermal_kernel` at
// :26, `pl.pallas_call` at :78). Same function, per replica e and rack r:
//   heat[e,r] = sum_n heat_w[e,n] * [node_rack[n] == r]
//   T_ss      = supply[e] + heat[e,r] * r_th[r]
//   T'[e,r]   = T[e,r] + alpha * (T_ss - T[e,r])
// and writes (T', heat), each (E, R) f32.
//
// What bounds it. At TX-GAIA shapes (N = 672 nodes, R = 21 racks) one
// replica reads 5.4 KB (heat and rack ids) plus 0.17 KB of rack vectors and
// writes 0.17 KB: about 5.6 KB, ~2 ns at 3.35 TB/s, and N*R = 14 K compares.
// Neither bounds it: the main path calls it once per tick at E = 1, so its
// time is the launch's latency.
//
// Design. The TPU kernel builds an (N, block) one-hot and contracts it on
// the MXU; an f32 product on Hopper's tensor cores would mean TF32, which
// rounds, and float atomics would sum in another order on every run. So
// this version is simple and deterministic: one block per replica, one
// thread per rack (a block of up to 256 threads walks the racks in
// chunks). The block stages the node table (rack ids and heat) through
// shared memory in tiles of 1024 nodes; every thread reads each staged node
// (a shared-memory broadcast) and adds the heat of its own nodes in
// ascending node order, in f32. The RC update then runs in registers and
// each output is written once. Built with --fmad=false, so the arithmetic
// rounds op by op as the plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kMaxBlock) rack_thermal_kernel(
    const float* __restrict__ heat_w,     // (E, N)
    const int* __restrict__ node_rack,    // (N,)
    const float* __restrict__ outlet,     // (E, R)
    const float* __restrict__ supply,     // (E,)
    const float* __restrict__ r_th,       // (R,)
    float* __restrict__ new_outlet,       // (E, R)
    float* __restrict__ rack_heat,        // (E, R)
    int n_nodes, int n_racks, float alpha) {
  __shared__ int s_rack[kTile];
  __shared__ float s_heat[kTile];

  const int e = blockIdx.x;
  const size_t node0 = static_cast<size_t>(e) * n_nodes;
  const float sup = supply[e];

  for (int r0 = 0; r0 < n_racks; r0 += blockDim.x) {
    const int rack = r0 + threadIdx.x;
    float heat = 0.0f;
    for (int base = 0; base < n_nodes; base += kTile) {
      const int count = min(kTile, n_nodes - base);
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        s_rack[i] = node_rack[base + i];
        s_heat[i] = heat_w[node0 + base + i];
      }
      __syncthreads();
      for (int i = 0; i < count; ++i) {
        if (s_rack[i] == rack) heat += s_heat[i];
      }
      __syncthreads();
    }
    if (rack < n_racks) {
      const size_t out = static_cast<size_t>(e) * n_racks + rack;
      const float t = outlet[out];
      const float t_ss = sup + heat * r_th[rack];
      new_outlet[out] = t + alpha * (t_ss - t);
      rack_heat[out] = heat;
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it. The caller allocates every output and checks the shapes.
extern "C" int rack_thermal_launch(
    const void* heat_w, const void* node_rack, const void* outlet,
    const void* supply, const void* r_th, void* new_outlet, void* rack_heat,
    int n_rep, int n_nodes, int n_racks, float alpha, void* stream) {
  if (n_rep == 0 || n_racks == 0) return 0;
  const int warps = (min(n_racks, kMaxBlock) + 31) / 32;
  rack_thermal_kernel<<<n_rep, warps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heat_w), static_cast<const int*>(node_rack),
      static_cast<const float*>(outlet), static_cast<const float*>(supply),
      static_cast<const float*>(r_th), static_cast<float*>(new_outlet),
      static_cast<float*>(rack_heat), n_nodes, n_racks, alpha);
  return static_cast<int>(cudaGetLastError());
}
