// Fused placement-scatter + node power chain for Hopper (sm_90a).
//
// Replaces the TPU kernel `power_scatter_pallas` of the JAX package
// (src/repro/kernels/node_power.py:116-201; body `_power_scatter_kernel`
// at :116, `pl.pallas_call` at :192). Same function, per replica e and
// node n:
//   load_c = sum_s cpu_abs[e,s] * [place[e,s] == n]   (slots with id -1
//   load_g = sum_s gpu_abs[e,s] * [place[e,s] == n]    match no node)
//   cf, gf = clip(load / max(cap, 1e-6), 0, 1)
//   it     = (idle + cf*cpu_dyn + gf*gpu_dyn) * up[e,n]
//   eta    = clip(peak - curv*(clip(it/max(maxw,1), 0, 1.2) - peak_load)^2,
//                 0.5, 1)
//   input  = it / (eta * conv_eff)
// and writes (it, input, cf, gf), each (E, N) f32.
//
// What bounds it. At TX-GAIA shapes (JK = 4096 slots, N = 672 nodes) one
// replica reads ~68 KB (49 KB of slot table, 19 KB of node vectors) and
// writes 10.75 KB: ~25 ns of HBM time at 3.35 TB/s. The bytes never bound
// it. What does is launch latency (the main path calls it once per tick at
// E = 1) and the JK*N = 2.75 M slot-node compares per replica.
//
// Design. The TPU kernel builds a (JK, block) one-hot and contracts it on
// the MXU; an f32 product on Hopper's tensor cores would mean TF32, which
// rounds, and float atomics would sum in another order on every run. So
// this first version is simple and deterministic: one thread per node,
// 128 nodes per block, grid (ceil(N/128), E). The block stages the slot
// table through shared memory in tiles of 1024 slots (12 KB: ids, cpu,
// gpu), every thread reads each staged slot (a shared-memory broadcast,
// no bank conflicts) and adds the slots that name its node in ascending
// slot order, in f32. The power chain then runs in registers and each
// output is written once, coalesced. Built with --fmad=false, so the
// arithmetic rounds op by op as the plain PyTorch version does. Making it
// fast (fewer compares per slot, more blocks per replica) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kBlock) power_scatter_kernel(
    const int* __restrict__ place,        // (E, JK)
    const float* __restrict__ cpu_abs,    // (E, JK)
    const float* __restrict__ gpu_abs,    // (E, JK)
    const float* __restrict__ cap_cpu,    // (N,)
    const float* __restrict__ cap_gpu,    // (N,)
    const float* __restrict__ idle_w,     // (N,)
    const float* __restrict__ cpu_dyn_w,  // (N,)
    const float* __restrict__ gpu_dyn_w,  // (N,)
    const float* __restrict__ node_up,    // (E, N)
    const float* __restrict__ node_max_w, // (N,)
    float* __restrict__ it_out,           // (E, N)
    float* __restrict__ input_out,        // (E, N)
    float* __restrict__ cf_out,           // (E, N)
    float* __restrict__ gf_out,           // (E, N)
    int jk, int n_nodes,
    float rect_peak, float rect_load, float rect_curv, float conv_eff) {
  __shared__ int s_place[kTile];
  __shared__ float s_cpu[kTile];
  __shared__ float s_gpu[kTile];

  const int e = blockIdx.y;
  const int node = blockIdx.x * kBlock + threadIdx.x;
  const size_t slot0 = static_cast<size_t>(e) * jk;

  float load_c = 0.0f;
  float load_g = 0.0f;
  for (int base = 0; base < jk; base += kTile) {
    const int count = min(kTile, jk - base);
    for (int i = threadIdx.x; i < count; i += kBlock) {
      s_place[i] = place[slot0 + base + i];
      s_cpu[i] = cpu_abs[slot0 + base + i];
      s_gpu[i] = gpu_abs[slot0 + base + i];
    }
    __syncthreads();
    for (int i = 0; i < count; ++i) {
      if (s_place[i] == node) {
        load_c += s_cpu[i];
        load_g += s_gpu[i];
      }
    }
    __syncthreads();
  }
  if (node >= n_nodes) return;

  const size_t out = static_cast<size_t>(e) * n_nodes + node;
  const float cf = fminf(fmaxf(load_c / fmaxf(cap_cpu[node], 1e-6f), 0.0f), 1.0f);
  const float gf = fminf(fmaxf(load_g / fmaxf(cap_gpu[node], 1e-6f), 0.0f), 1.0f);
  const float it =
      (idle_w[node] + cf * cpu_dyn_w[node] + gf * gpu_dyn_w[node]) * node_up[out];
  const float load = fminf(fmaxf(it / fmaxf(node_max_w[node], 1.0f), 0.0f), 1.2f);
  const float d = load - rect_load;
  const float eta = fminf(fmaxf(rect_peak - rect_curv * (d * d), 0.5f), 1.0f);
  it_out[out] = it;
  input_out[out] = it / (eta * conv_eff);
  cf_out[out] = cf;
  gf_out[out] = gf;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it. The caller allocates every output and checks the shapes.
extern "C" int power_scatter_launch(
    const void* place, const void* cpu_abs, const void* gpu_abs,
    const void* cap_cpu, const void* cap_gpu, const void* idle_w,
    const void* cpu_dyn_w, const void* gpu_dyn_w, const void* node_up,
    const void* node_max_w, void* it_out, void* input_out, void* cf_out,
    void* gf_out, int n_rep, int jk, int n_nodes, float rect_peak,
    float rect_load, float rect_curv, float conv_eff, void* stream) {
  if (n_rep == 0 || n_nodes == 0) return 0;
  const dim3 grid((n_nodes + kBlock - 1) / kBlock, n_rep);
  power_scatter_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(place), static_cast<const float*>(cpu_abs),
      static_cast<const float*>(gpu_abs), static_cast<const float*>(cap_cpu),
      static_cast<const float*>(cap_gpu), static_cast<const float*>(idle_w),
      static_cast<const float*>(cpu_dyn_w), static_cast<const float*>(gpu_dyn_w),
      static_cast<const float*>(node_up), static_cast<const float*>(node_max_w),
      static_cast<float*>(it_out), static_cast<float*>(input_out),
      static_cast<float*>(cf_out), static_cast<float*>(gf_out), jk, n_nodes,
      rect_peak, rect_load, rect_curv, conv_eff);
  return static_cast<int>(cudaGetLastError());
}
