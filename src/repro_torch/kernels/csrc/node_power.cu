// Node power chain from load fractions for Hopper (sm_90a).
//
// Replaces the TPU kernel `node_power_pallas` of the JAX package
// (src/repro/kernels/node_power.py:45; body `_power_kernel` at :25,
// `pl.pallas_call` at :82). Same function, per replica e and node n:
//   it    = (idle + cpu_frac[e,n]*cpu_dyn + gpu_frac[e,n]*gpu_dyn) * up[e,n]
//   eta   = clip(peak - curv*(clip(it/max(maxw,1), 0, 1.2) - peak_load)^2,
//                0.5, 1)
//   input = it / (eta * conv_eff)
// and writes (it, input), each (E, N) f32.
//
// What bounds it. Per element it reads 3 (E, N) values and 4 node
// constants and writes 2 values, for ~15 f32 operations: at most 2 ops per
// byte, far below the card's ~20 f32 ops per byte of HBM, so it is bound by
// bytes once E*N is large. At TX-GAIA's N = 672 even E = 64 moves ~0.9 MB,
// ~0.26 us at 3.35 TB/s, so at the shapes it is called with its time is
// the launch's latency.
//
// Design. An elementwise pass: one thread per (e, n), 256 threads a block,
// consecutive threads on consecutive nodes so every load and store is
// coalesced; the node constants are re-read per replica and served from L2.
// No intermediate leaves registers. Built with --fmad=false, so the
// arithmetic rounds op by op as the plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) node_power_kernel(
    const float* __restrict__ cpu_frac,   // (E, N)
    const float* __restrict__ gpu_frac,   // (E, N)
    const float* __restrict__ idle_w,     // (N,)
    const float* __restrict__ cpu_dyn_w,  // (N,)
    const float* __restrict__ gpu_dyn_w,  // (N,)
    const float* __restrict__ node_up,    // (E, N)
    const float* __restrict__ node_max_w, // (N,)
    float* __restrict__ it_out,           // (E, N)
    float* __restrict__ input_out,        // (E, N)
    long long total, int n_nodes,
    float rect_peak, float rect_load, float rect_curv, float conv_eff) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= total) return;
  const int node = static_cast<int>(i % n_nodes);
  const float it =
      (idle_w[node] + cpu_frac[i] * cpu_dyn_w[node] + gpu_frac[i] * gpu_dyn_w[node])
      * node_up[i];
  const float load = fminf(fmaxf(it / fmaxf(node_max_w[node], 1.0f), 0.0f), 1.2f);
  const float d = load - rect_load;
  const float eta = fminf(fmaxf(rect_peak - rect_curv * (d * d), 0.5f), 1.0f);
  it_out[i] = it;
  input_out[i] = it / (eta * conv_eff);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it. The caller allocates every output and checks the shapes.
extern "C" int node_power_launch(
    const void* cpu_frac, const void* gpu_frac, const void* idle_w,
    const void* cpu_dyn_w, const void* gpu_dyn_w, const void* node_up,
    const void* node_max_w, void* it_out, void* input_out, int n_rep,
    int n_nodes, float rect_peak, float rect_load, float rect_curv,
    float conv_eff, void* stream) {
  const long long total = static_cast<long long>(n_rep) * n_nodes;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kBlock - 1) / kBlock);
  node_power_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cpu_frac), static_cast<const float*>(gpu_frac),
      static_cast<const float*>(idle_w), static_cast<const float*>(cpu_dyn_w),
      static_cast<const float*>(gpu_dyn_w), static_cast<const float*>(node_up),
      static_cast<const float*>(node_max_w), static_cast<float*>(it_out),
      static_cast<float*>(input_out), total, n_nodes, rect_peak, rect_load,
      rect_curv, conv_eff);
  return static_cast<int>(cudaGetLastError());
}
