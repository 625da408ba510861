// Placement scatter + node power chain for Hopper (sm_90a), one block per
// replica, in two entries:
//
// - `power_scatter` replaces the TPU kernel `power_scatter_pallas` of the
//   JAX package (src/repro/kernels/node_power.py:145; body
//   `_power_scatter_kernel` at :116, `pl.pallas_call` at :192). Same
//   function, per replica e and node n:
//     load_c = sum_s cpu_abs[e,s] * [place[e,s] == n]   (slots with id -1
//     load_g = sum_s gpu_abs[e,s] * [place[e,s] == n]    match no node)
//     cf, gf = clip(load / max(cap, 1e-6), 0, 1)
//     it     = (idle + cf*cpu_dyn + gf*gpu_dyn) * up[e,n]
//     eta    = clip(peak - curv*(clip(it/max(maxw,1), 0, 1.2) - peak_load)^2,
//                   0.5, 1)
//     input  = it / (eta * conv_eff)
//   and writes (it, input, cf, gf), each (E, N) f32.
// - `power_tick`, the replay tick's entry: the same scatter and chain with
//   their neighbours on the tick fused in (the port's
//   core/power.py::compute_power and, with the thermal twin on, the tail's
//   derate): the job table's utilisation from the trace bank and the slot
//   amounts, then the chain, then fixed-order block sums to the facility
//   totals, the COP, cooling, PUE and GFLOP/s, and with thermals the DVFS
//   derate from the previous tick's rack temperatures and each job's
//   slowest-node clock. The trace bank is (W, J, Q): replica e reads the
//   slice of its workload id (W = 1 and ids of 0 for a single bank; an id
//   outside [0, W) reads nothing and gives the replica NaN). Its plain
//   version is kernels/node_power.py::power_tick_torch.
//
// What bounds it. At TX-GAIA shapes (4096 slots, 672 nodes, 256 jobs) one
// replica's tick reads ~45 KB and writes ~6.5 KB: ~15 ns at 3.35 TB/s, and
// ~35 K f32 operations. Neither bounds it: the main path calls it once a
// tick at E = 1, so its time is the launch and the latency of a few
// dependent rounds of loads and barriers in one block.
//
// Design. One block of 1024 threads per replica (grid (E,)). The slot
// table is staged in shared memory (dynamic, ~68 KB with the sort's
// scratch; the tick adds 32 KB for the per-job amounts, computed once a
// job) and bucketed by node with the counting sort of segment_sum.cuh;
// one thread per node then adds its own bucket in ascending slot order, as the CPU plain version's `index_add_` does, so with
// --fmad=false every per-node value has the CPU's bits. No float atomics.
// Tables wider than one tile (4096 slots) or 1024 nodes loop over tiles in
// ascending order inside each node chunk. The block sums run in one fixed
// order, so they repeat bitwise (against the CPU's `torch.sum` they agree
// to rounding).

#include <cuda_runtime.h>

#include "segment_sum.cuh"
#include "throttle.cuh"

// The node constants and the tick's config, fixed for a simulation: made
// once by the wrapper (kernels/node_power.py::TickStatics, which mirrors
// this layout field for field) and passed by value to every launch.
struct TickStatics {
  const float* cpu_trace;    // (W, J, Q)
  const float* gpu_trace;    // (W, J, Q)
  const float* cap_cpu;      // (N,)
  const float* cap_gpu;
  const float* idle_w;
  const float* cpu_dyn_w;
  const float* gpu_dyn_w;
  const float* node_max_w;
  const float* peak_gflops;
  const int* node_rack;      // (N,)
  int n_jobs, n_slots, n_quanta, n_nodes, n_racks, n_res, thermal, n_work;
  float quanta, rect_peak, rect_load, rect_curv, conv_eff;
  float cop_base, cop_wetbulb_coef, wetbulb_ref, cop_min;
  Throttle throttle;
  float nameplate, cop_load_coef, cop_load_ref;
};

// The per-tick state of every replica, and the one output buffer:
// node_it (E, N), node_input (E, N), scalars (E, 8), job factor (E, J).
struct TickState {
  const int* jstate;         // (E, J)
  const float* t;            // (E,)
  const float* start_t;      // (E, J)
  const int* placement;      // (E, J, K)
  const float* req;          // (E, NRES, J)
  const float* node_up;      // (E, N)
  const float* rack_outlet;  // (E, R)
  const float* wetbulb;      // (E,)
  const int* workload;       // (E,) slice of the trace bank
  float* out;
};

namespace {

using seg::kBlock;
using seg::kTile;
using Smem = seg::Smem<2>;

// The tick kernel's shared memory: the sort's, and the slot amounts of
// each job a tile spans.
struct TickSmem {
  Smem seg;
  float job[2][kTile];
  float slot_clock[kTile + kTile / 32];   // skewed: see skew()
};

// A job's K slots are read by one thread, the jobs of a warp K slots
// apart: one padding word every 32 keeps them off one bank.
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

constexpr int kRunning = 2;      // core/state.py: RUNNING
constexpr int kScalars = 8;      // power_tick's per-replica scalars

struct Chain {
  float rect_peak, rect_load, rect_curv, conv_eff;
};

// The node chain: per-node loads -> (it, input, cf, gf), op by op as
// kernels/node_power.py::node_chain rounds it.
__device__ __forceinline__ void node_chain(
    float load_c, float load_g, float cap_c, float cap_g, float idle,
    float cdyn, float gdyn, float up, float maxw, const Chain& c, float& it,
    float& input, float& cf, float& gf) {
  cf = fminf(fmaxf(load_c / fmaxf(cap_c, 1e-6f), 0.0f), 1.0f);
  gf = fminf(fmaxf(load_g / fmaxf(cap_g, 1e-6f), 0.0f), 1.0f);
  it = (idle + cf * cdyn + gf * gdyn) * up;
  const float load = fminf(fmaxf(it / fmaxf(maxw, 1.0f), 0.0f), 1.2f);
  const float d = load - c.rect_load;
  const float eta = fminf(fmaxf(c.rect_peak - c.rect_curv * (d * d), 0.5f),
                          1.0f);
  input = it / (eta * c.conv_eff);
}

// One node's inputs to the chain and the derate.
struct NodeIn {
  float cap_cpu, cap_gpu, idle, cpu_dyn, gpu_dyn, max_w, peak_gflops, up;
  float outlet;    // its rack's outlet temperature (thermals on)
};

__device__ __forceinline__ NodeIn load_node(const TickStatics& st,
                                            const float* up,
                                            const float* outlet, int n,
                                            int rack) {
  return NodeIn{st.cap_cpu[n], st.cap_gpu[n], st.idle_w[n], st.cpu_dyn_w[n],
                st.gpu_dyn_w[n], st.node_max_w[n], st.peak_gflops[n], up[n],
                st.thermal ? outlet[rack] : 0.0f};
}

__global__ void __launch_bounds__(kBlock) power_scatter_slots_kernel(
    const int* __restrict__ place, const float* __restrict__ cpu_abs,
    const float* __restrict__ gpu_abs, const float* __restrict__ cap_cpu,
    const float* __restrict__ cap_gpu, const float* __restrict__ idle_w,
    const float* __restrict__ cpu_dyn_w, const float* __restrict__ gpu_dyn_w,
    const float* __restrict__ node_up, const float* __restrict__ node_max_w,
    float* __restrict__ it_out, float* __restrict__ input_out,
    float* __restrict__ cf_out, float* __restrict__ gf_out, int jk,
    int n_nodes, Chain chain) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t slot0 = static_cast<size_t>(e) * jk;

  for (int n0 = 0; n0 < n_nodes; n0 += kBlock) {
    const int nk = min(kBlock, n_nodes - n0);
    float acc[2] = {0.0f, 0.0f};
    for (int base = 0; base < jk; base += kTile) {
      const int count = min(kTile, jk - base);
#pragma unroll
      for (int r = 0; r < kTile / kBlock; ++r) {   // loads all in flight
        const int i = tid + r * kBlock;
        if (i >= count) break;
        const int p = place[slot0 + base + i];
        s.key[i] = (p >= n0 && p - n0 < nk) ? p - n0 : -1;
        s.val[0][i] = cpu_abs[slot0 + base + i];
        s.val[1][i] = gpu_abs[slot0 + base + i];
      }
      seg::add_tile<2>(s, count, nk, acc);
    }
    if (tid < nk) {
      const int n = n0 + tid;
      const size_t out = static_cast<size_t>(e) * n_nodes + n;
      float it, input, cf, gf;
      node_chain(acc[0], acc[1], cap_cpu[n], cap_gpu[n], idle_w[n],
                 cpu_dyn_w[n], gpu_dyn_w[n], node_up[out], node_max_w[n],
                 chain, it, input, cf, gf);
      it_out[out] = it;
      input_out[out] = input;
      cf_out[out] = cf;
      gf_out[out] = gf;
    }
  }
}

__global__ void __launch_bounds__(kBlock) power_scatter_tick_kernel(
    TickStatics st, TickState d, int n_rep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TickSmem& ts = *reinterpret_cast<TickSmem*>(smem_raw);
  Smem& s = ts.seg;
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int J = st.n_jobs, K = st.n_slots, N = st.n_nodes, R = st.n_racks;
  const int jk = J * K;
  const int step_jobs = kBlock / K, step_slots = kBlock % K;
  const Chain chain{st.rect_peak, st.rect_load, st.rect_curv, st.conv_eff};
  const float t = d.t[e];
  const int* jstate = d.jstate + static_cast<size_t>(e) * J;
  const float* start_t = d.start_t + static_cast<size_t>(e) * J;
  const int* place = d.placement + static_cast<size_t>(e) * jk;
  const float* req = d.req + static_cast<size_t>(e) * st.n_res * J;
  const float* up = d.node_up + static_cast<size_t>(e) * N;
  const float* outlet = d.rack_outlet + static_cast<size_t>(e) * R;
  float* node_it = d.out + static_cast<size_t>(e) * N;
  float* node_input = d.out + static_cast<size_t>(n_rep) * N
                      + static_cast<size_t>(e) * N;
  float* scal = d.out + 2 * static_cast<size_t>(n_rep) * N + e * kScalars;
  float* job_th = d.out + 2 * static_cast<size_t>(n_rep) * N
                  + static_cast<size_t>(n_rep) * kScalars
                  + static_cast<size_t>(e) * J;
  // the replica's slice of the bank; an id out of range reads nothing
  const int w = d.workload[e];
  if (w < 0 || w >= st.n_work) {   // the same for the whole block
    const float nan = __int_as_float(0x7fc00000);
    for (int i = tid; i < N; i += kBlock) node_it[i] = node_input[i] = nan;
    if (tid < kScalars) scal[tid] = nan;
    if (st.thermal)
      for (int j = tid; j < J; j += kBlock) job_th[j] = nan;
    return;
  }
  const size_t bank = static_cast<size_t>(w) * J * st.n_quanta;
  const float* cpu_trace = st.cpu_trace + bank;
  const float* gpu_trace = st.gpu_trace + bank;

  // one node chunk and one slot tile (the main path's shapes): the node's
  // throttle is loaded ahead, its dependent loads hidden behind the sort,
  // and the job factors read the staged slots and throttles from shared
  const bool one_pass = N <= kBlock && jk <= kTile;
  // with one node chunk, thread tid's node is tid: its inputs are loaded
  // while the first tile is staged and consumed after the sort
  const bool ahead = N <= kBlock && tid < N;
  const int rack_ahead = st.thermal && ahead ? st.node_rack[tid] : 0;
  NodeIn in_ahead{};

  // it, input, gflops (pre-derate), idle, and with thermals dyn, th*dyn
  float red[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = 0; n0 < N; n0 += kBlock) {
    const int nk = min(kBlock, N - n0);
    float acc[2] = {0.0f, 0.0f};
    for (int base = 0; base < jk; base += kTile) {
      const int count = min(kTile, jk - base);
      // the tile's slot ids first, so their loads overlap the jobs'
      int slot_node[kTile / kBlock];
#pragma unroll
      for (int r = 0; r < kTile / kBlock; ++r) {
        const int i = tid + r * kBlock;
        slot_node[r] = i < count ? place[base + i] : -1;
      }
      // core/power.py::job_utilization and placement_amounts, once for
      // each job the tile spans
      const int j0 = base / K;
      const int n_jobs = (base + count - 1) / K - j0 + 1;
      for (int jj = tid; jj < n_jobs; jj += kBlock) {
        const int j = j0 + jj;
        const float running = jstate[j] == kRunning ? 1.0f : 0.0f;
        const float age = fmaxf(t - start_t[j], 0.0f);
        // a true IEEE division (no reciprocal), truncated toward zero
        int qi = static_cast<int>(age / st.quanta);
        qi = min(max(qi, 0), st.n_quanta - 1);
        const size_t q = static_cast<size_t>(j) * st.n_quanta + qi;
        ts.job[0][jj] = req[j] * (cpu_trace[q] * running);
        ts.job[1][jj] = req[J + j] * (gpu_trace[q] * running);
      }
      __syncthreads();
      // slot base + tid + r * kBlock is job jj's slot k; one division a
      // thread, then steps of kBlock slots
      int jj = (base + tid) / K - j0;
      int k = (base + tid) - (jj + j0) * K;
#pragma unroll
      for (int r = 0; r < kTile / kBlock; ++r) {
        const int i = tid + r * kBlock;
        if (r > 0) {
          jj += step_jobs;
          k += step_slots;
          if (k >= K) {
            k -= K;
            ++jj;
          }
        }
        if (i < count) {
          const int p = slot_node[r];
          const float w = p >= 0 ? 1.0f : 0.0f;
          s.key[i] = (p >= n0 && p - n0 < nk) ? p - n0 : -1;
          s.val[0][i] = ts.job[0][jj] * w;
          s.val[1][i] = ts.job[1][jj] * w;
        }
      }
      if (ahead && base == 0)
        in_ahead = load_node(st, up, outlet, tid, rack_ahead);
      seg::add_tile<2>(s, count, nk, acc);
    }
    if (tid < nk) {
      const int n = n0 + tid;
      const NodeIn in = ahead ? in_ahead
                              : load_node(st, up, outlet, n,
                                          st.thermal ? st.node_rack[n] : 0);
      float it, input, cf, gf;
      node_chain(acc[0], acc[1], in.cap_cpu, in.cap_gpu, in.idle, in.cpu_dyn,
                 in.gpu_dyn, in.up, in.max_w, chain, it, input, cf, gf);
      const float idle = in.idle * in.up;
      red[2] += in.peak_gflops * fmaxf(cf, gf) * in.up;
      red[3] += idle;
      if (st.thermal) {
        // derate from the previous tick's outlet temperatures: only the
        // node's dynamic power throttles, input power scales with IT
        const float th = throttle(st.throttle, in.outlet);
        if (one_pass) s.val[0][n] = th;   // the sort is done with val
        const float dyn = fmaxf(it - idle, 0.0f);
        const float it2 = idle + th * dyn;
        input = input * (it2 / fmaxf(it, 1e-9f));
        it = it2;
        red[4] += dyn;
        red[5] += th * dyn;
      }
      node_it[n] = it;
      node_input[n] = input;
      red[0] += it;
      red[1] += input;
    }
  }
  seg::block_sum<6>(red, s.red);
  if (tid == 0) {
    const float it_w = red[0];
    const float input_w = red[1];
    const float wb = d.wetbulb[e];
    float cop = st.cop_base + st.cop_wetbulb_coef * (wb - st.wetbulb_ref);
    float gflops = red[2];
    if (st.thermal) {
      const float gscale =
          red[4] > 0.0f ? red[5] / fmaxf(red[4], 1e-9f) : 1.0f;
      cop = cop + st.cop_load_coef * (it_w / st.nameplate - st.cop_load_ref);
      gflops = gflops * gscale;
    }
    cop = fmaxf(cop, st.cop_min);
    const float cooling = input_w / cop;
    const float facility = input_w + cooling;
    scal[0] = it_w;
    scal[1] = input_w;
    scal[2] = cooling;
    scal[3] = facility;
    scal[4] = it_w > 1.0f ? facility / fmaxf(it_w, 1.0f) : 1.0f;
    scal[5] = gflops;
    scal[6] = cop;
    scal[7] = red[3];
  }
  if (st.thermal) {
    // synchronous ranks run at the slowest clock over a job's nodes
    if (one_pass) {
      // each slot's clock from the staged slots and throttles (block_sum's
      // barriers published them), then a job's minimum over its slots
#pragma unroll
      for (int r = 0; r < kTile / kBlock; ++r) {
        const int i = tid + r * kBlock;
        if (i < jk) {
          const int node = s.key[i];     // -1: no node
          ts.slot_clock[skew(i)] = node >= 0 ? s.val[0][node] : 1.0f;
        }
      }
      __syncthreads();
      for (int j = tid; j < J; j += kBlock) {
        float m = 1.0f;
        for (int k = 0; k < K; ++k)
          m = fminf(m, ts.slot_clock[skew(j * K + k)]);
        job_th[j] = m;
      }
    } else {
      for (int j = tid; j < J; j += kBlock) {
        float m = 1.0f;
        for (int k = 0; k < K; ++k) {
          const int p = place[j * K + k];
          if (p >= 0 && p < N)
            m = fminf(m, throttle(st.throttle, outlet[st.node_rack[p]]));
        }
        job_th[j] = m;
      }
    }
  }
}

__global__ void empty_kernel() {}

// Dynamic shared memory above 48 KB must be allowed once per kernel and
// device.
int allow_smem(const void* kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

bool slots_ready[64];
bool tick_ready[64];

}  // namespace

// Each entry launches on `stream` (PyTorch's current stream of the
// tensors' device; `power_tick` makes that device current itself, the
// others need the caller to) and returns
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
  const int err = allow_smem(
      reinterpret_cast<const void*>(power_scatter_slots_kernel), sizeof(Smem),
      slots_ready);
  if (err != 0) return err;
  power_scatter_slots_kernel<<<n_rep, kBlock, sizeof(Smem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(place), static_cast<const float*>(cpu_abs),
      static_cast<const float*>(gpu_abs), static_cast<const float*>(cap_cpu),
      static_cast<const float*>(cap_gpu), static_cast<const float*>(idle_w),
      static_cast<const float*>(cpu_dyn_w), static_cast<const float*>(gpu_dyn_w),
      static_cast<const float*>(node_up), static_cast<const float*>(node_max_w),
      static_cast<float*>(it_out), static_cast<float*>(input_out),
      static_cast<float*>(cf_out), static_cast<float*>(gf_out), jk, n_nodes,
      Chain{rect_peak, rect_load, rect_curv, conv_eff});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int power_tick_launch(
    const TickStatics* st, const void* jstate, const void* t,
    const void* start_t, const void* placement, const void* req,
    const void* node_up, const void* rack_outlet, const void* wetbulb,
    const void* workload, void* out, int n_rep, int device, void* stream) {
  if (n_rep == 0 || st->n_nodes == 0) return 0;
  const seg::DeviceGuard guard(device);
  if (guard.err != 0) return guard.err;
  const int err = allow_smem(
      reinterpret_cast<const void*>(power_scatter_tick_kernel),
      sizeof(TickSmem), tick_ready);
  if (err != 0) return err;
  const TickState d{
      static_cast<const int*>(jstate), static_cast<const float*>(t),
      static_cast<const float*>(start_t), static_cast<const int*>(placement),
      static_cast<const float*>(req), static_cast<const float*>(node_up),
      static_cast<const float*>(rack_outlet),
      static_cast<const float*>(wetbulb), static_cast<const int*>(workload),
      static_cast<float*>(out)};
  power_scatter_tick_kernel<<<n_rep, kBlock, sizeof(TickSmem),
                              static_cast<cudaStream_t>(stream)>>>(*st, d,
                                                                   n_rep);
  return static_cast<int>(cudaGetLastError());
}

// One empty kernel: the floor under any launch's back-to-back time.
extern "C" int launch_floor_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int power_tick_statics_size() {
  return static_cast<int>(sizeof(TickStatics));
}
