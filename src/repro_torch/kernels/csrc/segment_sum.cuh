// Deterministic segmented sums for one block: a tile of (key, values)
// items -> one sum per key, each adding its items in ascending item order.
//
// The replay tick's scatters (job slots onto nodes, nodes onto racks) must
// give the same bits on every run and the same bits as the CPU plain
// version, whose `index_add_` adds in ascending item order. Float atomics
// would add in another order on every run, and one thread per key walking
// the whole tile (the first design) costs keys x items compares. So the
// block buckets the tile by key with a counting sort, and then one thread
// per key adds its own bucket in ascending item order:
//   1. each item bumps its key's count (integer shared-memory atomics: the
//      counts do not depend on their order);
//   2. a block scan of the counts gives each key's offset;
//   3. each item takes the next place in its key's bucket (integer
//      atomics again: the order inside a bucket may differ run to run);
//   4. the thread of a key sorts its bucket's item indices ascending (a
//      bucket holds a few items: one per job on a node, one per node in a
//      rack) and adds the items in that order, so the sum has the same
//      bits whatever order step 3 left. (Ranking each item inside its
//      bucket in parallel instead was slower on the card: a warp waits
//      for the largest of its 32 buckets, four times a thread.)
// No float atomics; every sum depends on the data alone.
//
// Keys arrive in chunks of kBlock (one key a thread) and items in tiles of
// kTile, so any key and item count works: a caller loops over key chunks
// and, inside each, over tiles in ascending order, carrying each key's
// partial sums in registers. The tick's shapes (4096 slots, 672 nodes;
// 672 nodes, 21 racks) take one chunk and one tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg {

constexpr int kBlock = 1024;              // threads; also keys per chunk
constexpr int kWarps = kBlock / 32;
constexpr int kTile = 4096;               // items per tile
constexpr int kMaxSums = 8;               // block_sum's widest call

// Shared memory of one block, carved from the dynamic allocation.
// Shared memory of one block, carved from the dynamic allocation.
template <int NV>
struct Smem {
  int key[kTile];                 // key of each item, -1: not in the chunk
  float val[NV][kTile];           // the item values
  uint16_t order[kTile];          // item indices, bucketed by key
  int offset[kBlock];             // first bucket position of each key
  int total[kBlock];              // items of each key
  int cursor[kBlock];             // next free place in each bucket
  int scan[kWarps];               // block scan
  float red[kWarps * kMaxSums];   // block sums
};

// Inclusive sum of `v` over the block's threads; every thread calls it.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  __syncthreads();
  return v;
}

// Adds the tile staged in `s.key` / `s.val` (`count` items, keys already
// shifted into [0, n_keys) of this chunk or -1) to `acc`, the running sums
// of this thread's key `threadIdx.x` (used only when it is < n_keys).
// Every thread of the block must call it. It starts with a barrier, which
// publishes the staged tile, and ends with one.
template <int NV>
__device__ void add_tile(Smem<NV>& s, int count, int n_keys, float (&acc)[NV]) {
  const int tid = threadIdx.x;
  if (tid < n_keys) s.total[tid] = 0;
  __syncthreads();

  // 1. counts
#pragma unroll
  for (int r = 0; r < kTile / kBlock; ++r) {
    const int i = tid + r * kBlock;
    if (i < count && s.key[i] >= 0) atomicAdd(&s.total[s.key[i]], 1);
  }
  __syncthreads();

  // 2. offsets: exclusive scan of the counts
  const int tot = tid < n_keys ? s.total[tid] : 0;
  const int incl = block_inclusive_scan(tot, s.scan);
  if (tid < n_keys) s.offset[tid] = s.cursor[tid] = incl - tot;
  __syncthreads();

  // 3. buckets, in any order inside each
#pragma unroll
  for (int r = 0; r < kTile / kBlock; ++r) {
    const int i = tid + r * kBlock;
    if (i < count && s.key[i] >= 0)
      s.order[atomicAdd(&s.cursor[s.key[i]], 1)] = static_cast<uint16_t>(i);
  }
  __syncthreads();

  // 4. each key's bucket sorted ascending (insertion sort: a bucket holds
  // a few items), then added in that order
  if (tid < n_keys) {
    uint16_t* b = s.order + s.offset[tid];
    const int m = s.total[tid];
    for (int x = 1; x < m; ++x) {
      const uint16_t v = b[x];
      int y = x - 1;
      while (y >= 0 && b[y] > v) {
        b[y + 1] = b[y];
        --y;
      }
      b[y + 1] = v;
    }
    for (int x = 0; x < m; ++x) {
      const int i = b[x];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] += s.val[v][i];
    }
  }
  __syncthreads();
}

// Sum of `v` over the block's threads in a fixed order (a butterfly inside
// each warp, then warp 0 over the warp sums): the same bits on every run.
// The result is valid in thread 0. Every thread must call it.
template <int NS>
__device__ void block_sum(float (&v)[NS], float* scratch /* kWarps * NS */) {
  static_assert(NS <= kMaxSums, "block_sum: widen kMaxSums");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) scratch[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      v[k] = scratch[k * kWarps + lane];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], d);
    }
  }
  __syncthreads();
}

// Makes `device` current for a launch from the host and restores the
// caller's device after it, so a wrapper needs no device context of its
// own. `err` is the CUDA error of the switch (0 when none was needed).
struct DeviceGuard {
  int prev = -1;
  int err = 0;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = static_cast<int>(cudaGetDevice(&cur));
    if (err == 0 && cur != device) {
      err = static_cast<int>(cudaSetDevice(device));
      if (err == 0) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace seg
