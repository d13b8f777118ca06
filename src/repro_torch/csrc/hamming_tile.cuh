// Device code shared by hamming.cu and megascan.cu (Hopper, sm_90a).
//
//   * stage: a block's TB packed query signatures, once, into shared
//     memory, transposed to [W][TB] so one word's TB query words are
//     two uint4 loads that every lane of a warp reads at the same
//     address (a broadcast, no bank conflicts); and, for the float
//     kernels, the value table below;
//   * row_distances: one row's TB Hamming distances, XOR + __popc over
//     its W words, each word loaded once;
//   * slot_sum: one warp's sum of table[distance] over a contiguous row
//     range [lo, hi) — lane l takes rows lo+l, lo+l+32, ... in that
//     order, then a fixed xor-butterfly adds the 32 partials, so every
//     lane ends with the same totals and a slot's sum depends only on
//     its own rows, taken in a fixed order (no float atomics).
//
// The value table.  The distance m of two W-word signatures is an
// integer in [0, 32 W], so exp(beta * cos(pi * m / bits)) takes at most
// 32 W + 1 values.  The wrapper makes that table once per (bits, W,
// beta) on the host and passes it in; the kernels read table[m].  So
// the kernels and their plain versions, which read the same table,
// give the same bits for every (query, row) value, on every device.
//
// The sum adds with __fadd_rn, which the compiler never contracts, so
// every kernel that inlines slot_sum rounds each add the same way: the
// segment sum over a slot map and the megascan over the block-aligned
// payload give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hamming_tile {

constexpr int TB = 8;                       // query signatures per block
constexpr int THREADS = 256;                // threads per block
constexpr int WARPS = THREADS / 32;

// q_t[k * TB + b] = q[q0 + b][k] (zero for padding rows); tab_s[i] =
// table[i] for i <= 32 W when `table` is given.
__device__ inline void stage(const uint32_t* __restrict__ q,
                             const float* __restrict__ table, int N, int W,
                             int q0, uint32_t* q_t, float* tab_s) {
  const int nb = min(TB, N - q0);
  for (int i = threadIdx.x; i < TB * W; i += blockDim.x) {
    const int k = i / TB;
    const int b = i - k * TB;
    q_t[i] = (b < nb) ? q[(size_t)(q0 + b) * W + k] : 0u;
  }
  if (table != nullptr)
    for (int i = threadIdx.x; i <= 32 * W; i += blockDim.x) tab_s[i] = table[i];
  __syncthreads();
}

// dist[b] = sum over the W words of popcount(q[b] ^ row)
__device__ __forceinline__ void row_distances(const uint32_t* __restrict__ row,
                                              int W,
                                              const uint4* __restrict__ q4,
                                              int (&dist)[TB]) {
#pragma unroll
  for (int b = 0; b < TB; ++b) dist[b] = 0;
  for (int k = 0; k < W; ++k) {
    const uint32_t d = __ldg(row + k);
    const uint4 lo = q4[2 * k];
    const uint4 hi = q4[2 * k + 1];
    dist[0] += __popc(lo.x ^ d);
    dist[1] += __popc(lo.y ^ d);
    dist[2] += __popc(lo.z ^ d);
    dist[3] += __popc(lo.w ^ d);
    dist[4] += __popc(hi.x ^ d);
    dist[5] += __popc(hi.y ^ d);
    dist[6] += __popc(hi.z ^ d);
    dist[7] += __popc(hi.w ^ d);
  }
}

// acc[b] = sum of tab[distance] over rows [lo, hi) for the block's TB
// queries, in the same bits on every lane of the calling warp.  The
// whole warp must call it with the same lo and hi.
__device__ __forceinline__ void slot_sum(const uint32_t* __restrict__ db,
                                         int lo, int hi, int W,
                                         const uint4* __restrict__ q4,
                                         const float* __restrict__ tab,
                                         float (&acc)[TB]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.f;
  for (int m = lo + lane; m < hi; m += 32) {
    int dist[TB];
    row_distances(db + (size_t)m * W, W, q4, dist);
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = __fadd_rn(acc[b], tab[dist[b]]);
  }
  // fixed-shape butterfly: every lane ends with the same total
#pragma unroll
  for (int b = 0; b < TB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] = __fadd_rn(acc[b], __shfl_xor_sync(0xffffffffu, acc[b], off));
  }
}

// Dynamic shared memory of a block: the query words [W][TB] and the
// (32 W + 1)-entry value table.
inline size_t smem_bytes(int W) {
  return (size_t)TB * W * sizeof(uint32_t) + (size_t)(32 * W + 1) * sizeof(float);
}

}  // namespace hamming_tile
