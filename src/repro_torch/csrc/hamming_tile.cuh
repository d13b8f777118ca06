// Device code shared by hamming.cu and megascan.cu (Hopper, sm_90a).
//
//   * stage: a block's QT packed query signatures (TB = 8 in hamming.cu,
//     16 in the megascan), once, into shared memory, transposed to
//     [W][QT] so one word's query words are uint4 loads that every lane
//     of a warp reads at the same address (a broadcast, no bank
//     conflicts); and, for the float kernels, the value table below;
//   * row_distances: one row's Hamming distances to the tile's first NB
//     queries, XOR + __popc over its W words, each word loaded once
//     (NB is a template, so a partly filled tile pays only its live
//     queries; hamming.cu takes all TB, as it always has);
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

// q_t[k * QT + b] = q[q0 + b][k] (zero for padding rows); tab_s[i] =
// table[i] for i <= 32 W when `table` is given.
template <int QT = TB>
__device__ inline void stage(const uint32_t* __restrict__ q,
                             const float* __restrict__ table, int N, int W,
                             int q0, uint32_t* q_t, float* tab_s) {
  const int nb = min(QT, N - q0);
  for (int i = threadIdx.x; i < QT * W; i += blockDim.x) {
    const int k = i / QT;
    const int b = i - k * QT;
    q_t[i] = (b < nb) ? q[(size_t)(q0 + b) * W + k] : 0u;
  }
  if (table != nullptr)
    for (int i = threadIdx.x; i <= 32 * W; i += blockDim.x) tab_s[i] = table[i];
  __syncthreads();
}

// dist[b] += popcount(q[b] ^ d) for the first NB of a QT-query tile's
// words q4 (one word of each query, QT / 4 uint4)
template <int NB>
__device__ __forceinline__ void add_word(uint32_t d,
                                         const uint4* __restrict__ q4,
                                         int (&dist)[NB]) {
#pragma unroll
  for (int i = 0; i < (NB + 3) / 4; ++i) {
    const uint4 w = q4[i];
    dist[4 * i] += __popc(w.x ^ d);
    if (4 * i + 1 < NB) dist[4 * i + 1] += __popc(w.y ^ d);
    if (4 * i + 2 < NB) dist[4 * i + 2] += __popc(w.z ^ d);
    if (4 * i + 3 < NB) dist[4 * i + 3] += __popc(w.w ^ d);
  }
}

// dist[b] = sum over the W words of popcount(q[b] ^ row) for the first
// NB queries of a QT-query tile, each row word loaded once; where
// ``vec`` says the rows allow it (16-byte aligned, W a multiple of 4)
// the words are read four at a time, as one 16-byte load.
template <int QT, int NB>
__device__ __forceinline__ void row_distances(const uint32_t* __restrict__ row,
                                              int W, bool vec,
                                              const uint4* __restrict__ q4,
                                              int (&dist)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) dist[b] = 0;
  if (vec) {                                 // uniform across the warp
    for (int k0 = 0; k0 < W; k0 += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k0));
      add_word<NB>(v.x, q4 + (size_t)k0 * (QT / 4), dist);
      add_word<NB>(v.y, q4 + (size_t)(k0 + 1) * (QT / 4), dist);
      add_word<NB>(v.z, q4 + (size_t)(k0 + 2) * (QT / 4), dist);
      add_word<NB>(v.w, q4 + (size_t)(k0 + 3) * (QT / 4), dist);
    }
  } else {
    for (int k = 0; k < W; ++k)
      add_word<NB>(__ldg(row + k), q4 + (size_t)k * (QT / 4), dist);
  }
}

// acc[b] = sum of tab[distance] over rows [lo, hi) for the first NB
// queries of a QT-query tile, in the same bits on every lane of the
// calling warp.  The whole warp must call it with the same lo and hi.
template <int QT, int NB>
__device__ __forceinline__ void slot_sum(const uint32_t* __restrict__ db,
                                         int lo, int hi, int W, bool vec,
                                         const uint4* __restrict__ q4,
                                         const float* __restrict__ tab,
                                         float (&acc)[NB]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int m = lo + lane; m < hi; m += 32) {
    int dist[NB];
    row_distances<QT, NB>(db + (size_t)m * W, W, vec, q4, dist);
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = __fadd_rn(acc[b], tab[dist[b]]);
  }
  // fixed-shape butterfly: every lane ends with the same total
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] = __fadd_rn(acc[b], __shfl_xor_sync(0xffffffffu, acc[b], off));
  }
}

// Dynamic shared memory of a block: the query words [W][QT] and the
// (32 W + 1)-entry value table.
inline size_t smem_bytes(int W, int QT = TB) {
  return (size_t)QT * W * sizeof(uint32_t) + (size_t)(32 * W + 1) * sizeof(float);
}

}  // namespace hamming_tile
