// Device code shared by asym.cu and megascan.cu (Hopper, sm_90a).
//
//   * project_tile: a block's TB-query projection q . planes^T, once,
//     into shared memory, transposed to [bits][TB];
//   * doc_dots / exp_sim: one row's +-1 dot products with the TB
//     projections, bit 0 first, and exp(beta * clip(dot * scale)); the
//     similarity and top-k kernels (rows 1, 3, 9/10) score with these;
//   * build_tables / lut_slot_sum: the segment sums' (rows 2, 7)
//     table-lookup scoring.  After the projection, the block builds
//     per query and 4-bit chunk c of the signature the 16 signed sums
//         T[c][b][n] = sum_{i<4} (bit i of n ? +1 : -1) * proj[4c+i][b],
//     added i = 0 first, laid out [chunk][query][16] so the 32 lanes of
//     a warp reading one query's entries hit 16 distinct banks whatever
//     nibbles their rows hold (no conflict; equal nibbles broadcast).
//     A row's dot for query b is then one table load and one add per
//     chunk, chunks in ascending order from 0.  lut_slot_sum is one
//     warp's sum of exp_sim over a contiguous row range [lo, hi): lane
//     l takes rows lo+l, lo+l+32, ... in that order, then a fixed
//     xor-butterfly adds the 32 partials, so every lane ends with the
//     same totals and a slot's sum depends only on its own rows, taken
//     in a fixed order (no float atomics).  It is a template on the
//     block's live queries NB, so a partly filled query tile costs only
//     its live queries.  lut_project gives project_tile's projection,
//     bit for bit, from 16-byte loads (the block's set-up, once per
//     block of a one-wave grid), and lut_dots reads a row's words 16
//     bytes at a time where the rows are aligned;
//   * warp_topk: the top-k kernels' selection for K <= WARP_K: one warp
//     scores a tile's real rows, 32 at a time, and keeps each query's
//     K best (value, row) in registers, lane r holding rank r; a
//     ballot finds the rows that beat the current K-th, and only those
//     are inserted, by a shuffle shift.  Order: value descending, ties
//     by ascending row — the order of jax.lax.top_k and of the JAX
//     package's bitonic_sort_desc;
//   * score_tile / bitonic_sort_desc: the selection for K > WARP_K: the
//     block scores the first n rows of a tile into shared memory
//     (masked rows -inf) and sorts them there, n the next power of two
//     above both K and the tile's last real row.
//
// Both give, per tile and query, the first K entries of a stable
// descending sort of the tile's values with masked rows at -inf: real
// rows by (value desc, row asc), then, where fewer than K rows are
// real, the lowest masked rows in ascending order.
//
// The table build, the lookups and the sum add with __fadd_rn, which
// the compiler never contracts into an FMA, so every kernel that
// inlines lut_slot_sum rounds each add the same way: the slice-1
// segment sum over a slot map and the megascan over the block-aligned
// payload give the same bits (repro_torch.testing.lut_segment_sums is
// the same arithmetic in PyTorch, for the CPU tests).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace asym_tile {

constexpr int TB = 8;                       // queries per block
constexpr int THREADS = 256;                // threads per block
constexpr int WARPS = THREADS / 32;

// proj_t[j * TB + b] = q[q0 + b] . planes[j]   (zero for padding rows)
__device__ inline void project_tile(const float* __restrict__ q,
                                    const float* __restrict__ planes,
                                    int B, int dim, int bits, int q0,
                                    float* proj_t, float* q_s) {
  const int nb = min(TB, B - q0);
  for (int i = threadIdx.x; i < TB * dim; i += blockDim.x) {
    const int b = i / dim;
    q_s[i] = (b < nb) ? q[(size_t)(q0 + b) * dim + (i - b * dim)] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < bits; j += blockDim.x) {
    float acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0.f;
    const float* row = planes + (size_t)j * dim;
    for (int d = 0; d < dim; ++d) {
      const float p = __ldg(row + d);
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[b] = fmaf(q_s[b * dim + d], p, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) proj_t[j * TB + b] = acc[b];
  }
  __syncthreads();
}

// dot[b] = sum_j sign_j(row) * proj[b][j] over the first 32*nwords bits
__device__ __forceinline__ void doc_dots(const uint32_t* __restrict__ row,
                                         int nwords,
                                         const float4* __restrict__ proj4,
                                         float (&dot)[TB]) {
#pragma unroll
  for (int b = 0; b < TB; ++b) dot[b] = 0.f;
  for (int k = 0; k < nwords; ++k) {
    const uint32_t w = __ldg(row + k);
    const float4* p = proj4 + (size_t)k * 32 * (TB / 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float s = ((w >> j) & 1u) ? 1.f : -1.f;
      const float4 lo = p[2 * j];
      const float4 hi = p[2 * j + 1];
      dot[0] = fmaf(s, lo.x, dot[0]);
      dot[1] = fmaf(s, lo.y, dot[1]);
      dot[2] = fmaf(s, lo.z, dot[2]);
      dot[3] = fmaf(s, lo.w, dot[3]);
      dot[4] = fmaf(s, hi.x, dot[4]);
      dot[5] = fmaf(s, hi.y, dot[5]);
      dot[6] = fmaf(s, hi.z, dot[6]);
      dot[7] = fmaf(s, hi.w, dot[7]);
    }
  }
}

__device__ __forceinline__ float exp_sim(float dot, float scale,
                                         float temperature) {
  const float c = fminf(fmaxf(dot * scale, -1.f), 1.f);
  return expf(temperature * c);
}

constexpr int LUT_BITS = 4;                 // signature bits per lookup
constexpr int LUT_SIZE = 1 << LUT_BITS;     // entries per (chunk, query)
constexpr int LUT_PER_WORD = 32 / LUT_BITS; // chunks per packed word

// tab[(c * TB + b) * LUT_SIZE + n] = T[c][b][n] for the block's TB
// queries (padding queries have a zero projection, so zero tables)
__device__ inline void build_tables(const float* proj_t, int bits,
                                    float* tab) {
  const int n_entries = bits / LUT_BITS * TB * LUT_SIZE;
  for (int e = threadIdx.x; e < n_entries; e += blockDim.x) {
    const int n = e % LUT_SIZE;
    const int b = (e / LUT_SIZE) % TB;
    const int c = e / (LUT_SIZE * TB);
    const float* p = proj_t + (size_t)c * LUT_BITS * TB + b;
    float t = (n & 1) ? p[0] : -p[0];
#pragma unroll
    for (int i = 1; i < LUT_BITS; ++i)
      t = __fadd_rn(t, ((n >> i) & 1) ? p[i * TB] : -p[i * TB]);
    tab[e] = t;
  }
  __syncthreads();
}

// dot[b] = sum over the 4-bit chunks c of the first 32*nwords bits of
// T[c][b][chunk c of row], c ascending, for the first NB queries.  The
// row's words are read four at a time, as one 16-byte load where
// ``vec`` says the rows allow it (every row 16-byte aligned, nwords a
// multiple of 4), so a warp's 32 rows cost the unified L1/shared
// pipe a few wavefronts rather than one per word.
template <int NB>
__device__ __forceinline__ void lut_dots(const uint32_t* __restrict__ row,
                                         int nwords, bool vec,
                                         const float* __restrict__ tab,
                                         float (&dot)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) dot[b] = 0.f;
  for (int k0 = 0; k0 < nwords; k0 += 4) {
    uint32_t ws[4];
    if (vec) {                               // uniform across the warp
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k0));
      ws[0] = v.x; ws[1] = v.y; ws[2] = v.z; ws[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ws[j] = k0 + j < nwords ? __ldg(row + k0 + j) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + j >= nwords) break;           // uniform across the warp
      const uint32_t w = ws[j];
      const float* t = tab + (size_t)(k0 + j) * LUT_PER_WORD * TB * LUT_SIZE;
#pragma unroll
      for (int c = 0; c < LUT_PER_WORD; ++c) {
        const float* tc = t + c * TB * LUT_SIZE + ((w >> (LUT_BITS * c)) & 15u);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          dot[b] = __fadd_rn(dot[b], tc[b * LUT_SIZE]);
      }
    }
  }
}

// acc[b] = sum of exp_sim over rows [lo, hi) for the block's first NB
// queries, in the same bits on every lane of the calling warp.  The
// whole warp must call it with the same lo and hi.
template <int NB>
__device__ __forceinline__ void lut_slot_sum(const uint32_t* __restrict__ db,
                                             int lo, int hi, int W,
                                             int nwords, bool vec,
                                             const float* __restrict__ tab,
                                             float scale, float temperature,
                                             float (&acc)[NB]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int m = lo + lane; m < hi; m += 32) {
    float dot[NB];
    lut_dots<NB>(db + (size_t)m * W, nwords, vec, tab, dot);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      acc[b] = __fadd_rn(acc[b], exp_sim(dot[b], scale, temperature));
  }
  // fixed-shape butterfly: every lane ends with the same total
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] = __fadd_rn(acc[b], __shfl_xor_sync(0xffffffffu, acc[b], off));
  }
}

// The segment-sum kernels' body for NB live queries: warp w of block x
// takes slots x * WARPS + w, then every gridDim.x * WARPS further, and
// lane b writes query b's sum of slot s, rows range(s) = [lo, hi), to
// out[(q0 + b) * S + s].  Which block takes a slot does not change the
// slot's bits.
template <int NB, typename Range>
__device__ inline void lut_slots(const uint32_t* __restrict__ db, int W,
                                 int nwords, bool vec,
                                 const float* __restrict__ tab,
                                 float scale, float temperature, int S,
                                 Range range, int q0,
                                 float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  for (int s = blockIdx.x * WARPS + threadIdx.x / 32; s < S;
       s += gridDim.x * WARPS) {
    int lo, hi;
    range(s, lo, hi);
    float acc[NB];
    lut_slot_sum<NB>(db, lo, hi, W, nwords, vec, tab, scale, temperature,
                     acc);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (lane == b) out[(size_t)(q0 + b) * S + s] = acc[b];
  }
}

// project_tile's projection, the same bits (fmaf over d ascending for
// each (bit, query)), with the planes' rows and the query tile read 16
// bytes at a time where dim and the planes' address allow: a warp's 32
// plane rows are 32 cache lines per load, so 4 floats a load cut the
// block's set-up about 4x.
__device__ inline void lut_project(const float* __restrict__ q,
                                   const float* __restrict__ planes,
                                   int B, int dim, int bits, int q0,
                                   float* proj_t, float* q_s) {
  if ((dim & 3) != 0 || (reinterpret_cast<uintptr_t>(planes) & 15) != 0) {
    project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
    return;
  }
  const int nb = min(TB, B - q0);
  for (int i = threadIdx.x; i < TB * dim; i += blockDim.x) {
    const int b = i / dim;
    q_s[i] = (b < nb) ? q[(size_t)(q0 + b) * dim + (i - b * dim)] : 0.f;
  }
  __syncthreads();
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const int d4 = dim / 4;
  for (int j = threadIdx.x; j < bits; j += blockDim.x) {
    float acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0.f;
    const float4* row = reinterpret_cast<const float4*>(planes + (size_t)j * dim);
    for (int d = 0; d < d4; ++d) {
      const float4 p = __ldg(row + d);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const float4 x = q4[b * d4 + d];
        acc[b] = fmaf(x.x, p.x, acc[b]);
        acc[b] = fmaf(x.y, p.y, acc[b]);
        acc[b] = fmaf(x.z, p.z, acc[b]);
        acc[b] = fmaf(x.w, p.w, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) proj_t[j * TB + b] = acc[b];
  }
  __syncthreads();
}

// The block's projection and tables, then lut_slots for its nb live
// queries.  smem holds lut_smem_bytes(bits, dim).
template <typename Range>
__device__ inline void lut_segsum_block(const float* __restrict__ q,
                                        const float* __restrict__ planes,
                                        const uint32_t* __restrict__ db,
                                        int B, int dim, int bits, int W,
                                        int S, float scale,
                                        float temperature, Range range,
                                        float* __restrict__ out,
                                        float* smem) {
  float* proj_t = smem;
  float* q_s = proj_t + (size_t)bits * TB;
  float* tab = q_s + (size_t)TB * dim;
  const int q0 = blockIdx.y * TB;
  lut_project(q, planes, B, dim, bits, q0, proj_t, q_s);
  build_tables(proj_t, bits, tab);
  const int nwords = bits / 32;
  const bool vec = (W & 3) == 0 && (nwords & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  switch (min(TB, B - q0)) {                 // uniform across the block
#define LUT_CASE(N)                                                       \
  case N:                                                                 \
    lut_slots<N>(db, W, nwords, vec, tab, scale, temperature, S, range,   \
                 q0, out);                                                \
    break;
    LUT_CASE(1) LUT_CASE(2) LUT_CASE(3) LUT_CASE(4)
    LUT_CASE(5) LUT_CASE(6) LUT_CASE(7) LUT_CASE(8)
#undef LUT_CASE
    default:
      break;
  }
}

constexpr int WARP_K = 32;                  // the most K warp_topk keeps
constexpr int NO_ROW = 0x7fffffff;          // an empty rank's row
constexpr unsigned ALL_LANES = 0xffffffffu;

// (va, ia) ranks before (vb, ib): value descending, ties by ascending row
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb,
                                             int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Bitonic sort of one (value, row) pair per lane across the warp, value
// descending, ties by ascending row: lane r ends with rank r.  15
// compare-exchange stages of two shuffles each, no shared memory.
__device__ __forceinline__ void warp_sort_desc(float& v, int& i) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(ALL_LANES, v, stride);
      const int oi = __shfl_xor_sync(ALL_LANES, i, stride);
      // a descending run's lower lane keeps the pair that ranks first
      const bool desc = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      if (ranks_before(ov, oi, v, i) == (lower == desc)) {
        v = ov;
        i = oi;
      }
    }
  }
}

// One warp's top-K (K <= WARP_K) of the tile of rows [first, first +
// tm) for the block's TB queries: on return lane r < K holds rank r,
// (tv[b], ti[b]) for query b.  The whole warp must call it with the
// same arguments.  Rows that are not valid(row) are neither read nor
// scored; a 32-row chunk with no valid row costs one ballot.  Lane l
// scores row c + l of chunk c.  The first chunk that holds a valid row
// is sorted across the warp (warp_sort_desc), which fills the ranks.
// In each later chunk one ballot per query marks the rows that beat
// the running K-th, and each of those, lowest lane first, is
// broadcast, ranked against the list by one more ballot and shifted
// in: about K * (1/1 + ... + 1/(chunks - 1)) insertions per query for
// rows in random order, whatever tm is, and none where a tile's valid
// rows fit in one chunk.  Where fewer than K rows are valid, the
// remaining ranks take the lowest masked rows in ascending order at
// -inf.
template <typename Valid>
__device__ inline void warp_topk(const uint32_t* __restrict__ db, int W,
                                 int nwords,
                                 const float4* __restrict__ proj4,
                                 float scale, float temperature, int first,
                                 int tm, int K, Valid valid,
                                 float (&tv)[TB], int (&ti)[TB]) {
  const int lane = threadIdx.x % 32;
  const unsigned ranked = K >= 32 ? ALL_LANES : (1u << K) - 1u;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    tv[b] = -CUDART_INF_F;
    ti[b] = NO_ROW;
  }
  int n_real = 0;                            // valid rows seen
  for (int c = 0; c < tm; c += 32) {
    const int row = first + c + lane;
    const bool real = c + lane < tm && valid(row);
    const unsigned real_mask = __ballot_sync(ALL_LANES, real);
    if (real_mask == 0u) continue;           // uniform across the warp
    const bool first_chunk = n_real == 0;
    n_real += __popc(real_mask);
    float cv[TB];
    if (real) {
      float dot[TB];
      doc_dots(db + (size_t)row * W, nwords, proj4, dot);
#pragma unroll
      for (int b = 0; b < TB; ++b) cv[b] = exp_sim(dot[b], scale, temperature);
    } else {
#pragma unroll
      for (int b = 0; b < TB; ++b) cv[b] = -CUDART_INF_F;
    }
    if (first_chunk) {                       // uniform across the warp
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        tv[b] = cv[b];
        ti[b] = real ? row : NO_ROW;
        warp_sort_desc(tv[b], ti[b]);
      }
      continue;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float kth_v = __shfl_sync(ALL_LANES, tv[b], K - 1);
      const int kth_i = __shfl_sync(ALL_LANES, ti[b], K - 1);
      unsigned todo = __ballot_sync(
          ALL_LANES, real && ranks_before(cv[b], row, kth_v, kth_i));
      while (todo != 0u) {                   // uniform across the warp
        const int src = __ffs(todo) - 1;
        todo &= todo - 1u;
        const float v = __shfl_sync(ALL_LANES, cv[b], src);
        const int i = __shfl_sync(ALL_LANES, row, src);
        const int p = __popc(
            __ballot_sync(ALL_LANES, ranks_before(tv[b], ti[b], v, i)) & ranked);
        const float up_v = __shfl_up_sync(ALL_LANES, tv[b], 1);
        const int up_i = __shfl_up_sync(ALL_LANES, ti[b], 1);
        if (p < K) {                         // enters at rank p
          if (lane == p) {
            tv[b] = v;
            ti[b] = i;
          } else if (lane > p) {
            tv[b] = up_v;
            ti[b] = up_i;
          }
        }
      }
    }
  }
  if (n_real < K) {                          // uniform across the warp
    int filled = n_real;
    for (int c = 0; c < tm && filled < K; c += 32) {
      unsigned masked =
          __ballot_sync(ALL_LANES, c + lane < tm && !valid(first + c + lane));
      while (masked != 0u && filled < K) {
        const int p = __ffs(masked) - 1;
        masked &= masked - 1u;
        if (lane == filled) {
#pragma unroll
          for (int b = 0; b < TB; ++b) {
            tv[b] = -CUDART_INF_F;
            ti[b] = first + c + p;
          }
        }
        ++filled;
      }
    }
  }
}

// Lane r < K of the calling warp writes rank r of each of the block's
// nb queries: out[(q0 + b) * row_len + col0 + r].
__device__ __forceinline__ void write_ranks(float* __restrict__ vals_out,
                                            int* __restrict__ idx_out,
                                            int q0, int nb, size_t row_len,
                                            size_t col0, int K,
                                            const float (&tv)[TB],
                                            const int (&ti)[TB]) {
  const int lane = threadIdx.x % 32;
  if (lane >= K) return;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (b < nb) {
      const size_t o = (size_t)(q0 + b) * row_len + col0 + lane;
      vals_out[o] = tv[b];
      idx_out[o] = ti[b];
    }
  }
}

// 1 + the offset of the last valid row of [first, first + tm) (0 when
// none is), the same on every thread of the block; warp_max holds
// WARPS ints of shared memory.
template <typename Valid>
__device__ inline int tile_extent(int first, int tm, Valid valid,
                                  int* warp_max) {
  int last = 0;
  for (int r = threadIdx.x; r < tm; r += blockDim.x)
    if (valid(first + r)) last = r + 1;
  last = __reduce_max_sync(ALL_LANES, last);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = last;
  __syncthreads();
  int ext = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) ext = max(ext, warp_max[w]);
  __syncthreads();                           // the next tile rewrites it
  return ext;
}

// Rows the sort selection orders: the next power of two at least K and
// at least the tile's extent (so every valid row, and the lowest masked
// rows, are in it).
__device__ __forceinline__ int sort_width(int extent, int K) {
  const int need = max(extent, K);
  int n = 1;
  while (n < need) n <<= 1;
  return n;
}

// vals[b * tm + r] = exp_sim of row first + r for query b where
// valid(row), -inf elsewhere (the row is then never read);
// idx[b * tm + r] = first + r.
template <typename Valid>
__device__ inline void score_tile(const uint32_t* __restrict__ db, int W,
                                  int nwords,
                                  const float4* __restrict__ proj4,
                                  float scale, float temperature,
                                  int first, int tm, Valid valid,
                                  float* vals, int* idx) {
  for (int r = threadIdx.x; r < tm; r += blockDim.x) {
    const int row = first + r;
    if (valid(row)) {
      float dot[TB];
      doc_dots(db + (size_t)row * W, nwords, proj4, dot);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        vals[b * tm + r] = exp_sim(dot[b], scale, temperature);
    } else {
#pragma unroll
      for (int b = 0; b < TB; ++b) vals[b * tm + r] = -CUDART_INF_F;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) idx[b * tm + r] = row;
  }
}

// Bitonic sort of each of `rows` rows of n (a power of two) pairs in
// shared memory, descending by value, ties by ascending index.  Each
// stage is rows * n / 2 compare-exchanges spread over the block, with
// a barrier between stages; the caller's writes before the call and
// its reads after it are fenced by the barriers at both ends.
__device__ inline void bitonic_sort_desc(float* v, int* ix, int rows,
                                         int n) {
  const int half = n / 2;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
        const int r = t / half;
        const int p = t - r * half;
        const int i = 2 * p - (p & (stride - 1));   // bit `stride` clear
        const int j = i + stride;
        float* vr = v + (size_t)r * n;
        int* xr = ix + (size_t)r * n;
        const float vi = vr[i], vj = vr[j];
        const int ii = xr[i], ij = xr[j];
        const bool i_first = vi > vj || (vi == vj && ii < ij);
        const bool desc = (i & size) == 0;
        if (i_first != desc) {
          vr[i] = vj; vr[j] = vi;
          xr[i] = ij; xr[j] = ii;
        }
      }
    }
  }
  __syncthreads();
}

// Dynamic shared memory of a block: the projection [bits][TB], the
// query tile [TB][dim] and, for the top-k kernels' sort selection,
// [TB][tm] values and indices.
inline size_t smem_bytes(int bits, int dim, int tm) {
  return ((size_t)bits * TB + (size_t)TB * dim) * sizeof(float) +
         (size_t)TB * tm * (sizeof(float) + sizeof(int));
}

// ... of a top-k block: the warp selection (K <= WARP_K) keeps its
// ranks in registers; the sort selection adds the [TB][tm] tile and
// WARPS ints for tile_extent.
inline size_t topk_smem_bytes(int bits, int dim, int tm, int K) {
  if (K <= WARP_K) return smem_bytes(bits, dim, 0);
  return smem_bytes(bits, dim, tm) + WARPS * sizeof(int);
}

// ... of a segment-sum block: the projection, the query tile and the
// tables, [bits/4][TB][16] floats.
inline size_t lut_smem_bytes(int bits, int dim) {
  return smem_bytes(bits, dim, 0) +
         (size_t)bits / LUT_BITS * TB * LUT_SIZE * sizeof(float);
}

// The most dynamic shared memory one block may ask for on this device.
inline int smem_limit() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// Blocks along x of a segment-sum launch over S slots and n_qtiles
// query tiles: one wave, as many blocks as fit on the card at once
// (spread over the query tiles), and no more than the slots need.
// Call after prepare.
template <typename K>
int lut_grid_x(K kernel, size_t smem, int S, int n_qtiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                smem);
  const int wave = (sms * (per_sm > 0 ? per_sm : 1) + n_qtiles - 1) /
                   n_qtiles;
  const int need = (S + WARPS - 1) / WARPS;
  return wave < need ? wave : need;
}

}  // namespace asym_tile
