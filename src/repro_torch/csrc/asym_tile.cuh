// Device code shared by asym.cu and megascan.cu (Hopper, sm_90a).
//
//   * project_tile: a block's TB-query projection q . planes^T, once,
//     into shared memory, transposed to [bits][TB];
//   * doc_dots / exp_sim: one row's +-1 dot products with the TB
//     projections, bit 0 first, and exp(beta * clip(dot * scale));
//   * slot_sum: one warp's sum of exp_sim over a contiguous row range
//     [lo, hi) — lane l takes rows lo+l, lo+l+32, ... in that order,
//     then a fixed xor-butterfly adds the 32 partials, so every lane
//     ends with the same totals and a slot's sum depends only on its
//     own rows, taken in a fixed order (no float atomics);
//   * score_tile / bitonic_sort_desc: the top-k kernels' tile of TM
//     rows scored into shared memory (masked rows -inf), then ordered
//     by value descending, ties by ascending position — the order of
//     jax.lax.top_k and of the JAX package's bitonic_sort_desc.
//
// The sum adds with __fadd_rn, which the compiler never contracts
// into an FMA, so every kernel that inlines slot_sum rounds each add
// the same way: the slice-1 segment sum over a slot map and the
// megascan over the block-aligned payload give the same bits.
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

// acc[b] = sum of exp_sim over rows [lo, hi) for the block's TB
// queries, in the same bits on every lane of the calling warp.  The
// whole warp must call it with the same lo and hi.
__device__ __forceinline__ void slot_sum(const uint32_t* __restrict__ db,
                                         int lo, int hi, int W, int nwords,
                                         const float4* __restrict__ proj4,
                                         float scale, float temperature,
                                         float (&acc)[TB]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.f;
  for (int m = lo + lane; m < hi; m += 32) {
    float dot[TB];
    doc_dots(db + (size_t)m * W, nwords, proj4, dot);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      acc[b] = __fadd_rn(acc[b], exp_sim(dot[b], scale, temperature));
  }
  // fixed-shape butterfly: every lane ends with the same total
#pragma unroll
  for (int b = 0; b < TB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] = __fadd_rn(acc[b], __shfl_xor_sync(0xffffffffu, acc[b], off));
  }
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
// query tile [TB][dim] and, for the top-k kernels, [TB][tm] values
// and indices.
inline size_t smem_bytes(int bits, int dim, int tm) {
  return ((size_t)bits * TB + (size_t)TB * dim) * sizeof(float) +
         (size_t)TB * tm * (sizeof(float) + sizeof(int));
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

}  // namespace asym_tile
