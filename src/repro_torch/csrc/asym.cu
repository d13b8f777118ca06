// Asymmetric-LSH exp-similarity kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/asym/kernel.py, asym_similarity_kernel
//     (body _asym_sim_kernel via _exp_sim_tile): the full [B, M] matrix
//         out[b, m] = exp(beta * clip(proj[b] . sign(db[m]) * scale, -1, 1))
//     with proj = q . planes^T and scale = 1 / (bits * sqrt(2/pi));
//   * src/repro/kernels/asym/kernel.py, asym_segment_sum_kernel
//     (body _asym_segsum_kernel): the same values summed per segment slot,
//         out[b, s] = sum over docs m of segment s of the value above,
//     without the [B, M] intermediate ever reaching device memory.
//
// What bounds them on the card: the sign product.  Per (query, doc) it
// is `bits` multiply-adds in fp32 (2*B*M*bits operations), against
// bits/8 bytes of packed signature per doc, so at the serving shapes
// (B in the tens, bits = 256) the kernels sit far above the fp32 ridge
// and are bound by operations, not bytes.  The parity path stays in
// fp32 (no TF32/bf16 tensor cores), so the bound is the card's fp32
// rate outside the tensor cores.
//
// What the design does about it:
//   * one block holds a tile of TB queries; it computes their
//     projection q . planes^T once, into shared memory, transposed to
//     [bits][TB] so one signature bit's TB projections are two float4
//     loads that every lane of a warp reads at the same address
//     (a broadcast, no bank conflicts);
//   * each lane owns one doc at a time, unpacks its W words to +-1 in
//     registers and keeps TB running dot products, so every shared
//     load feeds four multiply-adds and the packed signature is read
//     once per query tile;
//   * a block amortises its projection over many docs (SIM_DOCS per
//     thread in the similarity kernel, SEGS_PER_WARP segments per warp
//     in the segment sum).
//
// Determinism of the segment sum: no float atomics.  Rows arrive
// sorted by segment with CSR offsets (the wrapper builds them; the
// index caches them).  One warp owns a segment: lane l sums docs
// lo+l, lo+l+32, ... in that order, then a fixed xor-butterfly of
// warp shuffles adds the 32 partials.  The same inputs give the same
// bits on every run.  Empty segments give exact zeros.
//
// The entry points take plain pointers and return cudaGetLastError()
// right after the launch, so the Python wrapper can raise on a launch
// that never ran.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;                       // queries per block
constexpr int THREADS = 256;                // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int SIM_DOCS = 4;                 // docs per thread, similarity
constexpr int SEGS_PER_WARP = 4;            // segments per warp, segment sum
constexpr int SEGS_PER_BLOCK = WARPS * SEGS_PER_WARP;

// proj_t[j * TB + b] = q[q0 + b] . planes[j]   (zero for padding rows)
__device__ void project_tile(const float* __restrict__ q,
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

__global__ void __launch_bounds__(THREADS)
asym_sim_kernel(const float* __restrict__ q, const float* __restrict__ planes,
                const uint32_t* __restrict__ db, float* __restrict__ out,
                int B, int dim, int bits, int M, int W, float scale,
                float temperature) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  const int q0 = blockIdx.y * TB;
  project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
  const int nb = min(TB, B - q0);
  const int nwords = bits / 32;
  const size_t m0 = (size_t)blockIdx.x * THREADS * SIM_DOCS;
  for (int r = 0; r < SIM_DOCS; ++r) {
    const size_t m = m0 + (size_t)r * THREADS + threadIdx.x;
    if (m >= (size_t)M) break;
    float dot[TB];
    doc_dots(db + m * W, nwords, smem4, dot);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (b < nb) out[(size_t)(q0 + b) * M + m] = exp_sim(dot[b], scale, temperature);
  }
}

__global__ void __launch_bounds__(THREADS)
asym_segsum_kernel(const float* __restrict__ q,
                   const float* __restrict__ planes,
                   const uint32_t* __restrict__ db,
                   const int* __restrict__ offsets, float* __restrict__ out,
                   int B, int dim, int bits, int M, int W, int S, float scale,
                   float temperature) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  const int q0 = blockIdx.y * TB;
  project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
  const int nb = min(TB, B - q0);
  const int nwords = bits / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s_first = blockIdx.x * SEGS_PER_BLOCK + warp * SEGS_PER_WARP;
  for (int i = 0; i < SEGS_PER_WARP; ++i) {
    const int s = s_first + i;
    if (s >= S) break;                       // uniform across the warp
    const int lo = max(0, offsets[s]);
    const int hi = min(M, offsets[s + 1]);
    float acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0.f;
    for (int m = lo + lane; m < hi; m += 32) {
      float dot[TB];
      doc_dots(db + (size_t)m * W, nwords, smem4, dot);
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[b] += exp_sim(dot[b], scale, temperature);
    }
    // fixed-shape butterfly: every lane ends with the same total
#pragma unroll
    for (int b = 0; b < TB; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    }
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (lane == b && b < nb) out[(size_t)(q0 + b) * S + s] = acc[b];
  }
}

size_t smem_bytes(int bits, int dim) {
  return ((size_t)bits * TB + (size_t)TB * dim) * sizeof(float);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Query tile size of both kernels (the wrappers read it for grid limits).
int asym_query_tile() { return TB; }

int asym_exp_similarity_launch(const float* q, const float* planes,
                               const uint32_t* db, float* out, int B, int dim,
                               int bits, int M, int W, float scale,
                               float temperature, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const size_t smem = smem_bytes(bits, dim);
  cudaError_t err = prepare(asym_sim_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + THREADS * SIM_DOCS - 1) / (THREADS * SIM_DOCS),
                  (B + TB - 1) / TB);
  asym_sim_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, db, out, B, dim, bits, M, W, scale, temperature);
  return (int)cudaGetLastError();
}

int asym_exp_segment_sum_launch(const float* q, const float* planes,
                                const uint32_t* db, const int* offsets,
                                float* out, int B, int dim, int bits, int M,
                                int W, int S, float scale, float temperature,
                                void* stream) {
  cudaGetLastError();
  const size_t smem = smem_bytes(bits, dim);
  cudaError_t err = prepare(asym_segsum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + SEGS_PER_BLOCK - 1) / SEGS_PER_BLOCK,
                  (B + TB - 1) / TB);
  asym_segsum_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, db, offsets, out, B, dim, bits, M, W, S, scale, temperature);
  return (int)cudaGetLastError();
}

}  // extern "C"
