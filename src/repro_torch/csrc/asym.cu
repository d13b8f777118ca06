// Asymmetric-LSH exp-similarity kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/asym/kernel.py, asym_similarity_kernel
//     (body _asym_sim_kernel via _exp_sim_tile): the full [B, M] matrix
//         out[b, m] = exp(beta * clip(proj[b] . sign(db[m]) * scale, -1, 1))
//     with proj = q . planes^T and scale = 1 / (bits * sqrt(2/pi));
//   * src/repro/kernels/asym/kernel.py, asym_segment_sum_kernel
//     (body _asym_segsum_kernel): the same values summed per segment slot,
//         out[b, s] = sum over docs m of segment s of the value above,
//     without the [B, M] intermediate ever reaching device memory;
//   * src/repro/kernels/asym/kernel.py, asym_topk_kernel
//     (body _asym_topk_kernel): per TM-row tile, each query's K best
//     (value, global doc index), columns >= M masked to -inf; the
//     wrapper takes the final top-k over the [B, ceil(M/TM)*K]
//     candidates, so the [B, M] matrix never reaches device memory.
//
// What bounds them on the card: the sign product.  Per (query, doc) it
// is `bits` multiply-adds in fp32 (2*B*M*bits operations), against
// bits/8 bytes of packed signature per doc, so at the serving shapes
// (B in the tens, bits = 256) the kernels sit far above the fp32 ridge
// and are bound by operations, not bytes.  The parity path stays in
// fp32 (no TF32/bf16 tensor cores), so the bound is the card's fp32
// rate outside the tensor cores.  The top-k adds its sort network:
// per tile and query, TM/2 * log2(TM) * (log2(TM) + 1) / 2
// compare-exchanges in shared memory.
//
// What the design does about it (shared device code in asym_tile.cuh):
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
//     in the segment sum, TOPK_TILES tiles in the top-k);
//   * the top-k scores a tile into shared memory and sorts it there
//     with a bitonic network (value descending, ties by ascending doc
//     index, the order of jax.lax.top_k); only K candidates per tile
//     and query are written.
//
// Determinism of the segment sum: no float atomics.  Rows arrive
// sorted by segment with CSR offsets (the wrapper builds them; the
// index caches them).  One warp owns a segment (slot_sum): lane l sums
// docs lo+l, lo+l+32, ... in that order, then a fixed xor-butterfly of
// warp shuffles adds the 32 partials.  The same inputs give the same
// bits on every run.  Empty segments give exact zeros.
//
// The entry points take plain pointers and return cudaGetLastError()
// right after the launch, so the Python wrapper can raise on a launch
// that never ran.

#include "asym_tile.cuh"

namespace {

using namespace asym_tile;

constexpr int SIM_DOCS = 4;                 // docs per thread, similarity
constexpr int SEGS_PER_WARP = 4;            // segments per warp, segment sum
constexpr int SEGS_PER_BLOCK = WARPS * SEGS_PER_WARP;
constexpr int TOPK_TILES = 8;               // tiles per block, top-k

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
    slot_sum(db, lo, hi, W, nwords, smem4, scale, temperature, acc);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (lane == b && b < nb) out[(size_t)(q0 + b) * S + s] = acc[b];
  }
}

__global__ void __launch_bounds__(THREADS)
asym_topk_kernel(const float* __restrict__ q, const float* __restrict__ planes,
                 const uint32_t* __restrict__ db, float* __restrict__ vals_out,
                 int* __restrict__ idx_out, int B, int dim, int bits, int M,
                 int W, int n_tiles, int tm, int K, float scale,
                 float temperature) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  float* vals = q_s + (size_t)TB * dim;
  int* idx = reinterpret_cast<int*>(vals + (size_t)TB * tm);
  const int q0 = blockIdx.y * TB;
  project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
  const int nb = min(TB, B - q0);
  const int nwords = bits / 32;
  const size_t row_len = (size_t)n_tiles * K;
  for (int t = 0; t < TOPK_TILES; ++t) {
    const int tile = blockIdx.x * TOPK_TILES + t;
    if (tile >= n_tiles) break;              // uniform across the block
    score_tile(db, W, nwords, smem4, scale, temperature, tile * tm, tm,
               [M](int row) { return row < M; }, vals, idx);
    bitonic_sort_desc(vals, idx, TB, tm);
    for (int e = threadIdx.x; e < TB * K; e += blockDim.x) {
      const int b = e / K;
      const int r = e - b * K;
      if (b < nb) {
        const size_t o = (size_t)(q0 + b) * row_len + (size_t)tile * K + r;
        vals_out[o] = vals[b * tm + r];
        idx_out[o] = idx[b * tm + r];
      }
    }
    __syncthreads();                         // the next tile reuses vals
  }
}

size_t sim_smem_bytes(int bits, int dim) { return smem_bytes(bits, dim, 0); }

}  // namespace

extern "C" {

// Query tile size of the kernels (the wrappers read it for grid limits).
int asym_query_tile() { return TB; }

// Shared memory of one top-k block at these widths, and the device's
// per-block limit (the wrapper raises past it).
size_t asym_topk_smem(int bits, int dim, int tm) {
  return smem_bytes(bits, dim, tm);
}
int asym_smem_limit() { return smem_limit(); }

int asym_exp_similarity_launch(const float* q, const float* planes,
                               const uint32_t* db, float* out, int B, int dim,
                               int bits, int M, int W, float scale,
                               float temperature, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const size_t smem = sim_smem_bytes(bits, dim);
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
  const size_t smem = sim_smem_bytes(bits, dim);
  cudaError_t err = prepare(asym_segsum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + SEGS_PER_BLOCK - 1) / SEGS_PER_BLOCK,
                  (B + TB - 1) / TB);
  asym_segsum_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, db, offsets, out, B, dim, bits, M, W, S, scale, temperature);
  return (int)cudaGetLastError();
}

int asym_exp_topk_launch(const float* q, const float* planes,
                         const uint32_t* db, float* vals, int* idx, int B,
                         int dim, int bits, int M, int W, int tm, int K,
                         float scale, float temperature, void* stream) {
  cudaGetLastError();
  const size_t smem = smem_bytes(bits, dim, tm);
  cudaError_t err = prepare(asym_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (M + tm - 1) / tm;
  const dim3 grid((n_tiles + TOPK_TILES - 1) / TOPK_TILES,
                  (B + TB - 1) / TB);
  asym_topk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, db, vals, idx, B, dim, bits, M, W, n_tiles, tm, K, scale,
      temperature);
  return (int)cudaGetLastError();
}

}  // extern "C"
