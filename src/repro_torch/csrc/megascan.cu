// One-launch megascan kernels for Hopper (sm_90a): the scan of a host's
// whole shard group over the block-aligned packed payload
// (repro_torch/kernels/megascan/ops.py::build_payload: every shard's
// rows padded to TM-row blocks and concatenated, padding rows carry an
// out-of-range slot).
//
// Replaces four Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/megascan/kernel.py,
//     asym_megascan_segsum_db_kernel (bodies _asym_segsum_db_body,
//     _segsum_block): per-(query, shard-slot) sums of
//     exp(beta * asym-cos) over the payload in one launch, [B, S];
//   * src/repro/kernels/megascan/kernel.py,
//     hamming_megascan_segsum_db_kernel (body _hamming_segsum_db_body,
//     tile _hamming_tile): the same sums in sym mode, of
//     exp(beta * cos(pi * m / bits)) with m the Hamming distance of
//     packed query and row signatures, [B, S];
//   * src/repro/kernels/megascan/kernel.py, asym_megascan_topk_kernel
//     (bodies _asym_topk_stream_body, _topk_block, bitonic_sort_desc)
//     and asym_megascan_topk_db_kernel (body _asym_topk_db_body): per
//     TM block, each query's K best (value, payload position), value
//     descending then position ascending, padding rows -inf.  The two
//     TPU kernels differ only in their data-movement schedule and
//     give the same candidates; this one kernel ports both.
//
// What bounds them on the card: in asym mode, the sum scores by table
// lookup (bits/4 shared loads and fp32 adds per query and real row, one
// per 4-bit chunk of the signature), bound by the shared-memory pipe;
// the top-k, as asym.cu's, by the fp32 sign product (2 * bits
// operations per query and real row) and its selection: for K <= 32 a
// 15-stage sort across the warp of the first 32-row chunk that holds a
// real row, then one ballot per (query, later such chunk) and one
// insertion per later real row that beats the running K-th (none at
// serving scale, where a block holds ≈ 26 real rows); for K > 32 a
// bitonic sort of the next power of two above K and the block's last
// real row.  In sym mode, as for hamming.cu, the bits/32 popcounts per
// query and real row, issued at 16 per clock per SM.  Bytes are the
// real rows' signatures, bits/8 per row, read once per query tile.
//
// What the design does about it:
//   * padding is most of the payload at real scale (shards of ~26 docs
//     padded to 256 rows): the sum kernels never read it — a warp owns
//     one slot at a time and walks only its real rows [row_start,
//     row_start + count), with the per-slot sum of the segment-sum
//     kernel of the same mode (asym_tile::lut_slot_sum,
//     hamming_tile::slot_sum).  So a slot's sum depends only on its own
//     rows in a fixed order, and three properties hold by construction,
//     bit for bit: group launch == per-shard launch, this kernel == the
//     segment sum over the same slot map (the streamed schedule), and
//     run to run.  Empty slots give exact zeros;
//   * the asym sum shares asym.cu's segment-sum block
//     (asym_tile::lut_segsum_block): the projection and the 4-bit
//     lookup tables built once per block, one wave of blocks whose
//     warps walk the slots in a fixed stride, and a query tile's
//     scoring templated on its live queries (at B = 12 the second tile
//     scores 4 queries, not 8);
//   * the top-k kernel reads a row's signature only where its slot is
//     real.  For K <= 32 (the served k = 10) a warp owns a payload
//     block: lane l tests rows l, l+32, ... against the slot map, a
//     32-row chunk with no real row costs one ballot, and the real
//     rows' values go straight into each query's running top-K in
//     registers (asym_tile::warp_topk: the first such chunk sorted
//     across the warp, later real rows inserted), so the padding rows
//     are never scored, stored or sorted.  For K > 32 the block sorts in shared
//     memory only the rows up to the block's last real row (rounded up
//     to a power of two at least K), masked rows at -inf;
//   * a top-k block stages its TB-query projection once into shared
//     memory and serves TOPK_PER_WARP payload blocks per warp; a sym
//     sum block stages its TB query signatures and value table and
//     serves SLOTS_PER_WARP slots per warp.
// The TPU's 2-slot DMA ring is a data-movement schedule; this port
// reads signatures straight from device memory (no cp.async/TMA
// pipeline).
//
// The entry points take plain pointers and return cudaGetLastError()
// right after the launch.

#include "asym_tile.cuh"
#include "hamming_tile.cuh"

namespace {

using namespace asym_tile;

constexpr int SLOTS_PER_WARP = 4;           // slots per warp, Hamming sum
constexpr int TOPK_PER_WARP = 4;            // payload blocks per warp, top-k
constexpr int TOPK_BLOCKS = WARPS * TOPK_PER_WARP;

__global__ void __launch_bounds__(THREADS)
megascan_segsum_kernel(const float* __restrict__ q,
                       const float* __restrict__ planes,
                       const uint32_t* __restrict__ sig,
                       const int* __restrict__ row_start,
                       const int* __restrict__ row_count,
                       float* __restrict__ out, int B, int dim, int bits,
                       int n_rows, int W, int S, float scale,
                       float temperature) {
  extern __shared__ float4 smem4[];
  lut_segsum_block(
      q, planes, sig, B, dim, bits, W, S, scale, temperature,
      [row_start, row_count, n_rows](int s, int& lo, int& hi) {
        lo = max(0, row_start[s]);
        hi = (int)min((long long)n_rows,
                      (long long)row_start[s] + row_count[s]);
      },
      out, reinterpret_cast<float*>(smem4));
}

// Top-k, K <= WARP_K: warp w selects payload blocks blockIdx.x *
// TOPK_BLOCKS + w * TOPK_PER_WARP + i, i < TOPK_PER_WARP, in registers.
__global__ void __launch_bounds__(THREADS)
megascan_topk_warp_kernel(const float* __restrict__ q,
                          const float* __restrict__ planes,
                          const uint32_t* __restrict__ sig,
                          const int* __restrict__ slots,
                          float* __restrict__ vals_out,
                          int* __restrict__ pos_out, int B, int dim,
                          int bits, int W, int n_blocks, int tm, int K,
                          int n_valid, float scale, float temperature) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  const int q0 = blockIdx.y * TB;
  project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
  const int nb = min(TB, B - q0);
  const size_t row_len = (size_t)n_blocks * K;
  const int j_first = blockIdx.x * TOPK_BLOCKS
                      + threadIdx.x / 32 * TOPK_PER_WARP;
  for (int i = 0; i < TOPK_PER_WARP; ++i) {
    const int j = j_first + i;
    if (j >= n_blocks) break;                // uniform across the warp
    float tv[TB];
    int ti[TB];
    warp_topk(sig, W, bits / 32, smem4, scale, temperature, j * tm, tm, K,
              [slots, n_valid](int row) { return __ldg(slots + row) < n_valid; },
              tv, ti);
    write_ranks(vals_out, pos_out, q0, nb, row_len, (size_t)j * K, K, tv,
                ti);
  }
}

// Top-k, K > WARP_K: the block takes TOPK_BLOCKS payload blocks in turn
// and sorts each one's first sort_width(extent, K) rows in shared
// memory.
__global__ void __launch_bounds__(THREADS)
megascan_topk_sort_kernel(const float* __restrict__ q,
                          const float* __restrict__ planes,
                          const uint32_t* __restrict__ sig,
                          const int* __restrict__ slots,
                          float* __restrict__ vals_out,
                          int* __restrict__ pos_out, int B, int dim,
                          int bits, int W, int n_blocks, int tm, int K,
                          int n_valid, float scale, float temperature) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  float* vals = q_s + (size_t)TB * dim;
  int* idx = reinterpret_cast<int*>(vals + (size_t)TB * tm);
  int* warp_max = idx + (size_t)TB * tm;
  const int q0 = blockIdx.y * TB;
  project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
  const int nb = min(TB, B - q0);
  const int nwords = bits / 32;
  const size_t row_len = (size_t)n_blocks * K;
  const auto real = [slots, n_valid](int row) {
    return __ldg(slots + row) < n_valid;
  };
  for (int t = 0; t < TOPK_BLOCKS; ++t) {
    const int j = blockIdx.x * TOPK_BLOCKS + t;
    if (j >= n_blocks) break;                // uniform across the block
    const int first = j * tm;
    const int n = sort_width(tile_extent(first, tm, real, warp_max), K);
    score_tile(sig, W, nwords, smem4, scale, temperature, first, n, real,
               vals, idx);
    bitonic_sort_desc(vals, idx, TB, n);
    for (int e = threadIdx.x; e < TB * K; e += blockDim.x) {
      const int b = e / K;
      const int r = e - b * K;
      if (b < nb) {
        const size_t o = (size_t)(q0 + b) * row_len + (size_t)j * K + r;
        vals_out[o] = vals[b * n + r];
        pos_out[o] = idx[b * n + r];
      }
    }
    __syncthreads();                         // the next block reuses vals
  }
}

__global__ void __launch_bounds__(hamming_tile::THREADS)
hamming_megascan_segsum_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ sig,
                               const int* __restrict__ row_start,
                               const int* __restrict__ row_count,
                               const float* __restrict__ table,
                               float* __restrict__ out, int B, int n_rows,
                               int W, int S) {
  namespace ht = hamming_tile;
  extern __shared__ uint4 hsmem4[];
  uint32_t* q_t = reinterpret_cast<uint32_t*>(hsmem4);
  float* tab = reinterpret_cast<float*>(q_t + (size_t)ht::TB * W);
  const int q0 = blockIdx.y * ht::TB;
  ht::stage(q, table, B, W, q0, q_t, tab);
  const int nb = min(ht::TB, B - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s_first = blockIdx.x * (ht::WARPS * SLOTS_PER_WARP)
                      + warp * SLOTS_PER_WARP;
  for (int i = 0; i < SLOTS_PER_WARP; ++i) {
    const int s = s_first + i;
    if (s >= S) break;                       // uniform across the warp
    const int lo = max(0, row_start[s]);
    const int hi = (int)min((long long)n_rows,
                            (long long)row_start[s] + row_count[s]);
    float acc[ht::TB];
    ht::slot_sum(sig, lo, hi, W, hsmem4, tab, acc);
#pragma unroll
    for (int b = 0; b < ht::TB; ++b)
      if (lane == b && b < nb) out[(size_t)(q0 + b) * S + s] = acc[b];
  }
}

}  // namespace

extern "C" {

// Blocks along x of a sum launch over S slots for B queries (the grid
// is that by ceil(B / TB)); a negative CUDA error if the kernel cannot
// take the shared memory (asym_tile.cuh's lut_smem_bytes).
int megascan_segsum_grid_x(int bits, int dim, int S, int B) {
  const size_t smem = lut_smem_bytes(bits, dim);
  cudaError_t err = prepare(megascan_segsum_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  return lut_grid_x(megascan_segsum_kernel, smem, S, (B + TB - 1) / TB);
}

int megascan_segsum_launch(const float* q, const float* planes,
                           const uint32_t* sig, const int* row_start,
                           const int* row_count, float* out, int B, int dim,
                           int bits, int n_rows, int W, int S, float scale,
                           float temperature, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const size_t smem = lut_smem_bytes(bits, dim);
  cudaError_t err = prepare(megascan_segsum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(
      lut_grid_x(megascan_segsum_kernel, smem, S, (B + TB - 1) / TB),
      (B + TB - 1) / TB);
  megascan_segsum_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, sig, row_start, row_count, out, B, dim, bits, n_rows, W, S,
      scale, temperature);
  return (int)cudaGetLastError();
}

int megascan_topk_launch(const float* q, const float* planes,
                         const uint32_t* sig, const int* slots, float* vals,
                         int* pos, int B, int dim, int bits, int n_rows,
                         int W, int tm, int K, int n_valid, float scale,
                         float temperature, void* stream) {
  cudaGetLastError();
  const auto kernel = K <= WARP_K ? megascan_topk_warp_kernel
                                  : megascan_topk_sort_kernel;
  const size_t smem = topk_smem_bytes(bits, dim, tm, K);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = n_rows / tm;
  const dim3 grid((n_blocks + TOPK_BLOCKS - 1) / TOPK_BLOCKS,
                  (B + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, sig, slots, vals, pos, B, dim, bits, W, n_blocks, tm, K,
      n_valid, scale, temperature);
  return (int)cudaGetLastError();
}

int hamming_megascan_segsum_launch(const uint32_t* q, const uint32_t* sig,
                                   const int* row_start, const int* row_count,
                                   const float* table, float* out, int B,
                                   int n_rows, int W, int S, void* stream) {
  cudaGetLastError();
  const size_t smem = hamming_tile::smem_bytes(W);
  const int per_block = hamming_tile::WARPS * SLOTS_PER_WARP;
  const dim3 grid((S + per_block - 1) / per_block,
                  (B + hamming_tile::TB - 1) / hamming_tile::TB);
  hamming_megascan_segsum_kernel<<<grid, hamming_tile::THREADS, smem,
                                   (cudaStream_t)stream>>>(
      q, sig, row_start, row_count, table, out, B, n_rows, W, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
