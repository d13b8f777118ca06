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
//     padded to 256 rows): the sum kernels never read it — they walk
//     only a slot's real rows [row_start, row_start + count) and sum
//     them in the order of the per-slot sum of the segment-sum kernel
//     of the same mode (asym_tile::lut_slot_sum,
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
//     memory and serves TOPK_PER_WARP payload blocks per warp;
//   * the sym sum: a block stages HQ = 16 query signatures (B <= 16 is
//     one tile, so each row word is loaded once, as one of two 16-byte
//     loads at W = 8, and XORed with the live queries only) and the
//     value table; one wave of blocks, each warp a contiguous run of
//     slots, one slot at a time through hamming_tile::slot_sum.
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

// The Hamming sum (row 8).  A block holds one tile of HQ query
// signatures, so B <= 16 is one tile: each row word is loaded once and
// XORed with the live queries only (a template on their count, NB).
// Warp g of the G warps of a query tile owns the slots [S g / G,
// S (g + 1) / G) and sums them one after another with slot_sum.
namespace ht = hamming_tile;

constexpr int HQ = 16;                      // query signatures per block

template <int NB>
__device__ inline void ham_slots(const uint32_t* __restrict__ sig,
                                 const int* __restrict__ row_start,
                                 const int* __restrict__ row_count,
                                 int n_rows, int W, bool vec,
                                 const uint4* __restrict__ q4,
                                 const float* __restrict__ tab, int s_lo,
                                 int s_hi, int S, int q0,
                                 float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  for (int s = s_lo; s < s_hi; ++s) {
    const int lo = max(0, row_start[s]);
    const int hi = (int)min((long long)n_rows,
                            (long long)row_start[s] + row_count[s]);
    float acc[NB];
    ht::slot_sum<HQ, NB>(sig, lo, hi, W, vec, q4, tab, acc);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (lane == b) out[(size_t)(q0 + b) * S + s] = acc[b];
  }
}

__global__ void __launch_bounds__(ht::THREADS)
hamming_megascan_segsum_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ sig,
                               const int* __restrict__ row_start,
                               const int* __restrict__ row_count,
                               const float* __restrict__ table,
                               float* __restrict__ out, int B, int n_rows,
                               int W, int S) {
  extern __shared__ uint4 hsmem4[];
  uint32_t* q_t = reinterpret_cast<uint32_t*>(hsmem4);
  float* tab = reinterpret_cast<float*>(q_t + (size_t)HQ * W);
  const int q0 = blockIdx.y * HQ;
  ht::stage<HQ>(q, table, B, W, q0, q_t, tab);
  const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(sig) & 15) == 0;
  const long long g = (long long)blockIdx.x * ht::WARPS + threadIdx.x / 32;
  const long long G = (long long)gridDim.x * ht::WARPS;
  const int s_lo = (int)(S * g / G), s_hi = (int)(S * (g + 1) / G);
  switch (min(HQ, B - q0)) {                 // uniform across the block
#define HAM_CASE(N)                                                      \
  case N:                                                                \
    ham_slots<N>(sig, row_start, row_count, n_rows, W, vec, hsmem4, tab, \
                 s_lo, s_hi, S, q0, out);                                \
    break;
    HAM_CASE(1) HAM_CASE(2) HAM_CASE(3) HAM_CASE(4)
    HAM_CASE(5) HAM_CASE(6) HAM_CASE(7) HAM_CASE(8)
    HAM_CASE(9) HAM_CASE(10) HAM_CASE(11) HAM_CASE(12)
    HAM_CASE(13) HAM_CASE(14) HAM_CASE(15) HAM_CASE(16)
#undef HAM_CASE
    default:
      break;
  }
}

// Blocks along x of a Hamming-sum launch: one wave over the query
// tiles, at most one block per WARPS slots.  Call after prepare.
int ham_grid_x(size_t smem, int S, int n_qtiles) {
  const int wave = wave_blocks(hamming_megascan_segsum_kernel, ht::THREADS,
                               smem, n_qtiles);
  const int need = (S + ht::WARPS - 1) / ht::WARPS;
  return wave < need ? wave : need;
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

// Shared memory of one Hamming-sum block at W words, and its blocks
// along x over S slots for B queries (the grid is that by ceil(B / 16));
// a negative CUDA error if the kernel cannot take the shared memory.
size_t hamming_megascan_smem(int W) { return ht::smem_bytes(W, HQ); }
int hamming_megascan_query_tile() { return HQ; }
int hamming_megascan_grid_x(int W, int S, int B) {
  const size_t smem = ht::smem_bytes(W, HQ);
  cudaError_t err = prepare(hamming_megascan_segsum_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  return ham_grid_x(smem, S, (B + HQ - 1) / HQ);
}

int hamming_megascan_segsum_launch(const uint32_t* q, const uint32_t* sig,
                                   const int* row_start, const int* row_count,
                                   const float* table, float* out, int B,
                                   int n_rows, int W, int S, void* stream) {
  cudaGetLastError();
  const size_t smem = ht::smem_bytes(W, HQ);
  cudaError_t err = prepare(hamming_megascan_segsum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (B + HQ - 1) / HQ;
  const dim3 grid(ham_grid_x(smem, S, n_qtiles), n_qtiles);
  hamming_megascan_segsum_kernel<<<grid, ht::THREADS, smem,
                                   (cudaStream_t)stream>>>(
      q, sig, row_start, row_count, table, out, B, n_rows, W, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
