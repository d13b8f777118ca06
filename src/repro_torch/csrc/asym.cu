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
// What bounds them on the card.  The similarity and the top-k score bit
// by bit: per (query, doc) `bits` fp32 multiply-adds (2*B*M*bits
// operations) against bits/8 bytes of packed signature per doc, so at
// the serving shapes (B in the tens, bits = 256) they sit far above
// the fp32 ridge and are bound by operations, not bytes.  The segment
// sum scores by table lookup instead: per (query, doc) bits/4 shared
// loads and fp32 adds, one per 4-bit chunk of the signature, so it is
// bound by the shared-memory pipe (one warp-wide 32-bit load per clock
// per SM) and the fp32 adds beside it.  The parity path stays in fp32
// (no TF32/bf16 tensor cores), so the operation bound is the card's
// fp32 rate outside the tensor cores.  The top-k adds its selection:
// for K <= 32, per (query, tile) a 15-stage sort of the first 32 rows
// across the warp, then one ballot per later 32 rows and an insertion
// for each later row that beats the running K-th (about K * (1/1 + ...
// + 1/7) ≈ 26 at K = 10, TM = 256), all in registers; for K > 32, a
// bitonic sort of the tile in shared memory, TM/2 * log2(TM) *
// (log2(TM) + 1) / 2 compare-exchanges, a barrier a stage.
//
// What the design does about it (shared device code in asym_tile.cuh):
//   * one block holds a tile of TB queries and their projection
//     q . planes^T in shared memory, transposed to [bits][TB] so one
//     signature bit's TB projections are two float4 loads that every
//     lane of a warp reads at the same address (a broadcast, no bank
//     conflicts); the top-k and segment-sum blocks compute it
//     themselves, the similarity's blocks copy it from a set-up kernel
//     that computes each tile's once (asym_sim_project_kernel), so the
//     blocks of a tile do not each repeat it;
//   * the similarity and the top-k: each lane owns a doc at a time,
//     unpacks its W words to +-1 in registers and keeps TB running dot
//     products, so every shared load feeds four multiply-adds and the
//     packed signature is read once per query tile; the similarity
//     lane owns SIM_ROWS docs at a time (rows_dots), so each pair of
//     broadcast projection loads feeds 8 * SIM_ROWS, and reads a doc's
//     words 16 bytes at a time.  Its scores keep doc_dots' chain bit
//     for bit: the top-k kernels are held to the oracle over them;
//   * the segment sum: the block also builds, per query and 4-bit
//     chunk, the 16 signed sums of the chunk's 4 projections (32 KB at
//     bits 256, TB 8; build_tables), and a lane scores its doc with one
//     nibble extract per chunk and, per live query, one conflict-free
//     table load and one add (lut_dots), about 2 + 2*nb instructions a
//     chunk against 4 * 12 bit by bit; a query tile with nb < TB live
//     queries costs nb, not TB (a template on nb);
//   * a block amortises its set-up over many docs: TOPK_TILES tiles
//     in the top-k; the similarity and the segment sum launch one wave
//     of blocks (as many as fit on the card at once, sim_grid_x and
//     lut_grid_x) whose threads walk the docs, or warps the segments,
//     in a fixed stride, so the projection (and the tables) are staged
//     once per block; the segment sums and the similarity's set-up
//     project with 16-byte plane loads (lut_project, project_tile's
//     bits);
//   * the top-k gives each warp one tile; for K <= 32 (the served
//     k = 10) the warp keeps each query's running top-K in registers
//     (asym_tile::warp_topk: lane r holds rank r; the first 32 rows are
//     sorted across the warp, later ballots pick the rows that beat the
//     K-th and shuffles shift them in), so no value or index
//     buffer is in shared memory and no barrier follows the projection;
//     for K > 32 the block scores a tile into shared memory and sorts
//     it there with a bitonic network.  Either way the order is value
//     descending, ties by ascending doc index (the order of
//     jax.lax.top_k), and only K candidates per tile and query are
//     written.
//
// Determinism of the segment sum: no float atomics.  Rows arrive
// sorted by segment with CSR offsets (the wrapper builds them; the
// index caches them).  One warp owns a segment at a time
// (lut_slot_sum): lane l sums docs lo+l, lo+l+32, ... in that order,
// then a fixed xor-butterfly of warp shuffles adds the 32 partials.
// Which block or warp takes a segment does not change its bits, and
// the same inputs give the same bits on every run.  Empty segments
// give exact zeros.  The tables need bits * 128 bytes of shared memory
// at TB 8 (plus the projection and the query tile); the wrapper
// raises where a block cannot have that much (bits above ≈1,400 at
// dim 64 on an H100).
//
// The entry points take plain pointers and return cudaGetLastError()
// right after the launch, so the Python wrapper can raise on a launch
// that never ran.

#include "asym_tile.cuh"

namespace {

using namespace asym_tile;

constexpr int SIM_ROWS = 2;                 // rows per thread a step, similarity
constexpr int SIM_THREADS = 256;            // threads per block, similarity
constexpr int TOPK_TILES = WARPS;           // tiles per block, top-k

// The similarity's set-up: block t projects query tile t once per
// launch, rather than once per block of the row walk (lut_project:
// project_tile's bits from 16-byte loads), and writes it out to
// proj_g[t][bits][TB].
__global__ void __launch_bounds__(THREADS)
asym_sim_project_kernel(const float* __restrict__ q,
                        const float* __restrict__ planes,
                        float* __restrict__ proj_g, int B, int dim,
                        int bits) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  lut_project(q, planes, B, dim, bits, blockIdx.x * TB, proj_t, q_s);
  float4* g4 = reinterpret_cast<float4*>(proj_g + (size_t)blockIdx.x * bits * TB);
  for (int i = threadIdx.x; i < bits * TB / 4; i += blockDim.x)
    g4[i] = smem4[i];
}

// Blocks walk the rows in a fixed stride: thread t of block x scores
// rows x * SIM_THREADS * SIM_ROWS + r * SIM_THREADS + t, r < SIM_ROWS,
// then the same gridDim.x * SIM_THREADS * SIM_ROWS further on, so a
// warp's lanes hold consecutive rows and its stores are coalesced.  A
// row's value does not depend on which thread scores it.  The block
// copies its query tile's projection from proj_g (asym_sim_project_kernel)
// with 16-byte loads.
__global__ void __launch_bounds__(SIM_THREADS)
asym_sim_kernel(const float* __restrict__ proj_g,
                const uint32_t* __restrict__ db, float* __restrict__ out,
                int B, int bits, int M, int W, float scale,
                float temperature) {
  extern __shared__ float4 smem4[];
  const int q0 = blockIdx.y * TB;
  const float4* g4 = reinterpret_cast<const float4*>(
      proj_g + (size_t)blockIdx.y * bits * TB);
  for (int i = threadIdx.x; i < bits * TB / 4; i += blockDim.x)
    smem4[i] = __ldg(g4 + i);
  __syncthreads();
  const int nb = min(TB, B - q0);
  const int nwords = bits / 32;
  const bool vec = (W & 3) == 0 && (nwords & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  const size_t step = (size_t)gridDim.x * SIM_THREADS * SIM_ROWS;
  for (size_t m0 = (size_t)blockIdx.x * SIM_THREADS * SIM_ROWS + threadIdx.x;
       m0 < (size_t)M; m0 += step) {
    size_t rows[SIM_ROWS];                   // a row past M scores row m0
#pragma unroll
    for (int r = 0; r < SIM_ROWS; ++r) {
      const size_t m = m0 + (size_t)r * SIM_THREADS;
      rows[r] = m < (size_t)M ? m : m0;
    }
    float dot[SIM_ROWS][TB];
    rows_dots<SIM_ROWS>(db, rows, W, nwords, vec, smem4, dot);
#pragma unroll
    for (int r = 0; r < SIM_ROWS; ++r) {
      const size_t m = m0 + (size_t)r * SIM_THREADS;
      if (m >= (size_t)M) break;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (b < nb)
          out[(size_t)(q0 + b) * M + m] = exp_sim(dot[r][b], scale, temperature);
    }
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
  lut_segsum_block(
      q, planes, db, B, dim, bits, W, S, scale, temperature,
      [offsets, M](int s, int& lo, int& hi) {
        lo = max(0, offsets[s]);
        hi = min(M, offsets[s + 1]);
      },
      out, reinterpret_cast<float*>(smem4));
}

// Top-k, K <= WARP_K: warp w of the block selects tile
// blockIdx.x * TOPK_TILES + w in registers.
__global__ void __launch_bounds__(THREADS)
asym_topk_warp_kernel(const float* __restrict__ q,
                      const float* __restrict__ planes,
                      const uint32_t* __restrict__ db,
                      float* __restrict__ vals_out, int* __restrict__ idx_out,
                      int B, int dim, int bits, int M, int W, int n_tiles,
                      int tm, int K, float scale, float temperature) {
  extern __shared__ float4 smem4[];
  float* proj_t = reinterpret_cast<float*>(smem4);
  float* q_s = proj_t + (size_t)bits * TB;
  const int q0 = blockIdx.y * TB;
  project_tile(q, planes, B, dim, bits, q0, proj_t, q_s);
  const int tile = blockIdx.x * TOPK_TILES + threadIdx.x / 32;
  if (tile >= n_tiles) return;               // no barrier follows
  float tv[TB];
  int ti[TB];
  warp_topk(db, W, bits / 32, smem4, scale, temperature, tile * tm, tm, K,
            [M](int row) { return row < M; }, tv, ti);
  write_ranks(vals_out, idx_out, q0, min(TB, B - q0), (size_t)n_tiles * K,
              (size_t)tile * K, K, tv, ti);
}

// Top-k, K > WARP_K: the block takes TOPK_TILES tiles in turn and sorts
// each tile's first sort_width(valid rows, K) rows in shared memory.
__global__ void __launch_bounds__(THREADS)
asym_topk_sort_kernel(const float* __restrict__ q,
                      const float* __restrict__ planes,
                      const uint32_t* __restrict__ db,
                      float* __restrict__ vals_out, int* __restrict__ idx_out,
                      int B, int dim, int bits, int M, int W, int n_tiles,
                      int tm, int K, float scale, float temperature) {
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
    const int first = tile * tm;
    const int n = sort_width(min(tm, M - first), K);
    score_tile(db, W, nwords, smem4, scale, temperature, first, n,
               [M](int row) { return row < M; }, vals, idx);
    bitonic_sort_desc(vals, idx, TB, n);
    for (int e = threadIdx.x; e < TB * K; e += blockDim.x) {
      const int b = e / K;
      const int r = e - b * K;
      if (b < nb) {
        const size_t o = (size_t)(q0 + b) * row_len + (size_t)tile * K + r;
        vals_out[o] = vals[b * n + r];
        idx_out[o] = idx[b * n + r];
      }
    }
    __syncthreads();                         // the next tile reuses vals
  }
}

// Shared memory of a similarity block: the projection [bits][TB].
size_t sim_smem_bytes(int bits) { return (size_t)bits * TB * sizeof(float); }

// Blocks along x of a similarity launch over M rows and n_qtiles query
// tiles: no more than one wave (as many blocks as fit on the card at
// once), and as few as take the rows in the same number of strides, so
// each block pays its projection for as many rows as it can.  Call
// after prepare.
int sim_grid_x(int M, int n_qtiles, size_t smem) {
  const int wave = wave_blocks(asym_sim_kernel, SIM_THREADS, smem, n_qtiles);
  const int need = (M + SIM_THREADS * SIM_ROWS - 1) / (SIM_THREADS * SIM_ROWS);
  const int strides = (need + wave - 1) / wave;
  return (need + strides - 1) / strides;
}

}  // namespace

extern "C" {

// Query tile size of the kernels (the wrappers read it for grid limits).
int asym_query_tile() { return TB; }

// Shared memory of one top-k block at these widths, and the device's
// per-block limit (the wrapper raises past it).
size_t asym_topk_smem(int bits, int dim, int tm, int K) {
  return topk_smem_bytes(bits, dim, tm, K);
}
int asym_smem_limit() { return smem_limit(); }

// The most K the top-k kernels select in registers; past it they sort
// in shared memory.
int asym_topk_warp_k() { return WARP_K; }

// Shared memory of one similarity block (row 1): the projection.
size_t asym_sim_smem(int bits) { return sim_smem_bytes(bits); }

// Blocks along x of a similarity launch over M rows for B queries (the
// grid is that by ceil(B / TB)); a negative CUDA error if the kernel
// cannot take the shared memory.
int asym_sim_grid_x(int bits, int M, int B) {
  const size_t smem = sim_smem_bytes(bits);
  cudaError_t err = prepare(asym_sim_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  return sim_grid_x(M, (B + TB - 1) / TB, smem);
}

// Row 1: the projection of each query tile into `proj` (ceil(B / TB) *
// bits * TB floats of scratch, the wrapper's), then the [B, M] values.
int asym_exp_similarity_launch(const float* q, const float* planes,
                               const uint32_t* db, float* proj, float* out,
                               int B, int dim, int bits, int M, int W,
                               float scale, float temperature, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const size_t psmem = smem_bytes(bits, dim, 0);
  const size_t smem = sim_smem_bytes(bits);
  cudaError_t err = prepare(asym_sim_project_kernel, psmem);
  if (err == cudaSuccess) err = prepare(asym_sim_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (B + TB - 1) / TB;
  asym_sim_project_kernel<<<n_qtiles, THREADS, psmem,
                            (cudaStream_t)stream>>>(q, planes, proj, B, dim,
                                                    bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sim_grid_x(M, n_qtiles, smem), n_qtiles);
  asym_sim_kernel<<<grid, SIM_THREADS, smem, (cudaStream_t)stream>>>(
      proj, db, out, B, bits, M, W, scale, temperature);
  return (int)cudaGetLastError();
}

// Shared memory of one segment-sum block (rows 2 and 7: the projection,
// the query tile and the lookup tables) at these widths.
size_t asym_lut_smem(int bits, int dim) { return lut_smem_bytes(bits, dim); }

// Blocks along x of a segment-sum launch over S slots for B queries
// (the grid is that by ceil(B / TB)); a negative CUDA error if the
// kernel cannot take the shared memory.
int asym_segsum_grid_x(int bits, int dim, int S, int B) {
  const size_t smem = lut_smem_bytes(bits, dim);
  cudaError_t err = prepare(asym_segsum_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  return lut_grid_x(asym_segsum_kernel, smem, S, (B + TB - 1) / TB);
}

int asym_exp_segment_sum_launch(const float* q, const float* planes,
                                const uint32_t* db, const int* offsets,
                                float* out, int B, int dim, int bits, int M,
                                int W, int S, float scale, float temperature,
                                void* stream) {
  cudaGetLastError();
  const size_t smem = lut_smem_bytes(bits, dim);
  cudaError_t err = prepare(asym_segsum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(lut_grid_x(asym_segsum_kernel, smem, S, (B + TB - 1) / TB),
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
  const auto kernel = K <= WARP_K ? asym_topk_warp_kernel
                                  : asym_topk_sort_kernel;
  const size_t smem = topk_smem_bytes(bits, dim, tm, K);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (M + tm - 1) / tm;
  const dim3 grid((n_tiles + TOPK_TILES - 1) / TOPK_TILES,
                  (B + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, planes, db, vals, idx, B, dim, bits, M, W, n_tiles, tm, K, scale,
      temperature);
  return (int)cudaGetLastError();
}

}  // extern "C"
