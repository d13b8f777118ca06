// Packed-signature Hamming kernels for Hopper (sm_90a): the paper's
// symmetric ("sym") LSH scoring, XOR + popcount (Sec. III-B).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/hamming/kernel.py, hamming_distance_kernel
//     (_tiled_call with _distance_kernel): the exact [N, M] int32
//         out[n, m] = sum over the W words of popcount(q[n] ^ db[m]);
//   * src/repro/kernels/hamming/kernel.py, hamming_similarity_kernel
//     (_tiled_call with _similarity_kernel / _sim_tile): the same
//     distance mapped to [N, M] float32 exp(beta * cos(pi * m / bits));
//   * src/repro/kernels/hamming/kernel.py,
//     hamming_segment_similarity_kernel (body _segsum_similarity_kernel):
//     those values summed per segment slot, [N, S] float32, without the
//     [N, M] intermediate ever reaching device memory.
//
// What bounds them on the card: the popcounts.  Per (query, row) it is
// W = bits/32 __popc, each with an XOR and an add, against 4 W bytes of
// signature per row read once per query tile; the card issues __popc at
// 16 results per clock per SM (compute capability 9.0), a quarter of
// its 32-bit integer add and logic rate, so at the serving shapes (N in
// the tens) the distance and segment sum are bound by popcount issue.
// The similarity also writes 4 bytes per (query, row), which at
// N = 48 is about two thirds of the popcount time.
//
// What the design does about it (shared device code in
// hamming_tile.cuh):
//   * one block holds a tile of TB = 8 query signatures in shared
//     memory, transposed to [W][TB], so one word's 8 query words are
//     two broadcast uint4 loads and each loaded row word feeds 8
//     XOR/popcounts;
//   * each thread owns one row at a time (ROWS_PER_THREAD rows in the
//     distance and similarity kernels), so every output store of a warp
//     is one coalesced 128-byte line per query;
//   * the float epilogue is a lookup in a (32 W + 1)-entry table the
//     wrapper makes once per (bits, W, beta) and the block stages in
//     shared memory: no cos or exp per value, and the kernels and their
//     plain versions read the same table, so rows 4 and 5 equal their
//     plain versions bit for bit;
//   * the segment sum follows the asym segment sum: rows arrive sorted
//     by segment with CSR offsets, one warp owns a segment (slot_sum):
//     lane l adds rows lo+l, lo+l+32, ... in order with __fadd_rn, then
//     a fixed xor-butterfly of warp shuffles adds the 32 partials.  No
//     float atomics: the same inputs give the same bits on every run,
//     and the megascan's Hamming kernel (megascan.cu), which inlines
//     the same slot_sum, gives the same bits over the same rows.  Empty
//     segments give exact zeros.
//
// The entry points take plain pointers and return cudaGetLastError()
// right after the launch, so the Python wrapper can raise on a launch
// that never ran.

#include "hamming_tile.cuh"

namespace {

using namespace hamming_tile;

constexpr int ROWS_PER_THREAD = 4;          // distance and similarity
constexpr int SEGS_PER_WARP = 4;            // segment sum
constexpr int SEGS_PER_BLOCK = WARPS * SEGS_PER_WARP;

template <bool SIM>
__global__ void __launch_bounds__(THREADS)
hamming_tile_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ db,
                    const float* __restrict__ table, int* __restrict__ dist_out,
                    float* __restrict__ sim_out, int N, int M, int W) {
  extern __shared__ uint4 smem4[];
  uint32_t* q_t = reinterpret_cast<uint32_t*>(smem4);
  float* tab = reinterpret_cast<float*>(q_t + (size_t)TB * W);
  const int q0 = blockIdx.y * TB;
  stage(q, SIM ? table : nullptr, N, W, q0, q_t, tab);
  const int nb = min(TB, N - q0);
  const size_t m0 = (size_t)blockIdx.x * THREADS * ROWS_PER_THREAD;
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const size_t m = m0 + (size_t)r * THREADS + threadIdx.x;
    if (m >= (size_t)M) break;
    int dist[TB];
    row_distances<TB, TB>(db + m * W, W, false, smem4, dist);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (b < nb) {
        const size_t o = (size_t)(q0 + b) * M + m;
        if constexpr (SIM) {
          sim_out[o] = tab[dist[b]];
        } else {
          dist_out[o] = dist[b];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
hamming_segsum_kernel(const uint32_t* __restrict__ q,
                      const uint32_t* __restrict__ db,
                      const int* __restrict__ offsets,
                      const float* __restrict__ table, float* __restrict__ out,
                      int N, int M, int W, int S) {
  extern __shared__ uint4 smem4[];
  uint32_t* q_t = reinterpret_cast<uint32_t*>(smem4);
  float* tab = reinterpret_cast<float*>(q_t + (size_t)TB * W);
  const int q0 = blockIdx.y * TB;
  stage(q, table, N, W, q0, q_t, tab);
  const int nb = min(TB, N - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s_first = blockIdx.x * SEGS_PER_BLOCK + warp * SEGS_PER_WARP;
  for (int i = 0; i < SEGS_PER_WARP; ++i) {
    const int s = s_first + i;
    if (s >= S) break;                       // uniform across the warp
    const int lo = max(0, offsets[s]);
    const int hi = min(M, offsets[s + 1]);
    float acc[TB];
    slot_sum<TB, TB>(db, lo, hi, W, false, smem4, tab, acc);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (lane == b && b < nb) out[(size_t)(q0 + b) * S + s] = acc[b];
  }
}

template <bool SIM>
int launch_tile(const uint32_t* q, const uint32_t* db, const float* table,
                int* dist, float* sim, int N, int M, int W, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const size_t smem = smem_bytes(W);
  const dim3 grid((M + THREADS * ROWS_PER_THREAD - 1) / (THREADS * ROWS_PER_THREAD),
                  (N + TB - 1) / TB);
  hamming_tile_kernel<SIM><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, db, table, dist, sim, N, M, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Query tile size of the kernels (the wrappers read it for grid limits).
int hamming_query_tile() { return TB; }

// Dynamic shared memory of one block at W words per signature.
size_t hamming_smem(int W) { return smem_bytes(W); }

int hamming_distance_launch(const uint32_t* q, const uint32_t* db, int* out,
                            int N, int M, int W, void* stream) {
  return launch_tile<false>(q, db, nullptr, out, nullptr, N, M, W, stream);
}

int hamming_similarity_launch(const uint32_t* q, const uint32_t* db,
                              const float* table, float* out, int N, int M,
                              int W, void* stream) {
  return launch_tile<true>(q, db, table, nullptr, out, N, M, W, stream);
}

int hamming_segment_sum_launch(const uint32_t* q, const uint32_t* db,
                               const int* offsets, const float* table,
                               float* out, int N, int M, int W, int S,
                               void* stream) {
  cudaGetLastError();
  const size_t smem = smem_bytes(W);
  const dim3 grid((S + SEGS_PER_BLOCK - 1) / SEGS_PER_BLOCK, (N + TB - 1) / TB);
  hamming_segsum_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, db, offsets, table, out, N, M, W, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
