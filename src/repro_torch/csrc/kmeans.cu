// Spherical k-means assignment for Hopper (sm_90a): each row's most
// similar centroid and its score (paper Sec. IV-D, document allocation).
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/kmeans/kernel.py, assign_kernel (body
// _assign_kernel): for x [N, dim] and centroids c [K, dim], both with
// unit rows,
//     assign[n] = argmax_k x[n] . c[k]   (the first maximal k, as
//                                          jnp.argmax gives)
//     best[n]   = max_k    x[n] . c[k]
// without the [N, K] score matrix ever reaching device memory (at the
// allocation shape, N = 2^20 documents and K = 39983 shards, it would
// be 168 GB).
//
// What bounds it on the card: fp32 operations.  2 N K dim flops (5.4
// TFLOP at that shape) plus N K compares, against 268 MB of x and 10 MB
// of c read once: about 80 ms of the card's fp32 rate and a tenth of a
// millisecond of HBM.  The scores are computed in fp32 on the CUDA
// cores, no TF32: this is the parity path.
//
// What the design does about it: a register-tiled product.  A block of
// 256 threads owns BM = 128 rows, whose vectors it stages once in
// shared memory (transposed, [dim][BM]); it streams the centroids
// through shared memory in tiles of BN = 128 centroids and BK = 16
// dims (c does not fit: 10 MB at K = 39983).  Each thread computes an
// 8 x 8 block of scores from two float4 loads of rows and two of
// centroids per dim, 64 FMAs per 4 shared-memory loads, each score one
// FMA chain over the dims in order.  After each centroid tile the
// thread folds its 8 columns, in ascending centroid index, into a
// running (max, argmax) per row with a strict '>', so it keeps the
// first maximal index it saw.  At the end the 16 threads that share a
// row merge their (max, argmax) with a fixed xor-butterfly of
// shuffles, taking the larger score and, on equal scores, the lower
// index: the result is the first maximal index over all K.  Ragged N
// and K are masked in the kernel (padding rows are not written,
// padding centroids never compete).  No atomics: the same inputs give
// the same bits on every run.
//
// The entry point takes plain pointers and returns cudaGetLastError()
// right after the launch, so the Python wrapper can raise on a launch
// that never ran.

#include <cstddef>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;                  // rows per block
constexpr int BN = 128;                  // centroids per tile
constexpr int BK = 16;                   // dims per centroid chunk
constexpr int PAD = 4;                   // shared-memory row padding
constexpr int XS = BM + PAD;             // row stride of the staged x
constexpr int CS = BN + PAD;             // row stride of a centroid chunk
constexpr int MAX_DIM = 256;

__host__ __device__ constexpr int padded_dim(int dim) {
  return (dim + BK - 1) / BK * BK;
}

size_t smem_bytes(int dim) {
  return sizeof(float) * ((size_t)padded_dim(dim) * XS + (size_t)BK * CS);
}

__device__ __forceinline__ int micro(int t, int i) {  // i-th of 8 rows/cols
  return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ assign, float* __restrict__ best,
                     int N, int K, int dim) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);        // [DP][XS]
  const int dp = padded_dim(dim);
  float* cs = xs + (size_t)dp * XS;                    // [BK][CS]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;

  for (int e = tid; e < dp * BM; e += THREADS) {
    const int r = e / dp, k = e % dp;
    const long long m = m0 + r;
    xs[k * XS + r] = (m < N && k < dim) ? x[m * dim + k] : 0.0f;
  }

  float bval[8];
  int bidx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bval[i] = -CUDART_INF_F;
    bidx[i] = 0;
  }

  for (int n0 = 0; n0 < K; n0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int kc = 0; kc < dp; kc += BK) {
      __syncthreads();                   // the last chunk's readers are done
#pragma unroll
      for (int s = 0; s < BN * BK / THREADS; ++s) {
        const int e = tid + s * THREADS;
        const int n = e / BK, kk = e % BK;
        const int col = n0 + n, k = kc + kk;
        cs[kk * CS + n] = (col < K && k < dim) ? c[(size_t)col * dim + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float* xr = xs + (size_t)(kc + kk) * XS;
        const float* cr = cs + kk * CS;
        const float4 a0 = *reinterpret_cast<const float4*>(xr + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(xr + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(cr + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(cr + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // fold this tile's columns in ascending centroid index: strict '>'
    // keeps the first maximal index
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + micro(tx, j);
      if (col < K) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (acc[i][j] > bval[i]) {
            bval[i] = acc[i][j];
            bidx[i] = col;
          }
        }
      }
    }
  }

  // the 16 threads of a row (lanes of one half-warp) merge: larger score
  // wins, equal scores keep the lower index
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bval[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (ov > bval[i] || (ov == bval[i] && oi < bidx[i])) {
        bval[i] = ov;
        bidx[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + micro(ty, i);
      if (m < N) {
        assign[m] = bidx[i];
        best[m] = bval[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// Largest dim the kernel takes (the wrapper reads it).
int kmeans_max_dim() { return MAX_DIM; }

int kmeans_assign_launch(const float* x, const float* c, int* assign,
                         float* best, int N, int K, int dim, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const size_t smem = smem_bytes(dim);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((N + BM - 1) / BM);
  kmeans_assign_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, c, assign, best, N, K, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"
