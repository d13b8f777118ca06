// Fused PV-DBOW negative-sampling (SGNS) gradients for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/negsamp/kernel.py, negsamp_grads_kernel (body
// _negsamp_kernel).  For each row b of a batch of B (doc, word,
// K negatives) examples, with t the temperature:
//     pos     = t * (w . d)            neg_k = t * (wn_k . d)
//     loss    = softplus(-pos) + sum_k softplus(neg_k)
//     gpos    = (sigmoid(pos) - 1) * t gneg_k = sigmoid(neg_k) * t
//     g_d     = gpos * w + sum_k gneg_k * wn_k
//     g_w     = gpos * d               g_wn_k = gneg_k * d
// softplus(x) is log(1 + e^x) in the stable form jax.nn.softplus uses
// (logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))).
//
// What bounds it on the card: bytes.  Per row it reads (2 + K) dim
// floats and writes 1 + (2 + K) dim; its (1 + K) dot products and the
// gradient products are about 6 (1 + K) dim flops per row, three orders
// of magnitude under the card's fp32 rate per byte.  At the training
// shape (B = 4096, K = 5, dim = 64) the whole call is 14.7 MB, a few
// microseconds of HBM time, so a launch costs about as much as the work.
//
// What the design does about it: one warp owns a row, lane l holds the
// elements l, l + 32, ... of each vector (every load and store of a
// warp is one coalesced 128-byte line per 32 elements), and the row is
// read once and written once.  Each negative is handled in one pass:
// its dot product (per-lane partial sums, then a fixed xor-butterfly of
// shuffles, so every lane holds the same total), its gradient row, and
// its term of g_d, accumulated in k order.  Rows are independent: no
// atomics, no shared memory, and the same inputs give the same bits on
// every run.  The scatter-add of the gradients into the embedding
// tables stays outside (kernels/negsamp/ops.py), as in the reference.
//
// The entry point takes plain pointers and returns cudaGetLastError()
// right after the launch, so the Python wrapper can raise on a launch
// that never ran.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                  // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_PER_LANE = 8;           // dim <= 32 * MAX_PER_LANE

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
negsamp_grads_kernel(const float* __restrict__ d, const float* __restrict__ w,
                     const float* __restrict__ wn, float* __restrict__ loss,
                     float* __restrict__ gd, float* __restrict__ gw,
                     float* __restrict__ gwn, int B, int K, int dim, float t) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= B) return;                   // uniform across the warp
  const size_t base = (size_t)row * dim;

  float dv[MAX_PER_LANE], wv[MAX_PER_LANE], acc[MAX_PER_LANE];
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int j = lane + 32 * i;
    dv[i] = j < dim ? d[base + j] : 0.0f;
    wv[i] = j < dim ? w[base + j] : 0.0f;
    part = fmaf(wv[i], dv[i], part);
  }
  const float pos = warp_sum(part) * t;
  const float gpos = (sigmoid(pos) - 1.0f) * t;
  float row_loss = softplus(-pos);
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) acc[i] = gpos * wv[i];

  for (int k = 0; k < K; ++k) {
    const size_t nb = ((size_t)row * K + k) * dim;
    float nv[MAX_PER_LANE];
    part = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      const int j = lane + 32 * i;
      nv[i] = j < dim ? wn[nb + j] : 0.0f;
      part = fmaf(nv[i], dv[i], part);
    }
    const float neg = warp_sum(part) * t;
    const float gneg = sigmoid(neg) * t;
    row_loss += softplus(neg);
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      const int j = lane + 32 * i;
      acc[i] = fmaf(gneg, nv[i], acc[i]);
      if (j < dim) gwn[nb + j] = gneg * dv[i];
    }
  }

#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int j = lane + 32 * i;
    if (j < dim) {
      gd[base + j] = acc[i];
      gw[base + j] = gpos * dv[i];
    }
  }
  if (lane == 0) loss[row] = row_loss;
}

}  // namespace

extern "C" {

// Largest dim the kernel takes (the wrapper reads it).
int negsamp_max_dim() { return 32 * MAX_PER_LANE; }

int negsamp_grads_launch(const float* d, const float* w, const float* wn,
                         float* loss, float* gd, float* gw, float* gwn, int B,
                         int K, int dim, float t, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  negsamp_grads_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      d, w, wn, loss, gd, gw, gwn, B, K, dim, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
