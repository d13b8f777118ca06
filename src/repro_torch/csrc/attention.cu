// Fused attention forward for Hopper (sm_90a): softmax(Q K^T / d) V
// without the scores or the probabilities reaching device memory.
//
// Replaces no TPU kernel: the JAX package's attention
// (src/repro/models/attention.py, dense_attention) is plain jnp, and
// the port's dense_attention (kernels/attention/ref.py) follows it,
// writing the scores [B, KH, G, S, T] to device memory and passing over
// them again for the scale, the mask, a float32 copy, the softmax, a
// 16-bit copy and the product with V.  Added for the prefill, whose
// batches those passes bound: at 37 prompts of 1747 tokens
// (SmolLM-360M: 15 query heads, 5 KV heads, head 64) they move ~55 GB
// a layer.
//
// What bounds it on the card: at that shape the causal attention is
// 2.2e11 operations a layer, 0.22 ms at the tensor cores' 989 TFLOP/s,
// against 0.10 ms for reading Q, K, V and writing O once at 3.35 TB/s:
// operations.  At short prompts (150 tokens, 436 prompts: 1.9e10
// operations, 0.34 GB) bytes.
//
// What the design does about it (16-bit inputs, fused_attention_fwd):
//   * one block per (query tile, batch row, KV head); the
//     block's 128 rows are the (position, group head) pairs of its KV
//     head, row r holding position r / G of query head kh * G + r % G.
//     The G query heads that share a KV head share the block, so each
//     K/V tile is read once for them, and a short prompt still fills
//     the rows.  The last query tiles, the longest under the causal
//     mask, are launched first;
//   * each warp owns 32 rows (16 at head 128, where the registers do
//     not hold two row tiles' accumulators): its Q fragments stay in
//     registers, each K or V fragment feeds both row tiles, and
//     both products run on the tensor cores as mma.sync m16n8k16 with
//     float32 accumulators (QK^T from ldmatrix'ed K, PV from
//     ldmatrix.trans'ed V); the probabilities go from the S
//     accumulators to the PV operand in registers, rounded to the
//     inputs' type as dense_attention rounds them;
//   * K/V tiles of 32 keys stream through shared memory with cp.async,
//     double-buffered: tile j + 1 is in flight while tile j is used.
//     Rows are padded by 16 bytes, so ldmatrix reads no bank twice;
//   * the online softmax (running max and denominator, float32) lives
//     in registers; scores are multiplied by log2(e) / d, d the divisor
//     dense_attention uses (sqrt(hd) rounded to the inputs' type), and
//     exponentiated with ex2.approx (relative error 2^-22, far under
//     the 2^-9 of the probabilities' 16-bit rounding);
//   * tiles wholly above the causal diagonal or wholly outside the
//     window are skipped; only the edge tiles, those that reach past the
//     block's first position, its window, or the last key, are masked
//     element by element.  Masked scores are -inf, and a row whose max
//     is still -inf subtracts 0 instead, so a tile that a row cannot
//     see adds exactly nothing to it;
//   * the output is normalised once at the end, staged in the warp's own
//     rows of the Q tile, and written with 16-byte stores.
//
// float32 inputs (the port's float32 serving checks) take
// fused_attention_fwd_f32: the same blocks and masks on the CUDA cores
// in float32, for parity with dense_attention in float32 rather than
// speed: three passes over the keys (the row's max, the sum of
// exp(score - max), then the probabilities' sum of V rows), the scores
// divided by d and exponentiated with expf, each probability divided by
// the sum, and no running rescale of the output.
//
// The entry point takes plain pointers and element strides and returns
// cudaGetLastError() right after the launch, so the Python wrapper can
// raise on a launch that never ran.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 128;               // query rows a block
constexpr int BN = 32;                // keys a K/V tile
constexpr int F32_WARPS = 4;
constexpr int F32_ROWS = 4;           // query rows a warp (float32)
constexpr int F32_BM = F32_WARPS * F32_ROWS;
constexpr int F32_BN = 32;            // keys a K/V tile (float32)
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;         // element strides
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int s, t, kh, g, q_offset, window;  // window: 0 = none (causal only)
  bool causal;
  float scale;                        // 16-bit: log2(e) / d; float32: d
};

// Keys [lo, hi) some row of the block sees; [f0, f1) every row sees,
// so those tiles take no mask.  Tiles start at lo + a multiple of bn.
struct Range {
  int lo, hi, f0, f1;
};

__device__ __forceinline__ Range key_range(const Args& a, int r0, int bm,
                                           int bn) {
  const int first = r0 / a.g + a.q_offset;
  const int last = min((r0 + bm - 1) / a.g, a.s - 1) + a.q_offset;
  int lo = 0, hi, full_lo = 0, full_hi;
  if (a.causal) {
    hi = min(a.t, last + 1);
    full_hi = min(a.t, first + 1) / bn * bn;
    if (a.window > 0) {
      lo = max(0, first - a.window + 1) / bn * bn;
      full_lo = (max(0, last - a.window + 1) + bn - 1) / bn * bn;
    }
  } else {
    hi = a.t;
    full_hi = a.t / bn * bn;
  }
  const int f0 = min(max(full_lo, lo), hi);
  const int f1 = min(max(full_hi, f0), hi);
  return {lo, hi, f0, f1};
}

__device__ __forceinline__ bool sees(const Args& a, int qpos, int kpos) {
  if (kpos >= a.t) return false;
  if (!a.causal) return true;
  return kpos <= qpos && (a.window == 0 || kpos > qpos - a.window);
}

// ---------------------------------------------------------------------
// 16-bit inputs: mma.sync on the tensor cores
// ---------------------------------------------------------------------
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

template <int HD>
__host__ __device__ constexpr int ld16() {   // padded row, in elements
  return HD + 8;
}

// m16 row tiles a warp owns: two where the registers allow (they share
// each K and V fragment loaded from shared memory), one at head 128
template <int HD>
__host__ __device__ constexpr int mtiles() {
  return HD <= 64 ? 2 : 1;
}

template <int HD>
__host__ __device__ constexpr int warps16() {
  return BM / (16 * mtiles<HD>());
}

// blocks an SM must hold: three (168 registers a thread) where the rows
// are short, so one block's prologue hides behind another's products
template <int HD>
__host__ __device__ constexpr int min_blocks16() {
  return HD <= 64 ? 3 : 1;
}

template <typename T, int HD>
__host__ __device__ constexpr size_t smem16() {
  return sizeof(T) * ld16<HD>() * (BM + 4 * BN);   // Q, 2 x K, 2 x V
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// K and V tile of keys [start, start + BN) into one stage
template <typename T, int HD>
__device__ __forceinline__ void load_kv(const Args& a, const T* kb,
                                        const T* vb, T* sk, T* sv,
                                        int start) {
  constexpr int LD = ld16<HD>(), CH = HD / 8, N = 32 * warps16<HD>();
  for (int i = threadIdx.x; i < BN * CH; i += N) {
    const int r = i / CH, c = i % CH, key = start + r;
    const bool ok = key < a.t;
    const long long kk = ok ? key : 0;
    cp_async16(sk + r * LD + c * 8, kb + kk * a.k_st + c * 8, ok);
    cp_async16(sv + r * LD + c * 8, vb + kk * a.v_st + c * 8, ok);
  }
}

// One K/V tile into a warp's running max m, partial denominators l and
// output o: for each of its MT row tiles, rows g and g + 8 of the 16,
// g = lane / 4
template <typename T, int HD, int MT, bool MASK>
__device__ __forceinline__ void tile16(
    const Args& a, const uint32_t (&qf)[MT][HD / 16][4], const T* sk,
    const T* sv, int start, const int (&qpos)[MT][2], float (&m)[MT][2],
    float (&l)[MT][2], float (&o)[MT][HD / 8][4]) {
  constexpr int LD = ld16<HD>();
  const int lane = threadIdx.x & 31;
  float s[MT][BN / 8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      s[t][j][0] = s[t][j][1] = s[t][j][2] = s[t][j][3] = 0.f;
  // S = Q K^T: B operand from K rows (keys) as stored
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < BN / 16; ++nn) {
      uint32_t kf[4];
      ldsm_x4(kf, sk + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        Mma<T>::run(s[t][2 * nn], qf[t][kk], kf[0], kf[1]);
        Mma<T>::run(s[t][2 * nn + 1], qf[t][kk], kf[2], kf[3]);
      }
    }
  }
  uint32_t pa[MT][BN / 16][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    float mx[2] = {m[t][0], m[t][1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][j][e] * a.scale;
        if (MASK) {
          const int kpos = start + j * 8 + (lane & 3) * 2 + (e & 1);
          if (!sees(a, qpos[t][e >> 1], kpos)) x = -CUDART_INF_F;
        }
        s[t][j][e] = x;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[t][j][0], s[t][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[t][j][2], s[t][j][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      base[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];
      alpha[i] = ex2(m[t][i] - base[i]);
      m[t][i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p0 = ex2(s[t][j][0] - base[0]);
      const float p1 = ex2(s[t][j][1] - base[0]);
      const float p2 = ex2(s[t][j][2] - base[1]);
      const float p3 = ex2(s[t][j][3] - base[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      // the PV operand: keys 16 kk .. 16 kk + 15 are n-tiles 2 kk, 2 kk + 1
      pa[t][j >> 1][(j & 1) * 2] = Mma<T>::pack(p0, p1);
      pa[t][j >> 1][(j & 1) * 2 + 1] = Mma<T>::pack(p2, p3);
    }
    l[t][0] = l[t][0] * alpha[0] + rs[0];
    l[t][1] = l[t][1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[t][j][0] *= alpha[0];
      o[t][j][1] *= alpha[0];
      o[t][j][2] *= alpha[1];
      o[t][j][3] *= alpha[1];
    }
  }
  // O += P V: B operand from V.trans
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) {
      uint32_t vf[4];
      ldsm_x4_t(vf, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             LD + dd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        Mma<T>::run(o[t][2 * dd], pa[t][kk], vf[0], vf[1]);
        Mma<T>::run(o[t][2 * dd + 1], pa[t][kk], vf[2], vf[3]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * warps16<HD>(), min_blocks16<HD>())
    fused_attention_fwd(const Args a) {
  constexpr int LD = ld16<HD>(), CH = HD / 8, MT = mtiles<HD>();
  constexpr int N = 32 * warps16<HD>(), WR = 16 * MT;   // threads; rows a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);       // [BM][LD]
  T* sk = sq + BM * LD;                         // [2][BN][LD]
  T* sv = sk + 2 * BN * LD;                     // [2][BN][LD]
  const T* Q = static_cast<const T*>(a.q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y / a.kh, kh = blockIdx.y % a.kh;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;

  for (int i = threadIdx.x; i < BM * CH; i += N) {
    const int r = i / CH, c = i % CH, row = r0 + r, pos = row / a.g;
    const bool ok = pos < a.s;
    const T* src = Q + (ok ? b * a.q_sb + (long long)pos * a.q_ss +
                                 (long long)(kh * a.g + row % a.g) * a.q_sh +
                                 c * 8
                           : 0);
    cp_async16(sq + r * LD + c * 8, src, ok);
  }
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const Range kr = key_range(a, r0, BM, BN);
  const int n_tiles = (kr.hi - kr.lo + BN - 1) / BN;
  load_kv<T, HD>(a, kb, vb, sk, sv, kr.lo);
  cp_async_commit();

  int qpos[MT][2];
  float m[MT][2], l[MT][2], o[MT][HD / 8][4];
  uint32_t qf[MT][HD / 16][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qpos[t][i] = (r0 + warp * WR + t * 16 + i * 8 + (lane >> 2)) / a.g +
                   a.q_offset;
      m[t][i] = -CUDART_INF_F;
      l[t][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      o[t][j][0] = o[t][j][1] = o[t][j][2] = o[t][j][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int start = kr.lo + it * BN, st = it & 1;
    if (it + 1 < n_tiles)
      load_kv<T, HD>(a, kb, vb, sk + (st ^ 1) * BN * LD,
                     sv + (st ^ 1) * BN * LD, start + BN);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldsm_x4(qf[t][kk],
                  sq + (warp * WR + t * 16 + (lane & 7) +
                        ((lane >> 3) & 1) * 8) * LD +
                      kk * 16 + (lane >> 4) * 8);
    }
    const T* k_t = sk + st * BN * LD;
    const T* v_t = sv + st * BN * LD;
    if (start < kr.f0 || start + BN > kr.f1)
      tile16<T, HD, MT, true>(a, qf, k_t, v_t, start, qpos, m, l, o);
    else
      tile16<T, HD, MT, false>(a, qf, k_t, v_t, start, qpos, m, l, o);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // the row's denominator is the sum of its quad's partials; the output
  // is staged in the warp's own rows of sq (no other warp reads them)
  T* so = sq + warp * WR * LD;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[t][i] += __shfl_xor_sync(FULL, l[t][i], 1);
      l[t][i] += __shfl_xor_sync(FULL, l[t][i], 2);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      T* at = so + (t * 16 + (lane >> 2)) * LD + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(at) =
          Mma<T>::pack(o[t][j][0] / l[t][0], o[t][j][1] / l[t][0]);
      *reinterpret_cast<uint32_t*>(at + 8 * LD) =
          Mma<T>::pack(o[t][j][2] / l[t][1], o[t][j][3] / l[t][1]);
    }
  }
  __syncwarp();
  T* O = static_cast<T*>(a.o);
  for (int i = lane; i < WR * CH; i += 32) {
    const int r = i / CH, c = i % CH, row = r0 + warp * WR + r;
    const int pos = row / a.g;
    if (pos < a.s)
      *reinterpret_cast<uint4*>(O + b * a.o_sb + (long long)pos * a.o_ss +
                                (long long)(kh * a.g + row % a.g) * a.o_sh +
                                c * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------
// float32 inputs: the CUDA cores, one warp a query row at a time
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(32 * F32_WARPS)
    fused_attention_fwd_f32(const Args a) {
  constexpr int LD = HD + 1;                 // odd stride: no bank twice
  constexpr int DL = (HD + 31) / 32;         // output dims a lane
  __shared__ float sq[F32_BM][HD];
  __shared__ float sk[F32_BN][LD];
  __shared__ float sv[F32_BN][LD];
  const float* Q = static_cast<const float*>(a.q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y / a.kh, kh = blockIdx.y % a.kh;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * F32_BM;

  for (int i = threadIdx.x; i < F32_BM * HD; i += 32 * F32_WARPS) {
    const int r = i / HD, d = i % HD, row = r0 + r, pos = row / a.g;
    sq[r][d] = pos < a.s ? Q[b * a.q_sb + (long long)pos * a.q_ss +
                             (long long)(kh * a.g + row % a.g) * a.q_sh + d]
                         : 0.f;
  }
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const Range kr = key_range(a, r0, F32_BM, F32_BN);

  int qpos[F32_ROWS];
  float m[F32_ROWS], l[F32_ROWS], o[F32_ROWS][DL];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    qpos[r] = (r0 + warp * F32_ROWS + r) / a.g + a.q_offset;
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[r][i] = 0.f;
  }
  // as dense_attention in three passes over the keys: the row's max,
  // the sum of exp(score - max), then the normalised probabilities'
  // sum of V rows; no running rescale
  for (int pass = 0; pass < 3; ++pass) {
    for (int start = kr.lo; start < kr.hi; start += F32_BN) {
      __syncthreads();
      for (int i = threadIdx.x; i < F32_BN * HD; i += 32 * F32_WARPS) {
        const int r = i / HD, d = i % HD, key = start + r;
        const bool ok = key < a.t;
        sk[r][d] = ok ? kb[(long long)key * a.k_st + d] : 0.f;
        if (pass == 2) sv[r][d] = ok ? vb[(long long)key * a.v_st + d] : 0.f;
      }
      __syncthreads();
      const int kpos = start + lane;
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        const float* qr = sq[warp * F32_ROWS + r];
        float x = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) x = fmaf(qr[d], sk[lane][d], x);
        const bool seen = sees(a, qpos[r], kpos);
        x = x / a.scale;
        if (pass == 0) {
          float mx = seen ? x : -CUDART_INF_F;
#pragma unroll
          for (int w = 16; w > 0; w >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
          m[r] = fmaxf(m[r], mx);
          continue;
        }
        float p = seen ? expf(x - m[r]) : 0.f;
        if (pass == 1) {
#pragma unroll
          for (int w = 16; w > 0; w >>= 1) p += __shfl_xor_sync(FULL, p, w);
          l[r] += p;
          continue;
        }
        p = p / l[r];
        for (int j = 0; j < F32_BN; ++j) {
          const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
          for (int i = 0; i < DL; ++i) {
            const int d = lane + 32 * i;
            if (d < HD) o[r][i] = fmaf(pj, sv[j][d], o[r][i]);
          }
        }
      }
    }
  }
  float* O = static_cast<float*>(a.o);
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const int row = r0 + warp * F32_ROWS + r, pos = row / a.g;
    if (pos >= a.s) continue;
    float* out = O + b * a.o_sb + (long long)pos * a.o_ss +
                 (long long)(kh * a.g + row % a.g) * a.o_sh;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) out[d] = o[r][i];
    }
  }
}

template <typename T, int HD>
cudaError_t launch16(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t bytes = smem16<T, HD>();
  // per launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s * a.g + BM - 1) / BM, batch * a.kh);
  fused_attention_fwd<T, HD><<<grid, 32 * warps16<HD>(), bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim16(const Args& a, int hd, int batch,
                          cudaStream_t stream) {
  switch (hd) {
    case 16: return launch16<T, 16>(a, batch, stream);
    case 32: return launch16<T, 32>(a, batch, stream);
    case 64: return launch16<T, 64>(a, batch, stream);
    case 128: return launch16<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch32(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.s * a.g + F32_BM - 1) / F32_BM, batch * a.kh);
  fused_attention_fwd_f32<HD><<<grid, 32 * F32_WARPS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bfloat16, 1 float16, 2 float32.  divisor: d, the scores'
// divisor (sqrt(hd) rounded to the inputs' type).
extern "C" int fused_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int batch, int s, int t, int kh, int g, int hd, int q_offset,
    int window, int causal, float divisor, void* stream) {
  Args a{q,    k,    v,    o,    q_sb, q_ss,     q_sh,   k_sb,
         k_st, k_sh, v_sb, v_st, v_sh, o_sb,     o_ss,   o_sh,
         s,    t,    kh,   g,    q_offset, causal ? window : 0,
         causal != 0, 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    a.scale = divisor;
    switch (hd) {
      case 16: return launch32<16>(a, batch, st);
      case 32: return launch32<32>(a, batch, st);
      case 64: return launch32<64>(a, batch, st);
      case 128: return launch32<128>(a, batch, st);
      default: return cudaErrorInvalidValue;
    }
  }
  a.scale = static_cast<float>(1.4426950408889634 / divisor);
  if (dtype == 0) return by_head_dim16<__nv_bfloat16>(a, hd, batch, st);
  if (dtype == 1) return by_head_dim16<__half>(a, hd, batch, st);
  return cudaErrorInvalidValue;
}
