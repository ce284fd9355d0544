// Causal or full GQA attention forward on Hopper (sm_90a): f32 or bf16
// in, f32 math, output in the input's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (launched by flash_attention_kernel).  Same algebra: q is
// scaled by 1/sqrt(d) in f32, scores are q.k in f32, the online softmax
// keeps a running max m, a running sum l and an f32 output accumulator,
// masked scores are NEG_INF = -1e30, and the output is acc / max(l, 1e-30).
// Query head h reads kv head h / (Hq / Hkv).
//
// What bounds it on the card: at the widths the repo configures (S = 4096,
// d = 64..128) attention does about S/2 (causal) multiply-adds per byte
// it must move, so it is bounded by operations, not bytes.  This kernel
// does its products with scalar f32 FMAs on the CUDA cores, not the tensor
// cores; in its inner loops a warp issues 12 (scores) or 8 + d/16 (P.V)
// shared-memory loads per 32 (scores) or 8 * d/16 (P.V) FMAs per thread,
// so shared-memory bandwidth, not the FMA rate, is its likely limit.
//
// Design:
//   * one block of 128 threads per (query tile of BQ = 64 rows, q head, b);
//     the heaviest causal tiles (the last rows) are scheduled first;
//   * the q tile (pre-scaled) and each K/V tile of BK = 64 keys are staged
//     in shared memory, converted to f32 once on load; rows of Q and K are
//     padded to d + 1 floats so the score loop is free of bank conflicts;
//   * each thread owns an 8 x 4 tile of the scores and an 8 x d/16 tile of
//     the output accumulator in registers; the S x S scores never reach
//     device memory;
//   * kv tiles entirely above the diagonal are never loaded (causal);
//   * exp is expf (no fast-math intrinsics), and f32 FMAs only: no TF32.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int NT = 128;           // threads per block: 16 (cols) x 8 (rows)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // q (BQ x D+1), k (BK x D+1), v (BK x D), scores (BQ x BK+1), m, l, alpha
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int S, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;       // padded row stride of q and k
  constexpr int SP = BK + 1;      // padded row stride of the scores
  constexpr int DC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ss = vs + BK * D;
  float* m_s = ss + BQ * SP;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // columns tx + 16 j
  const int ty = tid >> 4;        // rows ty + 8 i
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const T* qb = q + ((size_t)b * Hq + h) * S * D;
  const T* kb = k + ((size_t)b * Hkv + kvh) * S * D;
  const T* vb = v + ((size_t)b * Hkv + kvh) * S * D;
  T* ob = o + ((size_t)b * Hq + h) * S * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * DP + c] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * D + c]) * scale
                                : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();              // the previous tile's k, v, p are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      ks[r * DP + c] = in ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 8 i, keys tx + 16 j
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = qs[(ty + 8 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 8 * i, c = tx + 16 * j;
        const int kp = k0 + c;
        const bool masked = kp >= S || (causal && kp > q0 + r);
        ss[r * SP + c] = masked ? NEG_INF : sc[i][j];
      }
    __syncthreads();

    // online softmax: two threads per row, BK / 2 keys each
    {
      const int r = tid >> 1;
      const int c0 = (tid & 1) * (BK / 2);
      float* row = ss + r * SP + c0;
      const float m_prev = m_s[r];
      float mx = NEG_INF;
#pragma unroll 8
      for (int c = 0; c < BK / 2; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll 8
      for (int c = 0; c < BK / 2; ++c) {
        const float p = expf(row[c] - m_cur);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();               // both threads of the row read m_prev
      if ((tid & 1) == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = a_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[8], vv[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = ss[(ty + 8 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // l_s was last written before the last __syncthreads above
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      store(ob + (size_t)(q0 + r) * D + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, S, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int S, int D, int causal, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 80: return launch<T, 80>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 96: return launch<T, 96>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, S, D), o like q; all contiguous, of
// one type (bf16 != 0: __nv_bfloat16, else float).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int bf16, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 || S < 1 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D,
                                        causal, st)
              : dispatch<float>(q, k, v, o, B, Hq, Hkv, S, D, causal, st);
}
