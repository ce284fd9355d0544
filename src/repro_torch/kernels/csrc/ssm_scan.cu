// Mamba-1 selective scan on Hopper (sm_90a): f32 or bf16 x, dt, Bm, Cm;
// f32 A and state; y in x's type.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = h_t . C_t
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py:_scan_kernel
// (launched by selective_scan_kernel).  As there, exp(dt * A) is made on
// the fly and the (B, S, Di, N) tensor never exists in device memory.
//
// What bounds it on the card: every (b, t, channel, state) needs one exp,
// and the special-function units do 16 a clock per SM; at falcon-mamba-7b
// width (S = 4096, Di = 8192, N = 16) that is 537 M exps against about
// 200 MB of bytes in bf16, so the exps bound it, not the bytes.  The
// recurrence is sequential in t for each (b, channel, state).
//
// Design:
//   * one thread per (b, channel, state n): the N lanes of one channel sit
//     side by side in one warp (N a power of two <= 32), so a block of
//     CH = 32 channels has 32 N threads and there are Di * N threads per
//     batch row (131,072 at falcon-mamba width), enough to fill 132 SMs;
//   * each thread walks the sequence with its h in a register;
//   * chunks of TC steps of dt, dt * x (per channel) and B, C (per state)
//     are staged in shared memory in f32, loaded coalesced;
//   * y_t = sum_n h C_t is reduced over the N lanes with __shfl_xor_sync,
//     staged in shared memory and written coalesced after the chunk;
//   * exp is expf (no fast-math intrinsics).
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;            // channels per block
constexpr int TC = 64;            // time steps per staged chunk
constexpr int NMAX = 32;          // largest state size

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(CH * NMAX)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, T* __restrict__ y, int S,
                      int Di, int N, int log2n) {
  __shared__ float dts[TC][CH];   // dt
  __shared__ float dxs[TC][CH];   // dt * x
  __shared__ float ys[TC][CH];
  __shared__ float bs[TC][NMAX];
  __shared__ float cs[TC][NMAX];

  const int nt = CH * N;
  const int tid = threadIdx.x;
  const int c = tid >> log2n;     // channel in the block
  const int n = tid & (N - 1);    // state
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const float a = d < Di ? A[(size_t)d * N + n] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tn = min(TC, S - t0);
    __syncthreads();              // the previous chunk's ys is written out
    for (int i = tid; i < TC * CH; i += nt) {
      const int t = i / CH, cc = i % CH;
      float dv = 0.f, xv = 0.f;
      if (t < tn && d0 + cc < Di) {
        const size_t off = ((size_t)b * S + t0 + t) * Di + d0 + cc;
        dv = to_f32(dt[off]);
        xv = to_f32(x[off]);
      }
      dts[t][cc] = dv;
      dxs[t][cc] = dv * xv;
    }
    for (int i = tid; i < TC * N; i += nt) {
      const int t = i >> log2n, nn = i & (N - 1);
      float bv = 0.f, cv = 0.f;
      if (t < tn) {
        const size_t off = ((size_t)b * S + t0 + t) * N + nn;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      bs[t][nn] = bv;
      cs[t][nn] = cv;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < tn; ++t) {
      const float da = expf(dts[t][c] * a);
      h = da * h + dxs[t][c] * bs[t][n];
      float p = h * cs[t][n];
      for (int off = N >> 1; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[t][c] = p;
    }
    __syncthreads();

    for (int i = tid; i < tn * CH; i += nt) {
      const int t = i / CH, cc = i % CH;
      if (d0 + cc < Di)
        store(y + ((size_t)b * S + t0 + t) * Di + d0 + cc, ys[t][cc]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int Di, int N, int log2n,
           cudaStream_t stream) {
  dim3 grid((Di + CH - 1) / CH, B);
  selective_scan_kernel<T><<<grid, CH * N, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, Di, N, log2n);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt (B, S, Di); A (Di, N) float; Bm, Cm (B, S, N); y like x; all
// contiguous; x, dt, Bm, Cm and y of one type (bf16 != 0: __nv_bfloat16,
// else float).  N is a power of two <= 32.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, void* y, int B, int S,
                                     int Di, int N, int bf16, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < N) ++log2n;
  if (B < 1 || B > 65535 || S < 1 || Di < 1 || N < 1 || N > NMAX ||
      (1 << log2n) != N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, Di, N,
                                      log2n, st)
              : launch<float>(x, dt, A, Bm, Cm, y, B, S, Di, N, log2n, st);
}
