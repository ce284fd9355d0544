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
// 200 MB of bytes in bf16 (400 MB in f32), so the exps bound it, not the
// bytes.  What binds in practice is issue: about 13 instructions a exp
// (4 issued a clock an SM) through a sequence of dependent steps.
//
// Design:
//   * a thread owns G = min(N, 8) states of one channel; the N / G threads
//     of a channel are neighbouring lanes, so y_t is summed over the G
//     states in registers and over the lanes with log2(N / G) shuffles
//     (one at N = 16, none at N <= 8); a warp holds 32 G / N channels;
//   * the time axis is split too: a block of R = 4 warps walks its
//     channels through chunks of TC = R * L = 32 steps, and warp r takes
//     the run of L = 8 steps r L .. r L + L - 1 of each chunk, so a batch
//     row has Di * R * N / G threads (65,536 at falcon-mamba width: 16
//     warps on each of the 132 SMs, 4 blocks an SM);
//   * pass 1: each run is scanned from h = 0, keeping its L * G decays
//     2^(dt * A log2 e) in registers (the one exp of each (t, channel,
//     state)), and its pair (prod of decays, h) goes to shared memory;
//     the chunk's one block barrier follows;
//   * warp r folds the pairs of the runs before it in order, carry =
//     P carry + h, starting from the chunk's starting state, which the
//     last run of the chunk before published after its replay;
//   * pass 2: each run is replayed from its true carry with the decays it
//     kept (no exp), and y_t is summed and staged in shared memory;
//   * exp is ex2.approx.ftz (MUFU.EX2 alone), with log2 e folded into A
//     when A is loaded; the decays are exact where dt = 0 (ragged steps);
//   * each warp stages, converts, reads and writes only its own run's
//     rows, so those need no block barrier (__syncwarp): its rows of the
//     next chunk are prefetched with cp.async as 16-byte vectors of dt, x
//     (its block's channels) and B, C (shared by them) into a raw double
//     buffer, converted once to f32 dt, dt * x, B and C, and its rows of
//     y are written from shared memory as 16-byte vectors; where a row
//     is not a multiple of 16 bytes or a pointer not 16-byte aligned, the
//     plain loads and stores take their place.
// Ragged S (steps >= S read dt = 0, x = 0: decay 1, no input) and ragged
// Di (channels >= Di read zeros and are not stored) are handled here.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4;              // runs of a chunk: one warp each
constexpr int L = 8;              // steps of a run
constexpr int TC = R * L;         // steps of a chunk
constexpr int NT = 32 * R;        // threads per block
constexpr int NMAX = 32;          // largest state size
constexpr float LOG2E = 1.4426950408889634f;

// states per thread, threads per channel and channels per block at N
template <int N>
struct Lay {
  static constexpr int G = N < 8 ? N : 8;
  static constexpr int NG = N / G;
  static constexpr int CH = 32 / NG;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive values of shared memory, as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// W consecutive floats of shared memory into registers (W = 1, 2, 4, 8)
template <int W>
__device__ __forceinline__ void ldv(float (&r)[W], const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      const float4 x = ld4(p + k);
      r[k] = x.x, r[k + 1] = x.y, r[k + 2] = x.z, r[k + 3] = x.w;
    }
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  } else {
    r[0] = *p;
  }
}

// 16 bytes of T from 16 / sizeof(T) floats of shared memory
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* p);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                    __float_as_uint(v.z), __float_as_uint(v.w));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* p) {
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(p[2 * k], p[2 * k + 1]);
    u[k] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// W floats of registers into shared memory (W = 1, 2, 4)
template <int W>
__device__ __forceinline__ void stv(float* p, const float* r) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else if constexpr (W == 2)
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  else
    *p = r[0];
}

// one warp's rows t0 .. t0 + L - 1 of a (B, S, W) array, columns c0 ..
// c0 + C - 1, into raw[L][C]; positions past S or W read zeros.  vec:
// W * sizeof(T) and the base are multiples of 16 bytes (so are c0 and C),
// and each 16-byte piece lies wholly inside or outside the row.
template <typename T, int C>
__device__ __forceinline__ void stage(T* raw, const T* src, int t0, int S,
                                      int W, int c0, bool vec, int lane) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);     // values per piece
    constexpr int P = C / V;              // pieces per row
    for (int i = lane; i < L * P; i += 32) {
      const int t = i / P, c = c0 + (i % P) * V;
      const bool in = t0 + t < S && c < W;
      cp_async16(raw + i * V, src + (in ? (size_t)(t0 + t) * W + c : 0),
                 in);
    }
  } else {
    for (int i = lane; i < L * C; i += 32) {
      const int t = i / C, c = c0 + i % C;
      raw[i] = t0 + t < S && c < W ? src[(size_t)(t0 + t) * W + c]
                                   : from_f32<T>(0.f);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(NT, 4)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, T* __restrict__ y, int S,
                      int Di, int vx, int vbc, int vy) {
  using Ly = Lay<N>;
  constexpr int G = Ly::G, NG = Ly::NG, CH = Ly::CH;
  constexpr int VW = G < 4 ? G : 4;      // floats per exchange vector
  // Every warp stages, converts, reads and stores only the L rows of its
  // own run, so those buffers are the warp's alone (__syncwarp); the one
  // block barrier of a chunk is the exchange of the runs' pairs.
  // raw rows in the input type, two stages of dt, x, B, C
  constexpr int RAW = L * (2 * CH + 2 * N);
  __shared__ __align__(16) unsigned char raw_bytes[2][R][RAW * sizeof(T)];
  // the rows the passes read, in f32
  __shared__ __align__(16) float dts[R][L * CH];   // dt
  __shared__ __align__(16) float dxs[R][L * CH];   // dt * x
  __shared__ __align__(16) float bs[R][L * N];
  __shared__ __align__(16) float cs[R][L * N];
  float (*ys)[L * CH] = dts;      // y, once pass 1 has read dt
  // each run's (prod of decays, h) after pass 1, two chunks deep (the
  // last run's is never read): [chunk & 1][run][P | h][state / VW][lane][VW]
  __shared__ __align__(16) float xs[2][R - 1][2][G / VW][32][VW];
  // the state at the end of chunk c, replayed by the last run
  __shared__ __align__(16) float hcs[2][G / VW][32][VW];

  const int tid = threadIdx.x, r = tid >> 5, lane = tid & 31;
  const int ch = lane / NG, g = lane % NG;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + ch;
  const T* xb = x + (size_t)b * S * Di;
  const T* dtb = dt + (size_t)b * S * Di;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;
  T* yb = y + (size_t)b * S * Di;

  float a2[G];                    // A * log2 e; 0 past Di
#pragma unroll
  for (int s = 0; s < G; ++s)
    a2[s] = d < Di ? A[(size_t)d * N + g * G + s] * LOG2E : 0.f;

  auto raw = [&](int st) { return reinterpret_cast<T*>(raw_bytes[st][r]); };
  // this warp's rows of chunk c into stage c & 1
  auto prefetch = [&](int c) {
    const int t0 = c * TC + r * L;
    T* p = raw(c & 1);
    stage<T, CH>(p, dtb, t0, S, Di, d0, vx, lane);
    stage<T, CH>(p + L * CH, xb, t0, S, Di, d0, vx, lane);
    stage<T, N>(p + 2 * L * CH, Bb, t0, S, N, 0, vbc, lane);
    stage<T, N>(p + 2 * L * CH + L * N, Cb, t0, S, N, 0, vbc, lane);
    cp_async_commit();
  };

  const int nc = (S + TC - 1) / TC;
  prefetch(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) prefetch(c + 1);
    else cp_async_commit();       // an empty group keeps the count
    cp_async_wait_prev();         // this thread's copies of chunk c landed
    __syncwarp();                 // ... and every lane's
    {
      const T* p = raw(c & 1);
      for (int i = 4 * lane; i < L * CH; i += 128) {
        const float4 dv = ld4(p + i), xv = ld4(p + L * CH + i);
        *reinterpret_cast<float4*>(dts[r] + i) = dv;
        *reinterpret_cast<float4*>(dxs[r] + i) =
            make_float4(dv.x * xv.x, dv.y * xv.y, dv.z * xv.z, dv.w * xv.w);
      }
      for (int i = 4 * lane; i < L * N; i += 128) {
        *reinterpret_cast<float4*>(bs[r] + i) = ld4(p + 2 * L * CH + i);
        *reinterpret_cast<float4*>(cs[r] + i) =
            ld4(p + 2 * L * CH + L * N + i);
      }
    }
    __syncwarp();

    // pass 1: the run from h = 0, keeping its decays
    float da[L][G], h[G];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float dtv = dts[r][l * CH + ch], dxv = dxs[r][l * CH + ch];
      float bv[G];
      ldv<G>(bv, bs[r] + l * N + g * G);
#pragma unroll
      for (int s = 0; s < G; ++s) {
        da[l][s] = ex2(dtv * a2[s]);
        h[s] = l ? fmaf(da[l][s], h[s], dxv * bv[s]) : dxv * bv[s];
      }
    }
    float (*xo)[2][G / VW][32][VW] = xs[c & 1];
    if (r < R - 1) {
#pragma unroll
      for (int v = 0; v < G / VW; ++v) {
        float p[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          p[e] = da[0][v * VW + e];
#pragma unroll
          for (int l = 1; l < L; ++l) p[e] *= da[l][v * VW + e];
        }
        stv<VW>(xo[r][0][v][lane], p);
        stv<VW>(xo[r][1][v][lane], h + v * VW);
      }
    }
    __syncthreads();              // every run's pair of chunk c is out

    // this run's carry: the chunk's start, folded through the runs before
#pragma unroll
    for (int v = 0; v < G / VW; ++v) {
      if (c == 0) {
#pragma unroll
        for (int e = 0; e < VW; ++e) h[v * VW + e] = 0.f;
      } else {
        float q[VW];
        ldv<VW>(q, hcs[(c - 1) & 1][v][lane]);
#pragma unroll
        for (int e = 0; e < VW; ++e) h[v * VW + e] = q[e];
      }
    }
#pragma unroll
    for (int rr = 0; rr < R - 1; ++rr) {
      if (rr >= r) break;
#pragma unroll
      for (int v = 0; v < G / VW; ++v) {
        float p[VW], q[VW];
        ldv<VW>(p, xo[rr][0][v][lane]);
        ldv<VW>(q, xo[rr][1][v][lane]);
#pragma unroll
        for (int e = 0; e < VW; ++e)
          h[v * VW + e] = fmaf(p[e], h[v * VW + e], q[e]);
      }
    }

    // pass 2: replay the run from its carry with the kept decays
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float dxv = dxs[r][l * CH + ch];
      float bv[G], cv[G];
      ldv<G>(bv, bs[r] + l * N + g * G);
      ldv<G>(cv, cs[r] + l * N + g * G);
      float y2[2] = {0.f, 0.f};
#pragma unroll
      for (int s = 0; s < G; ++s) {
        h[s] = fmaf(da[l][s], h[s], dxv * bv[s]);
        y2[s & 1] = fmaf(h[s], cv[s], y2[s & 1]);
      }
      float yv = y2[0] + y2[1];
#pragma unroll
      for (int off = NG / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (g == 0) ys[r][l * CH + ch] = yv;
    }
    if (r == R - 1) {
#pragma unroll
      for (int v = 0; v < G / VW; ++v) stv<VW>(hcs[c & 1][v][lane], h + v * VW);
    }
    __syncwarp();

    // this warp's rows of y, in x's type
    const int t0 = c * TC + r * L;
    if (vy) {
      constexpr int V = 16 / sizeof(T), P = CH / V;
      for (int i = lane; i < L * P; i += 32) {
        const int t = i / P, cc = (i % P) * V;
        if (t0 + t >= S || d0 + cc >= Di) continue;
        *reinterpret_cast<uint4*>(yb + (size_t)(t0 + t) * Di + d0 + cc) =
            pack16<T>(ys[r] + i * V);
      }
    } else {
      for (int i = lane; i < L * CH; i += 32) {
        const int t = i / CH, cc = i % CH;
        if (t0 + t < S && d0 + cc < Di)
          yb[(size_t)(t0 + t) * Di + d0 + cc] = from_f32<T>(ys[r][i]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int Di,
           cudaStream_t stream) {
  constexpr int CH = Lay<N>::CH;
  const bool rows = (size_t)Di * sizeof(T) % 16 == 0;
  const int vx = rows && aligned16(x) && aligned16(dt);
  const int vbc = N * sizeof(T) % 16 == 0 && aligned16(Bm) && aligned16(Cm);
  const int vy = rows && aligned16(y);
  dim3 grid((Di + CH - 1) / CH, B);
  selective_scan_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, Di, vx, vbc, vy);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, int B, int S, int Di, int N,
             cudaStream_t st) {
  switch (N) {
    case 1: return launch<T, 1>(x, dt, A, Bm, Cm, y, B, S, Di, st);
    case 2: return launch<T, 2>(x, dt, A, Bm, Cm, y, B, S, Di, st);
    case 4: return launch<T, 4>(x, dt, A, Bm, Cm, y, B, S, Di, st);
    case 8: return launch<T, 8>(x, dt, A, Bm, Cm, y, B, S, Di, st);
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, y, B, S, Di, st);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, y, B, S, Di, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (B < 1 || B > 65535 || S < 1 || Di < 1 || N < 1 || N > NMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, Di, N, st)
              : dispatch<float>(x, dt, A, Bm, Cm, y, B, S, Di, N, st);
}
