// Causal or full GQA attention forward on Hopper (sm_90a): two kernels
// behind one launch function, chosen by the input's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (launched by flash_attention_kernel).  Same algebra:
// scores q.k / sqrt(d) in f32, an online softmax with a running max m, a
// running sum l and an f32 output accumulator, masked scores at
// NEG_INF = -1e30, output acc / max(l, 1e-30) in q's type.  Query head h
// reads kv head h / (Hq / Hkv); kv tiles above the diagonal are skipped
// when causal, and the heaviest query tiles are scheduled first.
//
// What bounds it on the card: at the widths the repo configures (S = 4096,
// d = 64..128) attention does about S/2 (causal) multiply-adds per byte
// it must move, so it is bounded by operations, not bytes.
//
// bf16: flash_attention_wgmma_kernel, on the tensor cores.
//   * one block of three warpgroups per (query tile of BM = 128 rows, q
//     head, b): warpgroups 0 and 1 each own 64 query rows and compute,
//     warpgroup 2 is the producer; setmaxnreg moves registers from the
//     producer (24) to the consumers (240);
//   * one producer thread loads Q once and K, V tiles of BN = 64 keys
//     with TMA (cp.async.bulk.tensor, 3-D
//     maps (d, S, B*H) so a ragged tile reads zeros and never the next
//     head's rows) into rings of ST = 2 stages, K and V each with their
//     own mbarrier full / empty pair per stage, so a K stage is refilled
//     once its Q.K^T is done;
//   * rows are cut into 64-column boxes of 128 bytes, TMA's 128-byte
//     swizzle; d = 80 and 96 fill their second box with TMA's zeros, and
//     Q.K^T runs only d / 16 k-steps, so the zeros cost no tensor work;
//   * S = Q.K^T is wgmma m64n{BN}k16 from shared memory (both K-major) into
//     f32 registers; the scale is applied after the product, folded with
//     log2(e) into ex2; the mask is applied on S's register layout on
//     the tiles that need it (ragged last tile, diagonal tile);
//   * P is split in registers into a bf16 high part p_hi = bf16(p) and a
//     bf16 residual p_lo = bf16(p - p_hi) (the subtraction is exact), and
//     O += P.V issues two register-A wgmma m64n{d}k16 a k-step, p_hi.V
//     and p_lo.V, into the same f32 accumulators, with V as B in its
//     stored key-major layout (wgmma's transpose bit).  P's relative error
//     drops from 2^-9 (P rounded to bf16) to about 2^-17, so the products
//     match the plain version's f32 P.V from bf16 V, as the TPU kernel's
//     do; P never touches shared memory.  The two parts are written over
//     the f32 scores they come from, the eight scores of a k-step
//     becoming p_hi's four registers then p_lo's four, so each operand
//     is an aligned quad of S's registers and P.V holds no register
//     array beyond S and O;
//   * the two consumer warpgroups take turns on the tensor cores (named
//     barriers 1 and 2, FlashAttention-3's ping-pong): in its turn a
//     warpgroup issues P.V of tile i-1, then Q.K^T of tile i, and hands
//     the turn over; it runs tile i's softmax while the other one's
//     products run.  P.V and Q.K^T are never in flight together: with
//     both, ptxas serialises every wgmma at d = 96 and 128 ("insufficient
//     register resources", C7512).  BN = 64 keeps S or P and O (BN / 2 +
//     d / 2 registers) small enough for the turn; tiles of 128 keys at
//     d <= 80 serialised the 16 wgmma of P's two parts (C7512) and ran
//     10-17 % slower than 64;
//   * l is summed from the f32 P per thread and reduced over the quad
//     once at the end; O is divided and stored from registers, rows >= S
//     skipped.
// f32: flash_attention_kernel, on the CUDA cores (TF32 keeps about three
// digits and would miss the 1e-5 tolerance of the f32 path), bounded by
// the FP32 FMA rate (128 a clock an SM).  What keeps the FMA pipe fed:
//   * occupancy: one block of 8 warps (256 threads) per (query tile of
//     FQ = 128 rows, q head, b), one block an SM (216 KB of shared memory
//     at d = 128, up to 255 registers a thread), so 8 warps an SM, two on
//     each scheduler; each warp owns 16 query rows for the whole tile, so
//     every reduction over a row stays inside the warp;
//   * register tiles: a thread owns 4 rows (tr + 4 i, tr = lane / 8) of
//     its warp's rows, 8 keys (tc + 8 u, tc = lane % 8) of each kv tile of
//     FK = 64 keys and d / 8 output columns.  S = Q.K^T reads Q and K
//     along d as LDS.128 (4 of Q, 8 of K per 4 d: 128 FMAs, 10.7 an LDS)
//     from rows padded to d + 4 floats, so the 4 (Q) and 8 (K) rows a
//     warp reads at once fall in distinct banks; O += P.V reads P along
//     the keys (LDS.128) and V rows as LDS.128 (LDS.64 at d = 80), 8
//     lanes on one contiguous row (20 loads: 256 FMAs at d = 128);
//   * K and V tiles stream in with cp.async (16 bytes, zero-filled past S;
//     4 bytes where a pointer is not 16-byte aligned) into two stages:
//     the loads of tile i + 1 are issued right after the one block
//     barrier of tile i and land while tile i is computed;
//   * the softmax stays in registers: the row max and sum are reduced
//     over the 8 lanes of a row with three shuffles; the sum l is kept
//     per lane and reduced once at the end; P goes to a warp-private
//     buffer in shared memory only as the operand of P.V, in two halves
//     of 32 keys (__syncwarp around each), which is what keeps the block
//     under 227 KB;
//   * exponent: p = ex2((s - m) * log2 e) with ex2.approx: the score s
//     (q pre-scaled by 1 / sqrt(d), as the plain version does) and the
//     max m are subtracted before the scaling, so the rounding of the
//     product stays relative to s - m and not to s (with q, k x 8 the
//     scores reach several hundred, and scaling first would leave an
//     exponent error near ulp(430) ~ 3e-5, against the 1e-5 tolerance);
//   * causal: a warp skips a kv tile whose keys all lie above its rows
//     (half the work of the second diagonal tile), and masks only the
//     tiles that cross its diagonal or the ragged end.
// The S x S scores never reach device memory.  The kernels allocate
// nothing and launch on the caller's stream.  The tensor maps are encoded
// on the host in the launch function through the driver entry point
// that the runtime hands out (cudaGetDriverEntryPoint), so the library
// does not link libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- f32 path

constexpr int FW = 8;             // warps per block
constexpr int FNT = 32 * FW;      // threads per block
constexpr int FQ = 16 * FW;       // query rows per block: 16 a warp
constexpr int FK = 64;            // keys per kv tile
constexpr int PH = 32;            // keys per half of a warp's P buffer
constexpr int PS = PH + 8;        // row stride of the P buffer (floats)

// the f32 kernel's shared-memory layout and output chunks at head dim D
template <int D>
struct FTile {
  static constexpr int DS = D + 4;                      // q, k row stride
  static constexpr int CW = (D / 4) % 8 == 0 ? 4 : 2;   // floats per chunk
  static constexpr int JC = D / (8 * CW);               // chunks per lane
  static constexpr int QF = FQ * DS;                    // floats of q
  static constexpr int KF = FK * DS;                    // of a k stage
  static constexpr int VF = FK * D;                     // of a v stage
  static constexpr int PF = FW * 16 * PS;               // of the P buffers
  static constexpr size_t BYTES = sizeof(float) * (QF + 2 * KF + 2 * VF + PF);
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// CW consecutive floats of shared memory into registers (LDS.128 or .64)
template <int CW>
__device__ __forceinline__ void lds(float (&r)[CW], const float* p) {
  if constexpr (CW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  }
}

// the K and V rows k0 .. k0 + FK - 1 into one stage; rows >= S read zeros
template <int D>
__device__ __forceinline__ void load_kv(float* ks, float* vs,
                                        const float* kb, const float* vb,
                                        int k0, int S, int tid, bool vec) {
  constexpr int DS = FTile<D>::DS;
  if (vec) {
    constexpr int C4 = D / 4;
#pragma unroll
    for (int it = 0; it < FK * C4 / FNT; ++it) {
      const int i = tid + it * FNT, r = i / C4, c = (i % C4) * 4;
      const bool in = k0 + r < S;
      const size_t g = (size_t)(in ? k0 + r : 0) * D + c;
      cp_async16(smem_u32(ks + r * DS + c), kb + g, in);
      cp_async16(smem_u32(vs + r * D + c), vb + g, in);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < FK * D / FNT; ++it) {
      const int i = tid + it * FNT, r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const size_t g = (size_t)(in ? k0 + r : 0) * D + c;
      cp_async4(smem_u32(ks + r * DS + c), kb + g, in);
      cp_async4(smem_u32(vs + r * D + c), vb + g, in);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FNT, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int B, int Hq, int Hkv, int S, int causal, float scale,
                       int vec) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using F = FTile<D>;
  constexpr int DS = F::DS, CW = F::CW, JC = F::JC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks0 = qs + F::QF;        // two stages of K
  float* vs0 = ks0 + 2 * F::KF;   // two stages of V
  float* ps = vs0 + 2 * F::VF;    // a P buffer per warp

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int tr = lane >> 3, tc = lane & 7;
  // block -> (query tile, b, h), the heaviest query tiles first
  const int nq = (S + FQ - 1) / FQ;
  const int bh = blockIdx.x % (B * Hq);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (B * Hq))) * FQ;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const float* qb = q + ((size_t)b * Hq + h) * S * D;
  const float* kb = k + ((size_t)b * Hkv + kvh) * S * D;
  const float* vb = v + ((size_t)b * Hkv + kvh) * S * D;
  float* ob = o + ((size_t)b * Hq + h) * S * D;

  const int kend = causal ? min(S, q0 + FQ) : S;
  const int nkv = (kend + FK - 1) / FK;
  load_kv<D>(ks0, vs0, kb, vb, 0, S, tid, vec);
  cp_async_commit();
  // the q tile, pre-scaled, while the first K/V tile lands
  for (int i = tid; i < FQ * D / 4; i += FNT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      const float* src = qb + (size_t)(q0 + r) * D + c;
      x = vec ? *reinterpret_cast<const float4*>(src)
              : make_float4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<float4*>(qs + r * DS + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  const int rw0 = q0 + 16 * w;    // the warp's first row
  const float* qw = qs + (16 * w + tr) * DS;
  float* pw = ps + w * 16 * PS;
  float acc[4][JC * CW];
  float m[4], l[4];               // l: this lane's part of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JC * CW; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < nkv; ++t) {
    cp_async_wait_all();
    __syncthreads();              // tile t landed; tile t - 1 is consumed
    if (t + 1 < nkv) {
      load_kv<D>(ks0 + ((t + 1) & 1) * F::KF, vs0 + ((t + 1) & 1) * F::VF,
                 kb, vb, (t + 1) * FK, S, tid, vec);
      cp_async_commit();
    }
    const int k0 = t * FK;
    // warp-uniform: no real row, or every key above the warp's rows
    if (rw0 >= S || (causal && k0 > rw0 + 15)) continue;
    const float* ks = ks0 + (t & 1) * F::KF + tc * DS;
    const float* vs = vs0 + (t & 1) * F::VF + tc * CW;

    // S = Q.K^T: rows tr + 4 i, keys tc + 8 u, summed over d in order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) s[i][u] = 0.f;
#pragma unroll 4
    for (int kq = 0; kq < D; kq += 4) {
      float qf[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<4>(qf[i], qw + 4 * i * DS + kq);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float kf[4];
        lds<4>(kf, ks + 8 * u * DS + kq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][u] = fmaf(qf[i][e], kf[e], s[i][u]);
      }
    }
    if (k0 + FK > S || (causal && k0 + FK - 1 > rw0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int key = k0 + tc + 8 * u;
          if (key >= S || (causal && key > rw0 + tr + 4 * i))
            s[i][u] = NEG_INF;
        }
    }

    // online softmax in registers; subtract, then scale by log2 e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int u = 1; u < 8; ++u) mx = fmaxf(mx, s[i][u]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = ex2((m[i] - mn) * LOG2E);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s[i][u] = ex2((s[i][u] - mn) * LOG2E);
        sum += s[i][u];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < JC * CW; ++j) acc[i][j] *= alpha;
    }

    // O += P.V, one half of the keys at a time through the P buffer
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      __syncwarp();               // the last reads of the buffer are done
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pw[(tr + 4 * i) * PS + tc + 8 * u] = s[i][4 * hf + u];
      __syncwarp();
      const float* vh = vs + hf * PH * D;
#pragma unroll
      for (int kq = 0; kq < PH; kq += 4) {
        float pf[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          lds<4>(pf[i], pw + (tr + 4 * i) * PS + kq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int jc = 0; jc < JC; ++jc) {
            float vv[CW];
            lds<CW>(vv, vh + (kq + e) * D + jc * 8 * CW);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int x = 0; x < CW; ++x)
                acc[i][jc * CW + x] =
                    fmaf(pf[i][e], vv[x], acc[i][jc * CW + x]);
          }
        }
      }
    }
  }

  // l over the 8 lanes of a row, then O / l from registers
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = rw0 + tr + 4 * i;
    if (row >= S) continue;
    li = fmaxf(li, 1e-30f);
    float* orow = ob + (size_t)row * D + tc * CW;
#pragma unroll
    for (int jc = 0; jc < JC; ++jc) {
      const float* a = acc[i] + jc * CW;
      if constexpr (CW == 4)
        *reinterpret_cast<float4*>(orow + jc * 8 * CW) =
            make_float4(a[0] / li, a[1] / li, a[2] / li, a[3] / li);
      else
        *reinterpret_cast<float2*>(orow + jc * 8 * CW) =
            make_float2(a[0] / li, a[1] / li);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int causal, cudaStream_t stream) {
  const size_t smem = FTile<D>::BYTES;
  auto kern = flash_attention_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((S + FQ - 1) / FQ) * B * Hq;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int vec = aligned16(q) && aligned16(k) && aligned16(v);
  kern<<<(unsigned)blocks, FNT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, Hq, Hkv, S,
      causal, scale, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int S, int D, int causal, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 80: return launch<80>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 96: return launch<96>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------- bf16 tensor-core path
constexpr int BM = 128;           // query rows per block: 2 x 64
constexpr int BN = 64;            // keys per kv tile
constexpr int ST = 2;             // stages of the K/V ring
constexpr int NTW = 384;          // 2 consumer warpgroups + 1 producer
constexpr int BOX = 128;          // bytes of one swizzled row box (64 bf16)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// nanoseconds of the GPU's global timer
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// the longest an mbarrier wait may take: far longer than any load, or
// any time slice another process takes on the card
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

// returns once the phase of parity `parity` of the barrier has completed;
// a wait that outlasts WAIT_LIMIT_NS by the global timer traps, so a lost
// arrival is a launch error and not a hung card.  The timer is read once
// every 1024 failed polls: a wait that ends sooner never reads it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;                 // the time of the first timer read
  for (uint32_t polls = 1;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 1024 != 0) continue;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > WAIT_LIMIT_NS) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// lbo/sbo in bytes: K-major tiles use sbo = 8 rows x 128 B (lbo unused);
// the MN-major V tile uses lbo = the stride between 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups of the warpgroup are in
// flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins a register at this point of the program: a read of an accumulator
// after it sees the value the finished wgmma wrote, and a register that
// an in-flight wgmma reads is not reused before it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// named barriers 1.. of the two consumer warpgroups (256 threads):
// warpgroup w waits on its turn, the other one hands it over
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// the pair (x0, x1) of f32 as two packed bf16 pairs: the high part
// bf16(x) and the residual bf16(x - bf16(x)); x - bf16(x) is exact in f32
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// d (+)= A . B, m64nNk16, bf16 in, f32 accumulators.  Accumulator i of a
// thread (lane l of warp w of the warpgroup) holds row 16 w + l / 4
// (+ 8 when i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2.  The
// family is generated below for N = 64, 80, 96, 128: FA_ACC_N is the
// asm list of the N / 2 accumulators, FA_D_N(c) their operands with
// constraint c: FA_SET ("=f") where the instruction overwrites d (scale-d
// 0, the first k-step, so no uninitialised register is read), FA_ADD
// ("+f") where it adds to d (scale-d 1).
#define FA_ACC_64                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define FA_ACC_80 FA_ACC_64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define FA_ACC_96 FA_ACC_80 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define FA_ACC_128                                                       \
  FA_ACC_96 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, " \
  "%59, %60, %61, %62, %63"
#define FA_D8(c, i)                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),        \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define FA_D_64(c) FA_D8(c, 0), FA_D8(c, 8), FA_D8(c, 16), FA_D8(c, 24)
#define FA_D_80(c) FA_D_64(c), FA_D8(c, 32)
#define FA_D_96(c) FA_D_80(c), FA_D8(c, 40)
#define FA_D_128(c) FA_D_96(c), FA_D8(c, 48), FA_D8(c, 56)
#define FA_SET(x) "=f"(x)
#define FA_ADD(x) "+f"(x)

// NAME(d, da, db): d (+)= A . B, both from shared memory, K-major;
// OPS names the asm operands of da and db
#define FA_WGMMA_SS(NAME, N, CONS, SCALE_D, OPS)                        \
  __device__ __forceinline__ void NAME(float(&d)[N / 2], uint64_t da,   \
                                       uint64_t db) {                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " #SCALE_D ", 0;\n"  \
                 "wgmma.mma_async.sync.aligned.m64n" #N                 \
                 "k16.f32.bf16.bf16 {" FA_ACC_##N "}, " OPS             \
                 ", p, 1, 1, 0, 0;\n}\n"                                \
                 : FA_D_##N(CONS)                                       \
                 : "l"(da), "l"(db));                                   \
  }
FA_WGMMA_SS(wgmma_ss_n64_zero, 64, FA_SET, 0, "%32, %33")
FA_WGMMA_SS(wgmma_ss_n64, 64, FA_ADD, 1, "%32, %33")

// d += A . B with A (64 x 16 bf16) in registers, B MN-major in shared
// memory (transpose bit set), m64nNk16; OPS names the asm operands of A's
// four registers and db
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
#define FA_WGMMA_RS(N, OPS)                                               \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_rs<N>(                            \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t db) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"               \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k16.f32.bf16.bf16 {" FA_ACC_##N "}, " OPS               \
                 ", p, 1, 1, 1;\n}\n"                                     \
                 : FA_D_##N(FA_ADD)                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));  \
  }
FA_WGMMA_RS(64, "{%32, %33, %34, %35}, %36")
FA_WGMMA_RS(80, "{%40, %41, %42, %43}, %44")
FA_WGMMA_RS(96, "{%48, %49, %50, %51}, %52")
FA_WGMMA_RS(128, "{%64, %65, %66, %67}, %68")

template <int D>
constexpr int wgmma_smem_bytes() {
  // 1 KB of alignment slack, Q (BM rows), ST stages of K and V (BN rows),
  // each row cut into (D + 63) / 64 boxes of 128 bytes, then 1 + 4 ST
  // mbarriers
  return 1024 + ((D + 63) / 64) * BOX * (BM + 2 * ST * BN) + 8 * (1 + 4 * ST);
}

// S = Q . K^T for one warpgroup's 64 rows and one kv tile: d / 16
// k-steps of 32 bytes inside the 128-byte boxes, both operands K-major
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t qa,
                                         uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;          // inside the box
    const uint64_t da = sw128_desc(qa + (kk / 4) * BM * BOX + off, 16, 8 * BOX);
    const uint64_t db = sw128_desc(kt + (kk / 4) * BN * BOX + off, 16, 8 * BOX);
    if (kk == 0) wgmma_ss_n64_zero(sc, da, db);
    else wgmma_ss_n64(sc, da, db);
  }
}

// O += P . V: V's BN x D tile is the MN-major B operand, its 64-column
// boxes BN * 128 bytes apart.  ps holds P as rescale_and_split left it:
// k-step kk adds p_hi . V (registers 8 kk .. 8 kk + 3) and p_lo . V
// (registers 8 kk + 4 .. 8 kk + 7)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const float (&ps)[BN / 2],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = sw128_desc(vt + kk * 16 * BOX, BN * BOX, 8 * BOX);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      hi[f] = __float_as_uint(ps[8 * kk + f]);
      lo[f] = __float_as_uint(ps[8 * kk + 4 + f]);
    }
    wgmma_rs<D>(acc, hi, db);
    wgmma_rs<D>(acc, lo, db);
  }
}

// The softmax of one tile on S's register layout, in the log2 domain:
// masks (when `edge`), updates the running maxima m0, m1 of rows r0 and
// r0 + 8, overwrites sc with P = 2^(s - m) in f32, adds P's row sums to
// the thread's partial l0, l1, and returns the factors al0, al1 that
// rescale the accumulator rows to the new maxima.
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], bool edge,
                                             int k0, int r0, int cq, int S,
                                             int causal, float scale_log2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& al0,
                                             float& al1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * j + cq + (e & 1);
        const int row = e < 2 ? r0 : r0 + 8;
        if (key >= S || (causal && key > row)) x = NEG_INF;
      }
      sc[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = ex2(sc[4 * j + e] - (e < 2 ? mn0 : mn1));
      sc[4 * j + e] = pv;
      if (e < 2) rs0 += pv;
      else rs1 += pv;
    }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}

// rescales the accumulator rows, then splits P in place into the
// register A fragments of P . V.  Fragment register f of k-step kk packs
// the pair of S accumulators 8 kk + 2 f, 8 kk + 2 f + 1 (rows r0, r0 + 8
// x keys 16 kk .. 16 kk + 15 over the four f): the pair's p_hi goes to
// register 8 kk + f and its p_lo to register 8 kk + 4 + f
template <int D>
__device__ __forceinline__ void rescale_and_split(float (&acc)[D / 2],
                                                  float al0, float al1,
                                                  float (&sc)[BN / 2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= al0;
    acc[4 * j + 1] *= al0;
    acc[4 * j + 2] *= al1;
    acc[4 * j + 3] *= al1;
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], hi[f], lo[f]);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      sc[8 * kk + f] = __uint_as_float(hi[f]);
      sc[8 * kk + 4 + f] = __uint_as_float(lo[f]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTW, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int B, int Hq,
                             int Hkv, int S, int causal, float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "head dim: a multiple of 16, <= 128");
  constexpr int NC = (D + 63) / 64;      // 128-byte boxes per row
  constexpr int STAGE = NC * BN * BOX;   // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;     // swizzle atoms: 1 KB
  const uint32_t ks = qs + NC * BM * BOX;
  const uint32_t vs = ks + ST * STAGE;
  const uint32_t bars = vs + ST * STAGE;
  // the barriers: Q full; per stage K full, V full, K empty, V empty
  const uint32_t q_full = bars;
  auto bar = [&](int kind, int s) { return bars + 8 * (1 + kind * ST + s); };
  enum { K_FULL, V_FULL, K_EMPTY, V_EMPTY };

  // heaviest query tiles first, over every (b, head)
  const int n_qt = (S + BM - 1) / BM;
  const int bhq = blockIdx.x % (B * Hq);
  const int qt = n_qt - 1 - blockIdx.x / (B * Hq);
  const int h = bhq % Hq, b = bhq / Hq;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * BM;
  const int n_all = (S + BN - 1) / BN;
  const int n_kv = causal ? min(n_all, (q0 + BM - 1) / BN + 1) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), 2 * 128);   // every consumer thread
      mbar_init(bar(V_EMPTY, s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, NC * BM * BOX);
      for (int c = 0; c < NC; ++c)
        tma_load_3d(qs + c * BM * BOX, &tq, q_full, 64 * c, q0, b * Hq + h);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % ST;
        const uint32_t ph = ((i / ST) - 1) & 1;    // of the stage's release
        if (i >= ST) mbar_wait(bar(K_EMPTY, s), ph);
        mbar_expect_tx(bar(K_FULL, s), STAGE);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(ks + s * STAGE + c * BN * BOX, &tk, bar(K_FULL, s),
                      64 * c, i * BN, bhk);
        if (i >= ST) mbar_wait(bar(V_EMPTY, s), ph);
        mbar_expect_tx(bar(V_FULL, s), STAGE);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(vs + s * STAGE + c * BN * BOX, &tv, bar(V_FULL, s),
                      64 * c, i * BN, bhk);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.  The two warpgroups
    // take turns on the tensor cores (named barriers 1 and 2): one issues
    // its P.V of tile i-1 and Q.K^T of tile i while the other runs its
    // softmax, so the exps and the products overlap.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;   // and r0 + 8
    const int cq = 2 * (lane % 4);
    const uint32_t qa = qs + wg * 64 * BOX;
    const int qmin = q0 + wg * 64;        // the warpgroup's first row
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, al0, al1;
    float sc[BN / 2];
    // turn w is barrier 1 + w: warpgroup w syncs on it, the other one
    // arrives; warpgroup 0 goes first, and warpgroup 1 does not arrive
    // after its last turn, so every arrival is consumed
    if (wg == 1) named_arrive(1);
    mbar_wait(q_full, 0);

    // turn 0: S = Q . K^T of tile 0
    mbar_wait(bar(K_FULL, 0), 0);
    named_sync(1 + wg);
    wgmma_fence();
    issue_qk<D>(sc, qa, ks);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    pin(sc);
    mbar_arrive(bar(K_EMPTY, 0));
    softmax_tile(sc, BN > S || (causal && BN - 1 > qmin), 0, r0, cq, S,
                 causal, scale_log2, m0, m1, l0, l1, al0, al1);
    rescale_and_split<D>(acc, al0, al1, sc);

    // turn i: O += P . V of tile i-1, then S = Q . K^T of tile i
    for (int i = 1; i < n_kv; ++i) {
      const int sp = (i - 1) % ST, s = i % ST;
      mbar_wait(bar(V_FULL, sp), ((i - 1) / ST) & 1);
      mbar_wait(bar(K_FULL, s), (i / ST) & 1);
      named_sync(1 + wg);
      pin(acc);
      pin(sc);
      wgmma_fence();
      issue_pv<D>(acc, sc, vs + sp * STAGE);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(sc);
      issue_qk<D>(sc, qa, ks + s * STAGE);
      wgmma_commit();
      named_arrive(2 - wg);
      mbar_arrive(bar(V_EMPTY, sp));
      wgmma_wait<0>();
      pin(sc);
      mbar_arrive(bar(K_EMPTY, s));
      const int k0 = i * BN;
      softmax_tile(sc, k0 + BN > S || (causal && k0 + BN - 1 > qmin), k0,
                   r0, cq, S, causal, scale_log2, m0, m1, l0, l1, al0, al1);
      rescale_and_split<D>(acc, al0, al1, sc);
    }

    // last turn: O += P . V of the last tile
    const int sl = (n_kv - 1) % ST;
    mbar_wait(bar(V_FULL, sl), ((n_kv - 1) / ST) & 1);
    named_sync(1 + wg);
    pin(acc);
    pin(sc);
    wgmma_fence();
    issue_pv<D>(acc, sc, vs + sl * STAGE);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(sc);
    if (wg == 0) named_arrive(2);
    mbar_arrive(bar(V_EMPTY, sl));

#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + ((size_t)b * Hq + h) * S * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + cq;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + c) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(r0 + 8) * D + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (B*H, S, D) tensor as a 3-D map (D, S, B*H) read in boxes of 64
// columns x `rows` rows, 128-byte swizzle, zeros outside the tensor
bool encode_map(CUtensorMap* map, const void* ptr, int D, int S, int BH,
                int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int S, int causal, cudaStream_t stream) {
  // the runtime call first: it makes the device's primary context current
  // on the calling thread, which the driver's tensor-map encode needs (a
  // thread that has made no runtime call yet has none)
  const int smem = wgmma_smem_bytes<D>();
  auto kern = flash_attention_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, D, S, B * Hq, BM) ||
      !encode_map(&tk, k, D, S, B * Hkv, BN) ||
      !encode_map(&tv, v, D, S, B * Hkv, BN))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((S + BM - 1) / BM) * Hq * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  kern<<<(unsigned)blocks, NTW, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, Hq, Hkv, S, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int S, int D, int causal,
                   cudaStream_t st) {
  switch (D) {
    case 64: return launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 80: return launch_wgmma<80>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 96: return launch_wgmma<96>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    case 128: return launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, S, D), o like q; all contiguous, of
// one type.  bf16 != 0: __nv_bfloat16, 16-byte aligned, through the
// tensor-core kernel; else float, through the CUDA-core kernel.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int bf16, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 || S < 1 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_wgmma(q, k, v, o, B, Hq, Hkv, S, D, causal, st)
              : dispatch(q, k, v, o, B, Hq, Hkv, S, D, causal, st);
}
