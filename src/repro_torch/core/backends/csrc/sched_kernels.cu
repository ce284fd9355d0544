// Decision kernels of the device scheduling backend, for Hopper (sm_90a).
//
// Replaces the two TPU dispatches of the JAX package:
//   * sched_wave_kernel  <- src/repro/core/backends/pallas.py:199
//     (_batch_kernel, the per-wave Pallas kernel: one wave of decisions);
//   * sched_plan_kernel  <- src/repro/core/backends/pallas.py:396
//     (_scan_run: lax.scan over waves, fori_loop over slots, vmap over
//     the alpha grid: the whole plan for every alpha in one dispatch).
// Both run one shared __device__ routine, decide(), so they cannot drift.
//
// What bounds it: a schedule is a chain of W*B dependent decisions, each
// a handful of dependent max/add steps per (predecessor, route, hop) over
// P candidate lanes, then an argmin across the lanes and a commit that
// the next decision reads.  It moves few bytes and does few operations;
// its floor is the latency of that chain.  The design answer: one block
// per alpha (the alpha grid is the only independent axis), one thread
// per candidate lane, the lane buffer and the committed state in shared
// memory, and no host round-trip between decisions.
//
// Numerics: float64, bit-identical to the scalar reference.  Built with
// --fmad=false, and every rounding step that the reference takes is an
// explicit __dadd_rn / __dmul_rn / __ddiv_rn; max and select are exact.
//
// Tables (row-major, P = candidate lanes, lane axis last):
//   lid   (P+1, R, H, P) int32   link id of hop h of route r from source s
//                                to lane p; -1 = no link (reads -inf)
//   valid (P+1, R, P)    int32   route exists
//   nhops (P+1, R, P)    int32   hop count (route tie-break)
//   ct    (E+1, P+1, R, H, P) f64  Eq. 15 message time per hop
//   comp, ldet (n, P)    f64     Eq. 1 computation time, Eq. 16 LDET
//                                (exit rows of ldet are 1.0)
// Source plane P and edge row E are the padding predecessor.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SCHED_HMAX 16

struct Tables {
  const int* lid;
  const int* valid;
  const int* nhops;
  const double* ct;
  const double* comp;
  const double* ldet;
  int P, R, H, L;
};

// Shared-memory views of one block's carried state and scratch.
struct State {
  double* lane;    // (P, L) per-candidate tentative link state
  double* lf;      // (L) committed link free times
  double* pf;      // (P) processor free times
  double* loads;   // (P) committed computation per processor
  double* lop;     // (P) loads / period
  double* bp;      // (P) Def. 4.1 balance factor
  double* val;     // (P) selection values, for the argmin
  double* eft;     // (P) EFTs, for the argmin
  int* win;        // (1) winner lane
};

// One decision's outputs.
struct Slot {
  int* win;        // ()
  double* est;     // (P)
  double* eft;     // (P)
  double* ca;      // (P) A_p = EFT * LDET
  double* cb;      // (P) B_p = A_p * loads/period (pre-commit)
  double* lst;     // (K, H, P) selected route's hop LSTs
  double* lft;     // (K, H, P) selected route's hop LFTs
  int* route;      // (K, P) selected route index
};

__device__ __forceinline__ double dmax(double a, double b) {
  return a > b ? a : b;
}

// One decision over all P lanes (thread p owns lane p), then the strict
// (value, EFT, proc) argmin and, for a real slot, the commit.  The sorted
// predecessors arrive as (aft, source processor, edge row) triples.
// Every thread of the block must call it.
__device__ void decide(const Tables& T, int j, int is_exit, int is_real,
                       int K, const double* s_aft, const int* s_src,
                       const int* s_edge, double alpha, double period,
                       State S, Slot O, double* aft_row, int* proc_row) {
  const int P = T.P, R = T.R, H = T.H, L = T.L;
  const int p = threadIdx.x;
  const double NEG = -CUDART_INF;
  const double POS = CUDART_INF;
  if (p < P) {
    double* lane = S.lane + (size_t)p * L;
    for (int l = 0; l < L; ++l) lane[l] = S.lf[l];
    double arrival = NEG;
    for (int k = 0; k < K; ++k) {
      const double aft_i = s_aft[k];
      const int src = s_src[k];
      const int* lid = T.lid + (size_t)src * R * H * P;
      const int* valid = T.valid + (size_t)src * R * P;
      const int* nhops = T.nhops + (size_t)src * R * P;
      const double* ct =
          T.ct + ((size_t)s_edge[k] * (P + 1) + src) * R * H * P;
      // Eqs. 13-14 running maxima per route; lexicographic
      // (LFT, hops, route index) pick per lane
      double best_f = POS;
      int best_nh = 0, best_r = 0;
      for (int r = 0; r < R; ++r) {
        double lst = 0.0, lft = 0.0;
        for (int h = 0; h < H; ++h) {
          const int q = (r * H + h) * P + p;
          const int l = lid[q];
          const double avail = l < 0 ? NEG : lane[l];
          lst = h == 0 ? dmax(avail, aft_i) : dmax(lst, avail);
          const double x = __dadd_rn(lst, ct[q]);
          lft = h == 0 ? x : dmax(lft, x);
        }
        const double fv = valid[r * P + p] ? lft : POS;
        const int nh = nhops[r * P + p];
        if (r == 0 || fv < best_f || (fv == best_f && nh < best_nh)) {
          best_f = fv;
          best_nh = nh;
          best_r = r;
        }
      }
      // the chosen route again: its hop times are outputs, and its LFTs
      // are written back only after every hop has read the lane (a route
      // may revisit a link)
      double sel[SCHED_HMAX];
      double lst = 0.0, lft = 0.0;
      for (int h = 0; h < H; ++h) {
        const int q = (best_r * H + h) * P + p;
        const int l = lid[q];
        const double avail = l < 0 ? NEG : lane[l];
        lst = h == 0 ? dmax(avail, aft_i) : dmax(lst, avail);
        const double x = __dadd_rn(lst, ct[q]);
        lft = h == 0 ? x : dmax(lft, x);
        O.lst[(k * H + h) * P + p] = lst;
        O.lft[(k * H + h) * P + p] = lft;
        sel[h] = lft;
      }
      for (int h = 0; h < H; ++h) {
        const int l = lid[(best_r * H + h) * P + p];
        if (l >= 0) lane[l] = sel[h];
      }
      O.route[k * P + p] = best_r;
      arrival = dmax(arrival, best_f);
    }
    // Eqs. 10-12, Defs. 4.1-4.2
    const double est = dmax(arrival, S.pf[p]);
    const double eft = __dadd_rn(est, T.comp[(size_t)j * P + p]);
    const double a = __dmul_rn(eft, T.ldet[(size_t)j * P + p]);
    const double value = __dmul_rn(a, is_exit ? 1.0 : S.bp[p]);
    O.est[p] = est;
    O.eft[p] = eft;
    O.ca[p] = a;
    O.cb[p] = __dmul_rn(a, S.lop[p]);
    S.val[p] = value;
    S.eft[p] = eft;
  }
  __syncthreads();
  if (p == 0) {
    // strict lexicographic (value, EFT, proc) argmin, first index on ties
    int w = 0;
    for (int q = 1; q < P; ++q) {
      if (S.val[q] < S.val[w] || (S.val[q] == S.val[w] && S.eft[q] < S.eft[w]))
        w = q;
    }
    *O.win = w;
    *S.win = w;
    if (is_real) {
      S.pf[w] = S.eft[w];
      const double ld = __dadd_rn(S.loads[w], T.comp[(size_t)j * P + w]);
      S.loads[w] = ld;
      const double lop = __ddiv_rn(ld, period);
      S.lop[w] = lop;
      S.bp[w] = __dadd_rn(1.0, __dmul_rn(lop, alpha));
      if (aft_row != nullptr) {
        aft_row[j] = S.eft[w];
        proc_row[j] = w;
      }
    }
  }
  __syncthreads();
  if (is_real) {
    // the winner lane's row IS the committed link state: its writes
    // only ever raised a link (LFT >= avail)
    const int w = *S.win;
    for (int l = threadIdx.x; l < L; l += blockDim.x)
      S.lf[l] = S.lane[(size_t)w * L + l];
  }
  __syncthreads();
}

__host__ __device__ inline size_t sched_smem_bytes(int P, int L, int K) {
  return sizeof(double) * ((size_t)P * L + L + 6 * (size_t)P + K) +
         sizeof(int) * (2 * (size_t)K + 1);
}

// Carves the dynamic shared memory; returns the K-slot pred scratch.
__device__ State carve(double* smem, int P, int L, int K, double** s_aft,
                       int** s_src, int** s_edge) {
  State S;
  S.lane = smem;
  S.lf = S.lane + (size_t)P * L;
  S.pf = S.lf + L;
  S.loads = S.pf + P;
  S.lop = S.loads + P;
  S.bp = S.lop + P;
  S.val = S.bp + P;
  S.eft = S.val + P;
  *s_aft = S.eft + P;
  int* ints = reinterpret_cast<int*>(*s_aft + K);
  *s_src = ints;
  *s_edge = ints + K;
  S.win = ints + 2 * K;
  return S;
}

// One block runs one wave's B decisions in order (host-sorted preds).
__global__ void sched_wave_kernel(Tables T, const int* task, const int* real,
                                  const int* exitf, const double* paft,
                                  const int* psrc, const int* pedge,
                                  double alpha, double period, double* lf,
                                  double* pf, double* loads, double* lop,
                                  double* bp, int* win, double* est,
                                  double* eft, double* ca, double* cb,
                                  double* lst, double* lft, int* route, int B,
                                  int K) {
  extern __shared__ double smem[];
  const int P = T.P, H = T.H, L = T.L;
  double* s_aft;
  int *s_src, *s_edge;
  State S = carve(smem, P, L, K, &s_aft, &s_src, &s_edge);
  for (int l = threadIdx.x; l < L; l += blockDim.x) S.lf[l] = lf[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    S.pf[q] = pf[q];
    S.loads[q] = loads[q];
    S.lop[q] = lop[q];
    S.bp[q] = bp[q];
  }
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    Slot O;
    O.win = win + b;
    O.est = est + (size_t)b * P;
    O.eft = eft + (size_t)b * P;
    O.ca = ca + (size_t)b * P;
    O.cb = cb + (size_t)b * P;
    O.lst = lst + (size_t)b * K * H * P;
    O.lft = lft + (size_t)b * K * H * P;
    O.route = route + (size_t)b * K * P;
    decide(T, task[b], exitf[b], real[b], K, paft + (size_t)b * K,
           psrc + (size_t)b * K, pedge + (size_t)b * K, alpha, period, S, O,
           nullptr, nullptr);
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) lf[l] = S.lf[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    pf[q] = S.pf[q];
    loads[q] = S.loads[q];
    lop[q] = S.lop[q];
    bp[q] = S.bp[q];
  }
}

// Persistent kernel: block a runs the whole W x B plan under alphas[a].
// The carried AFT / placement of every task lives in the block's rows of
// aft_s / proc_s (n each); predecessors are insertion-sorted by the
// carried (aft, id) key, as the scalar reference sorts them.
__global__ void sched_plan_kernel(
    Tables T, const int* task, const int* real, const int* exitf,
    const int* pred, const int* pvalid, const int* pedge,
    const double* alphas, double period, const double* lf0,
    const double* pf0, const double* loads0, const double* lop0,
    const double* bp0, const double* aft0, const int* proc0, double* aft_s,
    int* proc_s, int* win, double* est, double* eft, double* ca, double* cb,
    double* lst, double* lft, int* route, double* lf_out, double* pf_out,
    double* loads_out, double* lop_out, double* bp_out, int W, int B, int K,
    int n, int E) {
  extern __shared__ double smem[];
  const int P = T.P, H = T.H, L = T.L;
  const int a = blockIdx.x;
  const double alpha = alphas[a];
  double* aft_row = aft_s + (size_t)a * n;
  int* proc_row = proc_s + (size_t)a * n;
  double* s_aft;
  int *s_src, *s_edge;
  State S = carve(smem, P, L, K, &s_aft, &s_src, &s_edge);
  for (int l = threadIdx.x; l < L; l += blockDim.x) S.lf[l] = lf0[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    S.pf[q] = pf0[q];
    S.loads[q] = loads0[q];
    S.lop[q] = lop0[q];
    S.bp[q] = bp0[q];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    aft_row[t] = aft0[t];
    proc_row[t] = proc0[t];
  }
  __syncthreads();
  const double NEG = -CUDART_INF;
  for (int wv = 0; wv < W; ++wv) {
    for (int b = 0; b < B; ++b) {
      const size_t slot = (size_t)wv * B + b;
      if (threadIdx.x == 0) {
        // insertion sort of the valid predecessors by (aft, id); s_src
        // holds the pred id until the placement replaces it
        int m = 0;
        for (int k = 0; k < K; ++k) {
          if (!pvalid[slot * K + k]) continue;
          const int i = pred[slot * K + k];
          const int e = pedge[slot * K + k];
          const double key = aft_row[i];
          int pos = m;
          while (pos > 0 && (s_aft[pos - 1] > key ||
                             (s_aft[pos - 1] == key && s_src[pos - 1] > i))) {
            s_aft[pos] = s_aft[pos - 1];
            s_src[pos] = s_src[pos - 1];
            s_edge[pos] = s_edge[pos - 1];
            --pos;
          }
          s_aft[pos] = key;
          s_src[pos] = i;
          s_edge[pos] = e;
          ++m;
        }
        for (int k = 0; k < m; ++k) s_src[k] = proc_row[s_src[k]];
        for (int k = m; k < K; ++k) {
          s_aft[k] = NEG;
          s_src[k] = P;
          s_edge[k] = E;
        }
      }
      __syncthreads();
      const size_t o = (size_t)a * W * B + slot;
      Slot O;
      O.win = win + o;
      O.est = est + o * P;
      O.eft = eft + o * P;
      O.ca = ca + o * P;
      O.cb = cb + o * P;
      O.lst = lst + o * K * H * P;
      O.lft = lft + o * K * H * P;
      O.route = route + o * K * P;
      decide(T, task[slot], exitf[slot], real[slot], K, s_aft, s_src, s_edge,
             alpha, period, S, O, aft_row, proc_row);
    }
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x)
    lf_out[(size_t)a * L + l] = S.lf[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    pf_out[(size_t)a * P + q] = S.pf[q];
    loads_out[(size_t)a * P + q] = S.loads[q];
    lop_out[(size_t)a * P + q] = S.lop[q];
    bp_out[(size_t)a * P + q] = S.bp[q];
  }
}

static int sched_threads(int P) {
  const int t = ((P + 31) / 32) * 32;
  return t < 32 ? 32 : t;
}

template <typename Kernel>
static cudaError_t sched_smem_optin(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" {

size_t sched_smem(int P, int L, int K) { return sched_smem_bytes(P, L, K); }

int sched_hmax(void) { return SCHED_HMAX; }

int sched_wave_launch(const int* lid, const int* valid, const int* nhops,
                      const double* ct, const double* comp,
                      const double* ldet, const int* task, const int* real,
                      const int* exitf, const double* paft, const int* psrc,
                      const int* pedge, double alpha, double period,
                      double* lf, double* pf, double* loads, double* lop,
                      double* bp, int* win, double* est, double* eft,
                      double* ca, double* cb, double* lst, double* lft,
                      int* route, int B, int K, int R, int H, int P, int L,
                      void* stream) {
  Tables T = {lid, valid, nhops, ct, comp, ldet, P, R, H, L};
  const size_t smem = sched_smem_bytes(P, L, K);
  cudaError_t err = sched_smem_optin(sched_wave_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sched_wave_kernel<<<1, sched_threads(P), smem, (cudaStream_t)stream>>>(
      T, task, real, exitf, paft, psrc, pedge, alpha, period, lf, pf, loads,
      lop, bp, win, est, eft, ca, cb, lst, lft, route, B, K);
  return (int)cudaGetLastError();
}

int sched_plan_launch(const int* lid, const int* valid, const int* nhops,
                      const double* ct, const double* comp,
                      const double* ldet, const int* task, const int* real,
                      const int* exitf, const int* pred, const int* pvalid,
                      const int* pedge, const double* alphas, double period,
                      const double* lf0, const double* pf0,
                      const double* loads0, const double* lop0,
                      const double* bp0, const double* aft0, const int* proc0,
                      double* aft_s, int* proc_s, int* win, double* est,
                      double* eft, double* ca, double* cb, double* lst,
                      double* lft, int* route, double* lf_out, double* pf_out,
                      double* loads_out, double* lop_out, double* bp_out,
                      int A, int W, int B, int K, int R, int H, int P, int L,
                      int n, int E, void* stream) {
  Tables T = {lid, valid, nhops, ct, comp, ldet, P, R, H, L};
  const size_t smem = sched_smem_bytes(P, L, K);
  cudaError_t err = sched_smem_optin(sched_plan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sched_plan_kernel<<<A, sched_threads(P), smem, (cudaStream_t)stream>>>(
      T, task, real, exitf, pred, pvalid, pedge, alphas, period, lf0, pf0,
      loads0, lop0, bp0, aft0, proc0, aft_s, proc_s, win, est, eft, ca, cb,
      lst, lft, route, lf_out, pf_out, loads_out, lop_out, bp_out, W, B, K,
      n, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
