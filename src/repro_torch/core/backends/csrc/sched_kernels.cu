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
// its floor is the latency of that chain.  The design keeps every load
// of a decision on chip and out of that chain:
//   * one block per alpha (the alpha grid is the only independent axis),
//     one thread per candidate lane (two past 512 lanes, in kernels of
//     their own): the decisions run on one warp when P <= 32, and the
//     block's other warps help only with the prologue;
//   * a wave prologue: no task of a wave has a predecessor in the same
//     wave (engine.plan_waves), so every predecessor's AFT and placement
//     are known when the wave starts.  The block then sorts each slot's
//     predecessors (one slot per thread) and gathers, with cp.async, all
//     in flight together, the rows each slot's decision reads into shared
//     memory: per predecessor the route tables of its processor (lid,
//     valid, nhops) and the CT rows of its edge, and the comp / LDET rows
//     of the slot's task.  A wave whose rows exceed shared memory is
//     staged in chunks of C slots (C = 1 at the least).  The plan kernel
//     prefetches the next chunk's task-only inputs (task, pred, edge)
//     while the current chunk decides, and keeps the carried AFT /
//     placement rows in shared memory where they fit (ROWS_SMEM_MAX on
//     the host), else in global memory;
//   * a decision reads shared memory and registers only.  Routes of up to
//     SCHED_HFIXED hops take a walk compiled for their hop count (loops
//     and guards over a run-time count lengthen the chain: each kernel is
//     instantiated per hop count), with a route's loads issued together
//     and the chosen route kept in registers; longer routes, and every
//     route past 512 lanes, go through per-route scratch.  The chosen route is never walked again.  The
//     strict (value, EFT, proc) argmin is a __shfl_xor_sync butterfly over
//     the value and a ballot of its ties (then over the EFT when several
//     tie): the serial loop's answer, first index on ties; block-wide
//     through shared memory when P > 32.  Every lane computes its
//     would-be commit, so the winner only stores;
//   * only the winner lane's EST / EFT / LST / LFT / routes are written;
//     the A / B coefficients of every lane are written, coalesced, since
//     the crossing bounds read them.
//
// Numerics: every kernel is instantiated over its real type F.  F =
// double is bit-identical to the scalar reference; F = float is the
// reference's TPU numerics (its near-tie policy: the same algebra with
// every step rounded to float32).  Built with --fmad=false, and every
// rounding step that the reference takes is an explicit radd / rmul /
// rdiv, which are __dadd_rn / __dmul_rn / __ddiv_rn in double and
// __fadd_rn / __fmul_rn / __fdiv_rn in float; max and select are exact.
// In float a chunk of staged slots, and the carried rows that fit the
// block's shared memory, hold about twice as many as in double.
//
// Tables (row-major, P = candidate lanes, lane axis last):
//   lid   (P+1, R, H, P) int32   link id of hop h of route r from source s
//                                to lane p; -1 = no link (reads -inf)
//   valid (P+1, R, P)    int32   route exists
//   nhops (P+1, R, P)    int32   hop count (route tie-break)
//   ct    (E+1, P+1, R, H, P) F  Eq. 15 message time per hop
//   comp, ldet (n, P)    F       Eq. 1 computation time, Eq. 16 LDET
//                                (exit rows of ldet are 1.0)
// Source plane P and edge row E are the padding predecessor.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// threads a block at most: 128 registers a thread, so that no kernel
// spills.  Past 512 candidate lanes a decision thread takes lanes p,
// p + 512, ... (P <= 1024 on the host: two at most)
#define SCHED_MAX_THREADS 512
// one such block an SM at the least: without it ptxas holds the float
// instantiations of the generic walk to 64 registers (two blocks of 512
// threads an SM) and spills
#define SCHED_MIN_BLOCKS 1
// threads a block at least: the decisions run on the first ceil(P / 32)
// warps, the wave prologue on all of them (its copies are bounded by
// how many a warp keeps in flight)
#define SCHED_MIN_THREADS 128
// Routes of up to SCHED_HFIXED hops take a walk compiled for their exact
// hop count: a route's link ids, CT values and flags are loaded into
// registers together, and the chosen route stays in registers.  Longer
// routes go HB hops at a time through per-route scratch (hl / hf).
#define SCHED_HFIXED 2
#define HB 2

// whether a launch walks routes through the scratch (longer routes, and
// every route past SCHED_MAX_THREADS lanes: the kernels instantiated for
// two lanes a thread take the generic walk only)
__host__ __device__ inline bool long_walk(int P, int H) {
  return H > SCHED_HFIXED || P > SCHED_MAX_THREADS;
}

// ---- the rounding steps of the reference, one per IEEE operation
__device__ __forceinline__ double radd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float radd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double rmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rdiv(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float rdiv(float a, float b) {
  return __fdiv_rn(a, b);
}

// +inf in the real type
template <typename F>
__device__ __forceinline__ F inf_of();
template <>
__device__ __forceinline__ double inf_of<double>() {
  return CUDART_INF;
}
template <>
__device__ __forceinline__ float inf_of<float>() {
  return CUDART_INF_F;
}

// The instance tables in global memory, gathered by the prologue.
template <typename F>
struct Tables {
  const int* lid;
  const int* valid;
  const int* nhops;
  const F* ct;
  const F* comp;
  const F* ldet;
  int P, R, H, L;
};

// Byte offsets into one block's dynamic shared memory; reals first.
struct Layout {
  size_t lane, lf, pf, loads, lop, bp, hl, hf, sl, sf, red_v, red_e;
  size_t m_val, m_eft, m_est;
  size_t c_aft, c_ct, c_comp, c_ldet, aft;
  size_t route, red_i, c_src, c_edge, c_lid, c_valid, c_nhops, abuf, proc;
  int a_ints;           // ints of one task-only prefetch buffer
  size_t bytes;
};

__host__ __device__ inline size_t take(size_t* at, size_t bytes) {
  const size_t o = *at;
  *at += bytes;
  return o;
}

// C = slots staged at once; rows = carried AFT / placement rows in
// shared memory (n, or 0); D = bytes of the real type (8 or 4).
__host__ __device__ inline Layout sched_layout(int P, int L, int K, int R,
                                               int H, int C, int rows,
                                               size_t D) {
  const size_t I = sizeof(int);
  const size_t RHP = (size_t)R * H * P;
  Layout y;
  size_t o = 0;
  y.lane = take(&o, D * P * (L + 1));   // row stride L + 1: no bank conflict
  y.lf = take(&o, D * L);
  y.pf = take(&o, D * P);
  y.loads = take(&o, D * P);
  y.lop = take(&o, D * P);
  y.bp = take(&o, D * P);
  y.hl = take(&o, long_walk(P, H) ? D * K * RHP : 0);
  y.hf = take(&o, long_walk(P, H) ? D * K * RHP : 0);
  y.sl = take(&o, D * K * H * P);
  y.sf = take(&o, D * K * H * P);
  y.red_v = take(&o, D * 32);
  y.red_e = take(&o, D * 32);
  const size_t M = P > SCHED_MAX_THREADS ? D * P : 0;   // two lanes a thread
  y.m_val = take(&o, M);
  y.m_eft = take(&o, M);
  y.m_est = take(&o, M);
  y.c_aft = take(&o, D * C * K);
  y.c_ct = take(&o, D * C * K * RHP);
  y.c_comp = take(&o, D * C * P);
  y.c_ldet = take(&o, D * C * P);
  y.aft = take(&o, D * rows);
  y.route = take(&o, I * K * P);
  y.red_i = take(&o, I * 32);
  y.c_src = take(&o, I * C * K);
  y.c_edge = take(&o, I * C * K);
  y.c_lid = take(&o, I * C * K * RHP);
  y.c_valid = take(&o, I * C * K * R * P);
  y.c_nhops = take(&o, I * C * K * R * P);
  y.a_ints = 3 * C + 3 * C * K;
  y.abuf = take(&o, I * 2 * y.a_ints);
  y.proc = take(&o, I * rows);
  y.bytes = o;
  return y;
}

// The block's carried state and per-decision scratch.
template <typename F>
struct State {
  F* lane;         // (P, L+1) per-candidate tentative link state
  F* lf;           // (L) committed link free times
  F* pf;           // (P) processor free times
  F* loads;        // (P) committed computation per processor
  F* lop;          // (P) loads / period
  F* bp;           // (P) Def. 4.1 balance factor
  F* hl;           // (K, R, H, P) every route's hop LSTs, long routes
  F* hf;           // (K, R, H, P) every route's hop LFTs, long routes
  F* sl;           // (K, H, P) the chosen routes' hop LSTs
  F* sf;           // (K, H, P) the chosen routes' hop LFTs
  int* route;      // (K, P) chosen route per predecessor
  F* red_v;        // (32) per-warp argmin partials, P > 32
  F* red_e;
  int* red_i;
  F* m_val;        // (P) every lane's value, EFT and EST, P > 512
  F* m_eft;
  F* m_est;
};

// One staged chunk of slots.
template <typename F>
struct Stage {
  F* aft;          // (C, K) sorted predecessor AFTs
  int* src;        // (C, K) their processors
  int* edge;       // (C, K) their edge rows
  F* ct;           // (C, K, R, H, P) their CT rows
  int* lid;        // (C, K, R, H, P) their processors' link ids
  int* valid;      // (C, K, R, P) ... route exists
  int* nhops;      // (C, K, R, P) ... hop counts
  F* comp;         // (C, P) comp row of each slot's task
  F* ldet;         // (C, P) LDET row of each slot's task
  int* abuf;       // 2 x (task, real, exitf (C); pred, pvalid, pedge (C, K))
};

template <typename F>
__device__ inline State<F> carve_state(unsigned char* s, const Layout& y) {
  State<F> S;
  S.lane = reinterpret_cast<F*>(s + y.lane);
  S.lf = reinterpret_cast<F*>(s + y.lf);
  S.pf = reinterpret_cast<F*>(s + y.pf);
  S.loads = reinterpret_cast<F*>(s + y.loads);
  S.lop = reinterpret_cast<F*>(s + y.lop);
  S.bp = reinterpret_cast<F*>(s + y.bp);
  S.hl = reinterpret_cast<F*>(s + y.hl);
  S.hf = reinterpret_cast<F*>(s + y.hf);
  S.sl = reinterpret_cast<F*>(s + y.sl);
  S.sf = reinterpret_cast<F*>(s + y.sf);
  S.route = reinterpret_cast<int*>(s + y.route);
  S.red_v = reinterpret_cast<F*>(s + y.red_v);
  S.red_e = reinterpret_cast<F*>(s + y.red_e);
  S.red_i = reinterpret_cast<int*>(s + y.red_i);
  S.m_val = reinterpret_cast<F*>(s + y.m_val);
  S.m_eft = reinterpret_cast<F*>(s + y.m_eft);
  S.m_est = reinterpret_cast<F*>(s + y.m_est);
  return S;
}

template <typename F>
__device__ inline Stage<F> carve_stage(unsigned char* s, const Layout& y) {
  Stage<F> G;
  G.aft = reinterpret_cast<F*>(s + y.c_aft);
  G.src = reinterpret_cast<int*>(s + y.c_src);
  G.edge = reinterpret_cast<int*>(s + y.c_edge);
  G.ct = reinterpret_cast<F*>(s + y.c_ct);
  G.lid = reinterpret_cast<int*>(s + y.c_lid);
  G.valid = reinterpret_cast<int*>(s + y.c_valid);
  G.nhops = reinterpret_cast<int*>(s + y.c_nhops);
  G.comp = reinterpret_cast<F*>(s + y.c_comp);
  G.ldet = reinterpret_cast<F*>(s + y.c_ldet);
  G.abuf = reinterpret_cast<int*>(s + y.abuf);
  return G;
}

// One decision's outputs: winner lane only, A / B for every lane.
template <typename F>
struct Slot {
  int* win;        // ()
  F* est;          // ()
  F* eft;          // ()
  F* ca;           // (P) A_p = EFT * LDET
  F* cb;           // (P) B_p = A_p * loads/period (pre-commit)
  F* lst;          // (K, H) selected route's hop LSTs
  F* lft;          // (K, H) selected route's hop LFTs
  int* route;      // (K) selected route index
};

template <typename F>
__device__ __forceinline__ F rmax(F a, F b) {
  return a > b ? a : b;
}

// ---- cp.async: copies in flight together, completion by group
// (no memory clobber on the copies, so that the loads around them are
// not held back; cp_wait and a barrier order their results)
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// one real: 8 bytes in double, 4 in float
template <typename F>
__device__ __forceinline__ void cp_real(F* dst, const F* src) {
  if constexpr (sizeof(F) == 8)
    cp8(dst, src);
  else
    cp4(dst, src);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the newest groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the decision threads' barrier: the warp, or named barrier 1 over the
// ceil(P / 32) decision warps (at most SCHED_MAX_THREADS / 32)
__host__ __device__ __forceinline__ int decision_threads(int P) {
  const int t = ((P + 31) / 32) * 32;
  return t < SCHED_MAX_THREADS ? t : SCHED_MAX_THREADS;
}

__device__ __forceinline__ void bar(int nd) {
  if (nd == 32)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;\n" ::"r"(nd) : "memory");
}

// strict lexicographic (value, EFT, lane) order
template <typename F>
__device__ __forceinline__ bool key_less(F v, F e, int i, F v0, F e0,
                                         int i0) {
  return v < v0 || (v == v0 && (e < e0 || (e == e0 && i < i0)));
}

// every lane of the warp ends with the warp's least (value, EFT, lane) key
template <typename F>
__device__ __forceinline__ void warp_argmin(F& v, F& e, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const F v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const F e2 = __shfl_xor_sync(0xffffffffu, e, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    if (key_less(v2, e2, i2, v, e, i)) {
      v = v2;
      e = e2;
      i = i2;
    }
  }
}

// One decision's staged inputs.
template <typename F>
struct Staged {
  int j, is_exit, is_real;
  const F* aft;         // (K) sorted predecessor AFTs
  const int* lid;       // (K, R, H, P)
  const int* valid;     // (K, R, P)
  const int* nhops;     // (K, R, P)
  const F* ct;          // (K, R, H, P)
  const F* comp;        // (P)
  const F* ldet;        // (P)
};

template <typename F>
__device__ inline Staged<F> staged(const Stage<F>& G, const int* A, int t,
                                   int C, int K, int R, int H, int P) {
  const size_t kr = (size_t)t * K * R, krh = kr * H;
  return Staged<F>{A[t],          A[2 * C + t],  A[C + t],
                   G.aft + t * K, G.lid + krh * P, G.valid + kr * P,
                   G.nhops + kr * P, G.ct + krh * P, G.comp + t * P,
                   G.ldet + t * P};
}

// The staged rows of route r of predecessor k, hops h0 .. h0 + HB - 1,
// for lane p, loaded together.
template <typename F>
struct RouteRows {
  int l[HB];
  F c[HB];
  int ok, nh;
};

template <typename F>
__device__ __forceinline__ void load_route(const Staged<F>& D, int k, int r,
                                           int h0, int R, int H, int P,
                                           int p, RouteRows<F>& x) {
  const size_t kr = (size_t)k * R + r;
#pragma unroll
  for (int i = 0; i < HB; ++i) {
    const size_t q = (kr * H + h0 + i) * P + p;
    x.l[i] = h0 + i < H ? D.lid[q] : -1;
    x.c[i] = h0 + i < H ? D.ct[q] : F(0);
  }
  x.ok = D.valid[kr * P + p];
  x.nh = D.nhops[kr * P + p];
}

// Eqs. 13-14 along HB hops from (lst, lft), reading the lane; h0 = 0
// starts a route at the predecessor's AFT (walk_long).
template <typename F>
__device__ __forceinline__ void run_hops(const RouteRows<F>& x, const F* lane,
                                         F aft_i, int h0, int H, F& lst,
                                         F& lft, F* lo, F* hi) {
  const F NEG = -inf_of<F>();
  F av[HB];
#pragma unroll
  for (int i = 0; i < HB; ++i) av[i] = x.l[i] < 0 ? NEG : lane[x.l[i]];
#pragma unroll
  for (int i = 0; i < HB; ++i) {
    const int h = h0 + i;
    if (h < H) {
      lst = h == 0 ? rmax(av[i], aft_i) : rmax(lst, av[i]);
      const F x_ = radd(lst, x.c[i]);
      lft = h == 0 ? x_ : rmax(lft, x_);
    }
    lo[i] = lst;
    hi[i] = lft;
  }
}

// lexicographic (LFT, hops, route index) pick of route r
template <typename F>
__device__ __forceinline__ bool better(int r, F fv, int nh, F best_f,
                                       int best_nh) {
  return r == 0 || fv < best_f || (fv == best_f && nh < best_nh);
}

// Route r of predecessor k (kr = k * R + r) for lane p along its HT hops:
// the link ids into l, the running maxima of Eqs. 13-14 into lo (LST)
// and hi (LFT); returns whether the route exists.
template <typename F, int HT>
__device__ __forceinline__ int route_hops(const Staged<F>& D, int kr, int P,
                                          int p, const F* lane, F aft_i,
                                          int* l, F* lo, F* hi) {
  const F NEG = -inf_of<F>();
  F c[HT], av[HT];
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    l[h] = D.lid[(kr * HT + h) * P + p];
    c[h] = D.ct[(kr * HT + h) * P + p];
  }
  const int ok = D.valid[kr * P + p];
#pragma unroll
  for (int h = 0; h < HT; ++h) av[h] = l[h] < 0 ? NEG : lane[l[h]];
  lo[0] = rmax(av[0], aft_i);
  hi[0] = radd(lo[0], c[0]);
#pragma unroll
  for (int h = 1; h < HT; ++h) {
    lo[h] = rmax(lo[h - 1], av[h]);
    hi[h] = rmax(hi[h - 1], radd(lo[h], c[h]));
  }
  return ok;
}

// Every predecessor of lane p in order: the running maxima along every
// route, the lexicographic (LFT, hops, route index) pick, the chosen
// route's hop LSTs / LFTs into sl / sf and its LFTs written back into
// the lane after every hop has read it (a route may revisit a link).
// Returns the arrival (max chosen LFT).  HT = H, known when compiled: no
// loop or guard on the hops; with one route there is nothing to pick.
template <typename F, int HT>
__device__ __forceinline__ F walk_fixed(const Staged<F>& D, int K, int R,
                                        int P, int p, F* lane,
                                        const State<F>& S) {
  const F NEG = -inf_of<F>();
  const F POS = inf_of<F>();
  F arrival = NEG;
  for (int k = 0; k < K; ++k) {
    const F aft_i = D.aft[k];
    int l[HT];
    F lo[HT], hi[HT];
    const int ok =
        route_hops<F, HT>(D, k * R, P, p, lane, aft_i, l, lo, hi);
    F best_f = ok ? hi[HT - 1] : POS;
    int best_r = 0;
    if (R > 1) {
      int best_nh = D.nhops[k * R * P + p];
      for (int r = 1; r < R; ++r) {
        int l2[HT];
        F lo2[HT], hi2[HT];
        const int ok2 = route_hops<F, HT>(D, k * R + r, P, p, lane, aft_i,
                                          l2, lo2, hi2);
        const F fv = ok2 ? hi2[HT - 1] : POS;
        const int nh = D.nhops[(k * R + r) * P + p];
        if (better(r, fv, nh, best_f, best_nh)) {
          best_f = fv;
          best_nh = nh;
          best_r = r;
#pragma unroll
          for (int h = 0; h < HT; ++h) {
            l[h] = l2[h];
            lo[h] = lo2[h];
            hi[h] = hi2[h];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      S.sl[(k * HT + h) * P + p] = lo[h];
      S.sf[(k * HT + h) * P + p] = hi[h];
      if (l[h] >= 0) lane[l[h]] = hi[h];
    }
    S.route[k * P + p] = best_r;
    arrival = rmax(arrival, best_f);
  }
  return arrival;
}

// The same for routes longer than SCHED_HFIXED hops, and for any route in
// the kernels for two lanes a thread: HB hops at a time, each route's hop
// times through the scratch hl / hf.  The loops stay rolled: unrolled,
// the two-lane kernels spill.
template <typename F>
__device__ __forceinline__ F walk_long(const Staged<F>& D, int K, int R,
                                       int H, int P, int p, F* lane,
                                       const State<F>& S) {
  const F NEG = -inf_of<F>();
  const F POS = inf_of<F>();
  F arrival = NEG;
  RouteRows<F> x;
  const int RHP = R * H * P;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const F aft_i = D.aft[k];
    F* hl = S.hl + (size_t)k * RHP;
    F* hf = S.hf + (size_t)k * RHP;
    F best_f = POS;
    int best_nh = 0, best_r = 0;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      F lst = F(0), lft = F(0);
#pragma unroll 1
      for (int h0 = 0; h0 < H; h0 += HB) {
        F lo[HB], hi[HB];
        load_route(D, k, r, h0, R, H, P, p, x);
        run_hops(x, lane, aft_i, h0, H, lst, lft, lo, hi);
#pragma unroll
        for (int i = 0; i < HB; ++i) {
          if (h0 + i < H) {
            hl[(r * H + h0 + i) * P + p] = lo[i];
            hf[(r * H + h0 + i) * P + p] = hi[i];
          }
        }
      }
      const F fv = x.ok ? lft : POS;
      if (better(r, fv, x.nh, best_f, best_nh)) {
        best_f = fv;
        best_nh = x.nh;
        best_r = r;
      }
    }
#pragma unroll 1
    for (int h0 = 0; h0 < H; h0 += HB) {
      load_route(D, k, best_r, h0, R, H, P, p, x);
      F lo[HB], hi[HB];
#pragma unroll
      for (int i = 0; i < HB; ++i) {
        const int q = (best_r * H + h0 + i) * P + p;
        lo[i] = h0 + i < H ? hl[q] : F(0);
        hi[i] = h0 + i < H ? hf[q] : F(0);
      }
#pragma unroll
      for (int i = 0; i < HB; ++i) {
        if (h0 + i < H) {
          S.sl[(k * H + h0 + i) * P + p] = lo[i];
          S.sf[(k * H + h0 + i) * P + p] = hi[i];
          if (x.l[i] >= 0) lane[x.l[i]] = hi[i];
        }
      }
    }
    S.route[k * P + p] = best_r;
    arrival = rmax(arrival, best_f);
  }
  return arrival;
}

// HT = H (1 .. SCHED_HFIXED) or 0 for the generic walk: each kernel is
// compiled once per HT, so that registers are allocated for one walk,
// and once more (HT = 0) for two lanes a thread.
template <typename F, int HT>
__device__ __forceinline__ F walk_preds(const Staged<F>& D, int K, int R,
                                        int H, int P, int p, F* lane,
                                        const State<F>& S) {
  if constexpr (HT > 0)
    return walk_fixed<F, HT>(D, K, R, P, p, lane, S);
  else
    return walk_long(D, K, R, H, P, p, lane, S);
}

// Lane q's candidate (Eqs. 10-12, Defs. 4.1-4.2) on its own copy of the
// committed link state: its A / B coefficients into O.ca / O.cb, its
// value, EFT and EST returned; returns its computation time.
template <typename F, int HT>
__device__ __forceinline__ F candidate(const Staged<F>& D, int K, int R,
                                       int H, int P, int L, int q,
                                       const State<F>& S, const Slot<F>& O,
                                       F& value, F& eft, F& est) {
  F* lane = S.lane + (size_t)q * (L + 1);
  for (int l0 = 0; l0 < L; l0 += 8) {
    F x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (l0 + i < L) x[i] = S.lf[l0 + i];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (l0 + i < L) lane[l0 + i] = x[i];
  }
  const F arrival = walk_preds<F, HT>(D, K, R, H, P, q, lane, S);
  est = rmax(arrival, S.pf[q]);
  const F comp_q = D.comp[q];
  eft = radd(est, comp_q);
  const F a = rmul(eft, D.ldet[q]);
  value = rmul(a, D.is_exit ? F(1) : S.bp[q]);
  O.ca[q] = a;
  O.cb[q] = rmul(a, S.lop[q]);
  return comp_q;
}

// One decision over all P lanes (thread p owns lane p; WIDE, P > 512:
// also lane p + 512), then the strict (value, EFT, proc) argmin and, for
// a real slot, the commit by the winner lane's thread.  Every decision
// thread (threadIdx.x < decision_threads) must call it, and no other.
template <typename F, int HT, bool WIDE>
__device__ __forceinline__ void decide(const Tables<F>& T,
                                       const Staged<F>& D, int K, F alpha,
                                       F period, const State<F>& S,
                                       const Slot<F>& O, F* aft_row,
                                       int* proc_row) {
  const int P = T.P, R = T.R, H = T.H, L = T.L;
  const int p = threadIdx.x;
  const int nd = decision_threads(P);
  const F POS = inf_of<F>();
  // the thread's best lane (WIDE: by the strict (value, EFT, lane)
  // order), its value, EFT and EST, and its commit, were it to win: every
  // lane's is computed, so that the division overlaps the argmin
  int q_best = 0x7fffffff;
  F value = POS, eft = POS, est = POS;
  F c_ld = F(0), c_lop = F(0), c_bp = F(0);
  if constexpr (!WIDE) {
    if (p < P) {
      const F comp_p =
          candidate<F, HT>(D, K, R, H, P, L, p, S, O, value, eft, est);
      if (D.is_real) {
        c_ld = radd(S.loads[p], comp_p);
        c_lop = rdiv(c_ld, period);
        c_bp = radd(F(1), rmul(c_lop, alpha));
      }
    }
  } else {
    // each lane's outcome through shared memory, so that no register
    // is held across a walk
    for (int q = p; q < P; q += nd) {
      F v, e, t;
      candidate<F, HT>(D, K, R, H, P, L, q, S, O, v, e, t);
      S.m_val[q] = v;
      S.m_eft[q] = e;
      S.m_est[q] = t;
    }
    for (int q = p; q < P; q += nd) {
      const F v = S.m_val[q], e = S.m_eft[q];
      if (q == p || key_less(v, e, q, value, eft, q_best)) {
        value = v;
        eft = e;
        est = S.m_est[q];
        q_best = q;
      }
    }
    if (D.is_real) {
      c_ld = radd(S.loads[q_best], D.comp[q_best]);
      c_lop = rdiv(c_ld, period);
      c_bp = radd(F(1), rmul(c_lop, alpha));
    }
  }
  const unsigned FULL = 0xffffffffu;
  const int lane_id = p & 31;
  F vmin = value, e = eft;
  int w = q_best;
  if constexpr (!WIDE) {
    // one lane a thread: the least value, then among its ties the least
    // EFT, then the first lane (a ballot); lanes past P never tie
    for (int off = 16; off > 0; off >>= 1) {
      const F o = __shfl_xor_sync(FULL, vmin, off);
      vmin = o < vmin ? o : vmin;
    }
    unsigned tie = __ballot_sync(FULL, p < P && value == vmin);
    if (__popc(tie) > 1) {
      F emin = (tie >> lane_id) & 1u ? eft : POS;
      for (int off = 16; off > 0; off >>= 1) {
        const F o = __shfl_xor_sync(FULL, emin, off);
        emin = o < emin ? o : emin;
      }
      tie = __ballot_sync(FULL, ((tie >> lane_id) & 1u) && eft == emin);
    }
    w = (p - lane_id) + __ffs(tie) - 1;
  } else {
    warp_argmin(vmin, e, w);    // the threads' best lanes
  }
  if (nd == 32) {
    __syncwarp();
  } else {
    // the warps' winners, then the least (value, EFT, lane) key of them
    if constexpr (!WIDE) e = __shfl_sync(FULL, eft, w & 31);
    if (lane_id == 0) {
      S.red_v[p >> 5] = vmin;
      S.red_e[p >> 5] = e;
      S.red_i[p >> 5] = w;
    }
    bar(nd);
    const int nw = nd >> 5;
    vmin = lane_id < nw ? S.red_v[lane_id] : POS;
    e = lane_id < nw ? S.red_e[lane_id] : POS;
    w = lane_id < nw ? S.red_i[lane_id] : 0x7fffffff;
    warp_argmin(vmin, e, w);
  }
  if ((WIDE ? q_best : p) == w) {
    *O.win = w;
    *O.est = est;
    *O.eft = eft;
    if (D.is_real) {
      S.pf[w] = eft;
      S.loads[w] = c_ld;
      S.lop[w] = c_lop;
      S.bp[w] = c_bp;
      if (aft_row != nullptr) {
        aft_row[D.j] = eft;
        proc_row[D.j] = w;
      }
    }
  }
  // the winner lane's hop times and routes
  for (int t = p; t < K * H; t += nd) {
    O.lst[t] = S.sl[t * P + w];
    O.lft[t] = S.sf[t * P + w];
  }
  for (int k = p; k < K; k += nd) O.route[k] = S.route[k * P + w];
  if (D.is_real) {
    // the winner lane's row IS the committed link state: its writes
    // only ever raised a link (LFT >= avail)
    for (int l = p; l < L; l += nd) S.lf[l] = S.lane[w * (L + 1) + l];
  }
  bar(nd);
}

// The rows of the staged (slot, predecessor) pairs (CT rows of the edge,
// route tables of the source processor) and the comp / LDET rows of the
// staged tasks: independent copies, all in flight, spread over every
// thread of the block.  Element i = (row, column) of a gather stepped by
// blockDim.x: the row and column advance without a division.
struct Walk {
  int row, col, drow, dcol, width;
  __device__ explicit Walk(int width_) : width(width_) {
    row = threadIdx.x / width;
    col = threadIdx.x - row * width;
    drow = blockDim.x / width;
    dcol = blockDim.x - drow * width;
  }
  __device__ void step() {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

template <typename F>
__device__ void gather_rows(const Tables<F>& T, const Stage<F>& G,
                            const int* task, int cn, int K) {
  const int P = T.P, RP = T.R * P, RHP = RP * T.H;
  Walk a(P);
  for (int i = threadIdx.x; i < cn * P; i += blockDim.x, a.step()) {
    const size_t row = (size_t)task[a.row] * P + a.col;
    cp_real(G.comp + i, T.comp + row);
    cp_real(G.ldet + i, T.ldet + row);
  }
  Walk b(RHP);
  for (int i = threadIdx.x; i < cn * K * RHP; i += blockDim.x, b.step()) {
    const int src = G.src[b.row];
    const size_t row = (size_t)G.edge[b.row] * (P + 1) + src;
    cp_real(G.ct + i, T.ct + row * RHP + b.col);
    cp4(G.lid + i, T.lid + (size_t)src * RHP + b.col);
  }
  Walk c(RP);
  for (int i = threadIdx.x; i < cn * K * RP; i += blockDim.x, c.step()) {
    const size_t row = (size_t)G.src[c.row] * RP + c.col;
    cp4(G.valid + i, T.valid + row);
    cp4(G.nhops + i, T.nhops + row);
  }
}

template <typename F>
__device__ inline Slot<F> slot_out(int* win, F* est, F* eft, F* ca, F* cb,
                                   F* lst, F* lft, int* route, size_t o,
                                   int P, int K, int H) {
  Slot<F> O;
  O.win = win + o;
  O.est = est + o;
  O.eft = eft + o;
  O.ca = ca + o * P;
  O.cb = cb + o * P;
  O.lst = lst + o * K * H;
  O.lft = lft + o * K * H;
  O.route = route + o * K;
  return O;
}

// One block runs one wave's B decisions in order (host-sorted preds),
// staged C slots at a time; the state is read from *_in, written to the
// other five arrays.
template <typename F, int HT, bool WIDE>
__global__ void __launch_bounds__(SCHED_MAX_THREADS, SCHED_MIN_BLOCKS)
    sched_wave_kernel(
    Tables<F> T, const int* task, const int* real, const int* exitf,
    const F* paft, const int* psrc, const int* pedge, F alpha, F period,
    const F* lf_in, const F* pf_in, const F* loads_in, const F* lop_in,
    const F* bp_in, F* lf, F* pf, F* loads, F* lop, F* bp, int* win, F* est,
    F* eft, F* ca, F* cb, F* lst, F* lft, int* route, int B, int K, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = T.P, H = T.H, L = T.L;
  const Layout y = sched_layout(P, L, K, T.R, H, C, 0, sizeof(F));
  const State<F> S = carve_state<F>(smem, y);
  const Stage<F> G = carve_stage<F>(smem, y);
  for (int l = threadIdx.x; l < L; l += blockDim.x) S.lf[l] = lf_in[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    S.pf[q] = pf_in[q];
    S.loads[q] = loads_in[q];
    S.lop[q] = lop_in[q];
    S.bp[q] = bp_in[q];
  }
  int* A = G.abuf;
  for (int c0 = 0; c0 < B; c0 += C) {
    const int cn = min(C, B - c0);
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      cp4(A + i, task + c0 + i);
      cp4(A + C + i, real + c0 + i);
      cp4(A + 2 * C + i, exitf + c0 + i);
    }
    for (int i = threadIdx.x; i < cn * K; i += blockDim.x) {
      const size_t g = (size_t)c0 * K + i;
      cp_real(G.aft + i, paft + g);
      cp4(G.src + i, psrc + g);
      cp4(G.edge + i, pedge + g);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    gather_rows(T, G, A, cn, K);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (threadIdx.x < decision_threads(P))
      for (int t = 0; t < cn; ++t)
        decide<F, HT, WIDE>(
            T, staged(G, A, t, C, K, T.R, H, P), K, alpha, period, S,
            slot_out(win, est, eft, ca, cb, lst, lft, route, c0 + t, P, K,
                     H),
            nullptr, nullptr);
    __syncthreads();
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) lf[l] = S.lf[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    pf[q] = S.pf[q];
    loads[q] = S.loads[q];
    lop[q] = S.lop[q];
    bp[q] = S.bp[q];
  }
}

// The task-only inputs of C slots from slot s0 (cn of them) into one
// prefetch buffer: task, real, exitf (C), pred, pvalid, pedge (C, K).
__device__ void prefetch_slots(int* A, const int* task, const int* real,
                               const int* exitf, const int* pred,
                               const int* pvalid, const int* pedge,
                               size_t s0, int cn, int C, int K) {
  for (int i = threadIdx.x; i < cn; i += blockDim.x) {
    cp4(A + i, task + s0 + i);
    cp4(A + C + i, real + s0 + i);
    cp4(A + 2 * C + i, exitf + s0 + i);
  }
  int* a_pred = A + 3 * C;
  for (int i = threadIdx.x; i < cn * K; i += blockDim.x) {
    const size_t g = s0 * K + i;
    cp4(a_pred + i, pred + g);
    cp4(a_pred + C * K + i, pvalid + g);
    cp4(a_pred + 2 * C * K + i, pedge + g);
  }
}

// Persistent kernel: block a runs the whole W x B plan under alphas[a].
// The carried AFT / placement of every task lives in shared memory when
// rows = n (written to the block's rows of aft_s / proc_s at the end),
// else in those rows directly; predecessors are insertion-sorted by the
// carried (aft, id) key, as the scalar reference sorts them.
template <typename F, int HT, bool WIDE>
__global__ void __launch_bounds__(SCHED_MAX_THREADS, SCHED_MIN_BLOCKS)
    sched_plan_kernel(
    Tables<F> T, const int* task, const int* real, const int* exitf,
    const int* pred, const int* pvalid, const int* pedge, const F* alphas,
    F period, const F* lf0, const F* pf0, const F* loads0, const F* lop0,
    const F* bp0, const F* aft0, const int* proc0, F* aft_s, int* proc_s,
    int* win, F* est, F* eft, F* ca, F* cb, F* lst, F* lft, int* route,
    F* lf_out, F* pf_out, F* loads_out, F* lop_out, F* bp_out, int W, int B,
    int K, int n, int E, int C, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = T.P, H = T.H, L = T.L;
  const int a = blockIdx.x;
  const F alpha = alphas[a];
  const Layout y = sched_layout(P, L, K, T.R, H, C, rows, sizeof(F));
  const State<F> S = carve_state<F>(smem, y);
  const Stage<F> G = carve_stage<F>(smem, y);
  F* aft_row = rows ? reinterpret_cast<F*>(smem + y.aft)
                    : aft_s + (size_t)a * n;
  int* proc_row = rows ? reinterpret_cast<int*>(smem + y.proc)
                       : proc_s + (size_t)a * n;
  for (int l = threadIdx.x; l < L; l += blockDim.x) S.lf[l] = lf0[l];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    S.pf[q] = pf0[q];
    S.loads[q] = loads0[q];
    S.lop[q] = lop0[q];
    S.bp[q] = bp0[q];
  }
  if (rows) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      cp_real(aft_row + t, aft0 + t);
      cp4(proc_row + t, proc0 + t);
    }
  } else {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      aft_row[t] = aft0[t];
      proc_row[t] = proc0[t];
    }
  }
  const int NC = (B + C - 1) / C;    // chunks per wave
  prefetch_slots(G.abuf, task, real, exitf, pred, pvalid, pedge, 0,
                 min(C, B), C, K);
  cp_commit();     // with the carried rows, when they are on chip
  const F NEG = -inf_of<F>();
  for (int ci = 0; ci < W * NC; ++ci) {
    const int wv = ci / NC, c0 = (ci - wv * NC) * C;
    const int cn = min(C, B - c0);
    const size_t s0 = (size_t)wv * B + c0;
    int* A = G.abuf + (ci & 1) * y.a_ints;
    const int* a_pred = A + 3 * C;
    const int* a_pvalid = a_pred + C * K;
    const int* a_pedge = a_pred + 2 * C * K;
    cp_wait<0>();     // this chunk's task-only inputs
    __syncthreads();
    // insertion sort of each slot's valid predecessors by (aft, id), one
    // slot per thread; src holds the pred id until the placement
    // replaces it
    for (int t = threadIdx.x; t < cn; t += blockDim.x) {
      F* s_aft = G.aft + t * K;
      int* s_src = G.src + t * K;
      int* s_edge = G.edge + t * K;
      int m = 0;
      for (int k = 0; k < K; ++k) {
        if (!a_pvalid[t * K + k]) continue;
        const int i = a_pred[t * K + k];
        const int e = a_pedge[t * K + k];
        const F key = aft_row[i];
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
    gather_rows(T, G, A, cn, K);
    cp_commit();
    // the next chunk's task-only inputs land while this chunk decides
    if (ci + 1 < W * NC) {
      const int wn = (ci + 1) / NC, cn0 = (ci + 1 - wn * NC) * C;
      prefetch_slots(G.abuf + ((ci + 1) & 1) * y.a_ints, task, real, exitf,
                     pred, pvalid, pedge, (size_t)wn * B + cn0,
                     min(C, B - cn0), C, K);
    }
    cp_commit();
    cp_wait<1>();     // the gathered rows
    __syncthreads();
    if (threadIdx.x < decision_threads(P))
      for (int t = 0; t < cn; ++t)
        decide<F, HT, WIDE>(
            T, staged(G, A, t, C, K, T.R, H, P), K, alpha, period, S,
            slot_out(win, est, eft, ca, cb, lst, lft, route,
                     (size_t)a * W * B + s0 + t, P, K, H),
            aft_row, proc_row);
  }
  __syncthreads();
  if (rows) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      aft_s[(size_t)a * n + t] = aft_row[t];
      proc_s[(size_t)a * n + t] = proc_row[t];
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
  const int t = decision_threads(P);
  return t < SCHED_MIN_THREADS ? SCHED_MIN_THREADS : t;
}

template <typename Kernel>
static cudaError_t sched_smem_optin(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// the instantiation of a kernel for routes of H hops
template <template <typename, int, bool> class Pick, typename F, bool WIDE>
static auto for_hops(int H) {
  static_assert(SCHED_HFIXED == 2, "one case per compiled hop count");
  switch (H) {
    case 1: return Pick<F, 1, WIDE>::kernel;
    case 2: return Pick<F, 2, WIDE>::kernel;
    default: return Pick<F, 0, WIDE>::kernel;
  }
}

// ... and for P lanes: past SCHED_MAX_THREADS, two a thread, on the
// generic walk
template <template <typename, int, bool> class Pick, typename F>
static auto pick_kernel(int H, int P) {
  return P > SCHED_MAX_THREADS ? Pick<F, 0, true>::kernel
                               : for_hops<Pick, F, false>(H);
}

template <typename F, int HT, bool WIDE>
struct WaveKernel {
  static constexpr auto kernel = &sched_wave_kernel<F, HT, WIDE>;
};

template <typename F, int HT, bool WIDE>
struct PlanKernel {
  static constexpr auto kernel = &sched_plan_kernel<F, HT, WIDE>;
};

// One launch of either kernel in the real type F (the extern "C" entry
// points below: sched_*_launch in double, sched_*_launch_f32 in float).
template <typename F>
static int wave_launch(const int* lid, const int* valid, const int* nhops,
                       const F* ct, const F* comp, const F* ldet,
                       const int* task, const int* real, const int* exitf,
                       const F* paft, const int* psrc, const int* pedge,
                       F alpha, F period, const F* lf_in, const F* pf_in,
                       const F* loads_in, const F* lop_in, const F* bp_in,
                       F* lf, F* pf, F* loads, F* lop, F* bp, int* win,
                       F* est, F* eft, F* ca, F* cb, F* lst, F* lft,
                       int* route, int B, int K, int R, int H, int P, int L,
                       int C, void* stream) {
  Tables<F> T = {lid, valid, nhops, ct, comp, ldet, P, R, H, L};
  const size_t smem = sched_layout(P, L, K, R, H, C, 0, sizeof(F)).bytes;
  const auto kernel = pick_kernel<WaveKernel, F>(H, P);
  cudaError_t err = sched_smem_optin(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, sched_threads(P), smem, (cudaStream_t)stream>>>(
      T, task, real, exitf, paft, psrc, pedge, alpha, period, lf_in, pf_in,
      loads_in, lop_in, bp_in, lf, pf, loads, lop, bp, win, est, eft, ca, cb,
      lst, lft, route, B, K, C);
  return (int)cudaGetLastError();
}

template <typename F>
static int plan_launch(const int* lid, const int* valid, const int* nhops,
                       const F* ct, const F* comp, const F* ldet,
                       const int* task, const int* real, const int* exitf,
                       const int* pred, const int* pvalid, const int* pedge,
                       const F* alphas, F period, const F* lf0, const F* pf0,
                       const F* loads0, const F* lop0, const F* bp0,
                       const F* aft0, const int* proc0, F* aft_s, int* proc_s,
                       int* win, F* est, F* eft, F* ca, F* cb, F* lst, F* lft,
                       int* route, F* lf_out, F* pf_out, F* loads_out,
                       F* lop_out, F* bp_out, int A, int W, int B, int K,
                       int R, int H, int P, int L, int n, int E, int C,
                       int rows, void* stream) {
  Tables<F> T = {lid, valid, nhops, ct, comp, ldet, P, R, H, L};
  const size_t smem =
      sched_layout(P, L, K, R, H, C, rows, sizeof(F)).bytes;
  const auto kernel = pick_kernel<PlanKernel, F>(H, P);
  cudaError_t err = sched_smem_optin(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<A, sched_threads(P), smem, (cudaStream_t)stream>>>(
      T, task, real, exitf, pred, pvalid, pedge, alphas, period, lf0, pf0,
      loads0, lop0, bp0, aft0, proc0, aft_s, proc_s, win, est, eft, ca, cb,
      lst, lft, route, lf_out, pf_out, loads_out, lop_out, bp_out, W, B, K,
      n, E, C, rows);
  return (int)cudaGetLastError();
}

extern "C" {

// bytes of one block's shared memory; real_bytes = 8 (double) or 4
size_t sched_smem(int P, int L, int K, int R, int H, int C, int rows,
                  int real_bytes) {
  return sched_layout(P, L, K, R, H, C, rows, (size_t)real_bytes).bytes;
}

int sched_wave_launch(const int* lid, const int* valid, const int* nhops,
                      const double* ct, const double* comp,
                      const double* ldet, const int* task, const int* real,
                      const int* exitf, const double* paft, const int* psrc,
                      const int* pedge, double alpha, double period,
                      const double* lf_in, const double* pf_in,
                      const double* loads_in, const double* lop_in,
                      const double* bp_in, double* lf, double* pf,
                      double* loads, double* lop, double* bp, int* win,
                      double* est, double* eft, double* ca, double* cb,
                      double* lst, double* lft, int* route, int B, int K,
                      int R, int H, int P, int L, int C, void* stream) {
  return wave_launch<double>(
      lid, valid, nhops, ct, comp, ldet, task, real, exitf, paft, psrc,
      pedge, alpha, period, lf_in, pf_in, loads_in, lop_in, bp_in, lf, pf,
      loads, lop, bp, win, est, eft, ca, cb, lst, lft, route, B, K, R, H, P,
      L, C, stream);
}

int sched_wave_launch_f32(const int* lid, const int* valid, const int* nhops,
                          const float* ct, const float* comp,
                          const float* ldet, const int* task, const int* real,
                          const int* exitf, const float* paft,
                          const int* psrc, const int* pedge, float alpha,
                          float period, const float* lf_in,
                          const float* pf_in, const float* loads_in,
                          const float* lop_in, const float* bp_in, float* lf,
                          float* pf, float* loads, float* lop, float* bp,
                          int* win, float* est, float* eft, float* ca,
                          float* cb, float* lst, float* lft, int* route,
                          int B, int K, int R, int H, int P, int L, int C,
                          void* stream) {
  return wave_launch<float>(
      lid, valid, nhops, ct, comp, ldet, task, real, exitf, paft, psrc,
      pedge, alpha, period, lf_in, pf_in, loads_in, lop_in, bp_in, lf, pf,
      loads, lop, bp, win, est, eft, ca, cb, lst, lft, route, B, K, R, H, P,
      L, C, stream);
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
                      int n, int E, int C, int rows, void* stream) {
  return plan_launch<double>(
      lid, valid, nhops, ct, comp, ldet, task, real, exitf, pred, pvalid,
      pedge, alphas, period, lf0, pf0, loads0, lop0, bp0, aft0, proc0, aft_s,
      proc_s, win, est, eft, ca, cb, lst, lft, route, lf_out, pf_out,
      loads_out, lop_out, bp_out, A, W, B, K, R, H, P, L, n, E, C, rows,
      stream);
}

int sched_plan_launch_f32(const int* lid, const int* valid, const int* nhops,
                          const float* ct, const float* comp,
                          const float* ldet, const int* task, const int* real,
                          const int* exitf, const int* pred,
                          const int* pvalid, const int* pedge,
                          const float* alphas, float period, const float* lf0,
                          const float* pf0, const float* loads0,
                          const float* lop0, const float* bp0,
                          const float* aft0, const int* proc0, float* aft_s,
                          int* proc_s, int* win, float* est, float* eft,
                          float* ca, float* cb, float* lst, float* lft,
                          int* route, float* lf_out, float* pf_out,
                          float* loads_out, float* lop_out, float* bp_out,
                          int A, int W, int B, int K, int R, int H, int P,
                          int L, int n, int E, int C, int rows,
                          void* stream) {
  return plan_launch<float>(
      lid, valid, nhops, ct, comp, ldet, task, real, exitf, pred, pvalid,
      pedge, alphas, period, lf0, pf0, loads0, lop0, bp0, aft0, proc0, aft_s,
      proc_s, win, est, eft, ca, cb, lst, lft, route, lf_out, pf_out,
      loads_out, lop_out, bp_out, A, W, B, K, R, H, P, L, n, E, C, rows,
      stream);
}

}  // extern "C"
