// Fused multi-period bittide engine for Hopper (sm_90a).
//
// Replaces repro/kernels/bittide_step.py::_fused_kernel, the resident
// Pallas engine: one launch advances num_records x record_every control
// periods for a batch of B independent oscillator draws.  Per period and
// per draw b, node i:
//
//   acc_i  = sum_c sum_j A[c,i,j] * (psi_j - nu_j * lat[b,c])
//   err_i  = acc_i - (psi_i + beta_off[b]) * deg_i + lamsum[b,i]
//   c_i    = kp[b] * err_i
//   nu'_i  = nu_u_i + c_i + nu_u_i * c_i        (cancellation-free)
//   nu'_i  = nu_i where the node is in holdover (mask <= 0.5)
//   psi'_i = psi_i + nu'_i * dt_frames
//
// and at every record point it writes nu, optionally the per-node net
// occupancy of the post-update state with psi centred by its row mean
// (beta), optionally folds that into per-node watermarks, and optionally
// runs the reframing guard: a draw trips at the first record at which any
// node's net occupancy leaves the degree-scaled band
// [guard_lo[b]*deg_i, guard_hi[b]*deg_i], and records after guard_stop
// are not run.
//
// What binds.  The period recurrence is serial, and one period of a draw
// is little work (FC8: 8 x 8 multiply-adds; torus3d(6): 216 x 6 nonzero
// ones), so the time is the period's dependent chain times the periods;
// at a few warps per SM a warp's own instructions per period count as
// much, since it issues at most one a cycle.  The design shortens both
// and keeps every SM busy with many independent draws:
//
// * Row lists.  The wrapper builds, once per stack, each row's nonzero
//   coefficients (j, A[c,i,j]), classes in order and j ascending
//   (bittide_step.py::row_lists).  Where the longest row holds at most
//   kRegTerms terms and at most half of C*N, a thread sums only those: at
//   torus3d(6) a chain of 6 terms instead of 216, and no (C, N, N) stack
//   in shared memory (at torus3d(6) its 187 KB would leave room for one
//   CTA per SM).  Longer rows (dense FC graphs) keep the dense loop over
//   j = 0..N-1.
// * Short rows in registers.  A row of at most kRegTerms terms (listed,
//   or the dense row with its zeros) sits in registers and is summed by
//   an unrolled, branch-free loop, so its x loads issue together; longer
//   rows loop over A (in shared memory when it fits).
// * Warp-synchronous draws.  For N <= 32 a draw lives in the lanes of one
//   warp (32 / N draws per warp) and nothing in the period loop waits on
//   the block: with one latency class and short rows x stays in a
//   register and travels by __shfl_sync, with no store and no sync;
//   otherwise x goes through shared memory with __syncwarp.  For N > 32
//   a CTA owns whole draws and the period ends in one __syncthreads_or.
//   Shared-memory x is double-buffered, so one barrier per period both
//   publishes the new x and frees the old one.  Class latencies sit in
//   shared memory and class loops run C times, not kMaxClasses.

// Same bits as the dense sum.  Skipping an exactly-zero coefficient does
// not change a sum while x is finite: every partial sum starts at +0 and
// round-to-nearest never makes -0 from a nonzero or a +0 operand, so part
// + (+-0) is part.  With an inf or NaN among a draw's x, 0*x is NaN in the
// dense sum, so each period's publishing barrier is a vote over !isfinite
// of the published x (__syncthreads_or, or __any_sync), and when it is
// set the next period runs the dense loop, reading A from device memory.
// The measure pass votes the same way on its centred x.
// A vote covers every draw of its CTA or warp; the dense loop gives a
// finite draw the same bits, so that costs time, not bits.
//
// Guard.  The reference freezes the WHOLE batch at the earliest trip.  A
// CTA here cannot see another CTA's trip in time, so each draw freezes at
// its own first trip (or after guard_stop) and writes its trip record
// (num_records when it never tripped).  The wrapper takes t* = min over
// draws and, when a draw ran past t*, launches the chunk once more from
// the same inputs with guard_stop = t*.  A draw's bits do not depend on the
// batch, so that replay is the batch-wide freeze bit for bit.
//
// Numbers.  float32 throughout.  Every product and sum is an explicit
// round-to-nearest intrinsic (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn), which the compiler may not contract into an FMA, and every
// sum runs in a fixed order: classes in order, nodes j ascending, no
// atomics.  A draw's result therefore depends neither on B, nor on the
// CTA that ran it, nor on the plan, and it equals bit for bit the plain
// PyTorch version (bittide_step.py::bittide_fused_torch), which performs
// the dense sum's operations in the same order.
//
// Bound.  Work: B * steps * (2*nnz + O(N)) float32 operations against
// 67 TFLOP/s (no tensor cores: the reference accumulates in float32 and
// TF32 would lose the 1e-6 ppm parity).  Bytes: every input read once plus
// the nu record (and beta record) written once.  Latency: steps x (the
// longest row's chain of dependent adds, plus one per class, the update's
// dependent chain and one synchronisation), plus per record the row
// mean's chain of N adds (chip_smoke.fused_latency_bound).

#include <cuda_runtime.h>
#include <stddef.h>

#include "bittide_fold.cuh"

namespace {

constexpr int kMaxClasses = 8;
constexpr int kRegTerms = 8;   // a row of at most this many terms sits in
                               // registers, its loop fully unrolled
constexpr int kMaxWarps = 4;   // warp path: warps per CTA

// One listed coefficient of a row: source node j, weight A[c][i][j].
struct __align__(8) Term {
  int j;
  float a;
};

struct Params {
  const float* at;        // (C, N, N), at[(c*N + j)*N + i] = A[c][i][j]
  const Term* terms;      // (L, N) row lists, terms[k*N + i], or null
  const int* counts;      // (C, N) listed terms per (class, row), or null
  const float* psi0;      // (B, N)
  const float* nu0;       // (B, N)
  const float* nu_u;      // (B, N)
  const float* kp;        // (B,)
  const float* beta_off;  // (B,)
  const float* mask;      // (mask_rows, N), mask_rows in {1, B}
  const float* deg;       // (N,)
  const float* lamsum;    // (B, N)
  const float* lat;       // (B, C)
  const float* guard_lo;  // (B,) or null: guard band, frames per degree
  const float* guard_hi;  // (B,)
  float dt_frames;
  int B, N, C, mask_rows, num_records, record_every;
  int draws_per_cta;      // G
  int draws_per_warp;     // warp path: 32 / N
  int list_slots;         // L; 0 = the dense loop
  int reg_terms;          // 1: each row's terms in registers
  int a_in_smem, guard_stop;
  float* psi_out;         // (B, N)
  float* nu_out;          // (B, N)
  float* freq;            // (R, B, N) nu records
  float* beta;            // (R, B, N) or null
  float* wm_bmax;         // (B, N) or null
  int* wm_idx;
  float* wm_lo;
  float* wm_hi;
  int* trip;              // (B,) first trip record, or null
};

// The plan of the last accepted launch (bittide_fused_plan).
int g_plan[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};

// Barriers of the two paths: the warp's lanes (with __syncwarp's memory
// ordering) or the whole CTA.
template <bool kWarp>
__device__ __forceinline__ void sync_all() {
  if (kWarp)
    __syncwarp();
  else
    __syncthreads();
}

template <bool kWarp>
__device__ __forceinline__ bool sync_or(bool flag) {
  if (kWarp) {
    __syncwarp();
    return __any_sync(0xffffffffu, flag);
  }
  return __syncthreads_or(flag) != 0;
}

template <bool kWarp>
__device__ __forceinline__ bool sync_and(bool flag) {
  if (kWarp) return __all_sync(0xffffffffu, flag);
  return __syncthreads_and(flag) != 0;
}

// Sum_c Sum_j A[c][i][j] * x_c[j] of row i over every j = 0..N-1: the
// rows too long for registers, and the vote's dense periods, take this
// loop.  kMeasure builds x_c[j] = (ps[j] - mean) - ns[j]*lat[c] from the
// staged state; otherwise x is xs (C, N).
template <bool kMeasure>
__device__ __forceinline__ float aggregate(
    const float* A, const float* lat, const float* xs, const float* ps,
    const float* ns, float mean, int N, int C, int i) {
  float acc = 0.f;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    float part = 0.f;
    const float* a = A + (size_t)c * N * N + i;
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      const float x = kMeasure ? __fsub_rn(__fsub_rn(ps[j], mean),
                                           __fmul_rn(ns[j], lat[c]))
                               : xs[c * N + j];
      part = __fadd_rn(part, __fmul_rn(a[(size_t)j * N], x));
    }
    acc = __fadd_rn(acc, part);
  }
  return acc;
}

// A row's terms in registers: term m reads x at xo[m] = c*N + j (class
// c, source j) and weighs it by a[m]; bit m of `ends` marks the last term
// of its class.  Every x is loaded first (unrolled, so the loads
// issue together), then only the adds wait on each other.  The loop has no
// branch: a slot past the row's terms adds 0*0 (part is never -0, so part
// + (+0) is part), and a class end folds part into acc by a select.
// Classes without terms add nothing (acc is never -0 either).
struct RowTerms {
  int xo[kRegTerms];
  float a[kRegTerms];
  int count;
  unsigned ends;
};

// kMeasure builds x from the staged state, x = (ps[j] - mean) -
// ns[j]*lat[c], with (c, j) decoded from xo (once per record).
template <bool kMeasure>
__device__ __forceinline__ float aggregate_regs(
    const RowTerms& r, const float* xs, const float* ps, const float* ns,
    const float* lat, float mean, int N, int C) {
  float x[kRegTerms];
#pragma unroll
  for (int m = 0; m < kRegTerms; ++m) {
    if (kMeasure) {
      const int c = r.xo[m] / N, j = r.xo[m] - c * N;
      x[m] = __fsub_rn(__fsub_rn(ps[j], mean), __fmul_rn(ns[j], lat[c]));
    } else {
      x[m] = xs[r.xo[m]];
    }
  }
  float acc = 0.f, part = 0.f;
  if (C == 1) {  // one class: its end is the row's last term
#pragma unroll
    for (int m = 0; m < kRegTerms; ++m)
      part = __fadd_rn(part, __fmul_rn(r.a[m], m < r.count ? x[m] : 0.f));
    return __fadd_rn(acc, part);
  }
#pragma unroll
  for (int m = 0; m < kRegTerms; ++m) {
    part = __fadd_rn(part, __fmul_rn(r.a[m], m < r.count ? x[m] : 0.f));
    const bool end = (r.ends >> m) & 1u;
    const float folded = __fadd_rn(acc, part);
    acc = end ? folded : acc;
    part = end ? 0.f : part;
  }
  return acc;
}

// One class on the warp path: x_j comes from lane base + j by a shuffle,
// for the row's terms in registers (aggregate_shfl) or, after a vote, for
// every j with A from device memory (dense_shfl).  Every lane of the warp
// runs these, frozen or idle ones too.
__device__ __forceinline__ float aggregate_shfl(const RowTerms& r, float xr,
                                                int base) {
  float x[kRegTerms];
#pragma unroll
  for (int m = 0; m < kRegTerms; ++m)
    x[m] = __shfl_sync(0xffffffffu, xr, base + r.xo[m]);
  float part = 0.f;
#pragma unroll
  for (int m = 0; m < kRegTerms; ++m)
    part = __fadd_rn(part, __fmul_rn(r.a[m], m < r.count ? x[m] : 0.f));
  return __fadd_rn(0.f, part);
}

__device__ __forceinline__ float dense_shfl(const float* A, float xr,
                                            int base, int N, int i) {
  float part = 0.f;
#pragma unroll 8
  for (int j = 0; j < N; ++j)
    part = __fadd_rn(part, __fmul_rn(A[(size_t)j * N + i],
                                     __shfl_sync(0xffffffffu, xr, base + j)));
  return __fadd_rn(0.f, part);
}

// kWarp: N <= 32, draws_per_warp draws in the lanes of each warp, no block
// barrier after the set-up.  Otherwise a CTA of G*N threads owns G draws.
template <bool kWarp, bool kBeta, bool kWm, bool kGuard>
__global__ void __launch_bounds__(kWarp ? 32 * kMaxWarps : 1024)
    bittide_fused_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, C = p.C, G = p.draws_per_cta;
  const bool lists = p.list_slots > 0;

  // Thread -> (draw slot g of the CTA, node i).  Lanes past a warp's
  // draws (N not dividing 32) compute on a live slot and write nothing.
  int g, i, base = 0;     // base: warp path, the lane of the draw's node 0
  bool lane_ok = true;
  unsigned draw_lanes = 0u;  // warp path: the lanes of this draw
  if (kWarp) {
    const int D = p.draws_per_warp;
    const int lane = threadIdx.x & 31;
    const int gw = lane / N;
    lane_ok = gw < D;
    const int gl = lane_ok ? gw : D - 1;
    g = (threadIdx.x >> 5) * D + gl;
    i = lane - gw * N;
    if (!lane_ok) i = 0;
    draw_lanes = (N == 32 ? 0xffffffffu : ((1u << N) - 1u)) << (gl * N);
    base = gl * N;
  } else {
    g = threadIdx.x / N;
    i = threadIdx.x - g * N;
  }
  const int b = blockIdx.x * G + g;
  const bool live = lane_ok && b < p.B;
  const int bi = b < p.B ? b : 0;  // idle slots of a partial last CTA
                                   // compute on draw 0 and write nothing

  // Shared memory: the stack when the plan puts it there, then x (two
  // buffers), the staged state of the measure pass and the guard's flags.
  float* s_f = reinterpret_cast<float*>(smem_raw);
  const float* A = p.at;
  if (p.a_in_smem) {
    for (int k = threadIdx.x; k < C * N * N; k += blockDim.x)
      s_f[k] = p.at[k];
    A = s_f;
    s_f += C * N * N;
  }
  float* s_x = s_f;                    // (2, G, C, N)
  float* s_psi = s_x + 2 * G * C * N;  // (G, N) state at record points
  float* s_nu = s_psi + G * N;         // (G, N)
  float* s_lat = s_nu + G * N;         // (G, C) class latencies
  int* s_viol = reinterpret_cast<int*>(s_lat + G * C);  // (G,) block guard

  const size_t row = (size_t)bi * N + i;
  float psi = p.psi0[row];
  float nu = p.nu0[row];
  const float nu_u = p.nu_u[row];
  const float kp = p.kp[bi];
  const float boff = p.beta_off[bi];
  const float deg = p.deg[i];
  const float lamsum = p.lamsum[row];
  const bool enabled =
      p.mask[(p.mask_rows == 1 ? (size_t)0 : (size_t)bi * N) + i] > 0.5f;
  const float* lat = s_lat + g * C;
  const int* cnt = lists ? p.counts + i : nullptr;  // cnt[c*N]
  if (lane_ok && i == 0)
    for (int c = 0; c < C; ++c) s_lat[g * C + c] = p.lat[bi * C + c];
  // Short rows in registers: the listed terms, or every j of the dense
  // loop (zeros included, so its bits are the dense loop's).
  RowTerms rt;
  rt.count = 0;
  rt.ends = 0u;
#pragma unroll
  for (int m = 0; m < kRegTerms; ++m) {
    rt.xo[m] = 0;
    rt.a[m] = 0.f;
  }
  if (p.reg_terms) {
    int k = 0;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const int len = lists ? cnt[(size_t)c * N] : N;
      for (int q = 0; q < len; ++q, ++rt.count) {
        int j;
        float a;
        if (lists) {
          const Term e = p.terms[(size_t)k++ * N + i];
          j = e.j;
          a = e.a;
        } else {
          j = q;
          a = p.at[((size_t)c * N + j) * N + i];
        }
#pragma unroll
        for (int m = 0; m < kRegTerms; ++m)
          if (m == rt.count) {
            rt.xo[m] = c * N + j;
            rt.a[m] = a;
          }
      }
      if (len > 0) rt.ends |= 1u << (rt.count - 1);
    }
  }

  // This draw's x in the two buffers.
  float* const xs0 = s_x + (size_t)g * C * N;
  float* const xs1 = s_x + ((size_t)G + g) * C * N;
  // Publish this node's x_c = psi - nu*lat_c into buffer `buf`; true when
  // one of them is not finite (the dense loop needs no vote: its sums are
  // the plain version's).
  auto publish = [&](int buf) {
    float* xs = (buf ? xs1 : xs0) + i;
    bool bad = false;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      const float x = __fsub_rn(psi, __fmul_rn(nu, lat[c]));
      if (lists) bad |= !isfinite(x);
      if (lane_ok) xs[c * N] = x;
    }
    return lane_ok && bad;
  };

  __syncthreads();  // stack / class latencies in shared memory
  // One class on the warp path with short rows: x stays in a register and
  // travels by shuffles, so a period needs no shared memory and no sync.
  const bool shfl = kWarp && C == 1 && p.reg_terms;
  const float lat0 = lat[0];
  float xr = __fsub_rn(psi, __fmul_rn(nu, lat0));
  int cur = 0;
  const bool bad0 =
      shfl ? lists && __any_sync(0xffffffffu, lane_ok && !isfinite(xr))
           : sync_or<kWarp>(publish(cur));
  bool dense = !lists || bad0;

  float glo = 0.f, ghi = 0.f;
  if (kGuard) {
    glo = p.guard_lo[bi];
    ghi = p.guard_hi[bi];
  }
  // Guard: records after guard_stop are not run, and a draw that tripped
  // runs nothing more (its threads keep meeting the barriers and votes).
  const int t_end = kGuard ? min(p.num_records, p.guard_stop + 1)
                           : p.num_records;
  bool frozen = false;
  int trip = p.num_records;

  float w_bmax = 0.f, w_lo = 0.f, w_hi = 0.f;
  int w_idx = 0;
  for (int t = 0; t < t_end; ++t) {
    for (int s = 0; s < p.record_every && shfl; ++s) {
      const float acc = lists && dense ? dense_shfl(A, xr, base, N, i)
                                       : aggregate_shfl(rt, xr, base);
      if (!frozen) {
        const float err = __fadd_rn(
            __fsub_rn(acc, __fmul_rn(__fadd_rn(psi, boff), deg)), lamsum);
        const float c_rel = __fmul_rn(kp, err);
        float nu_next =
            __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
        if (!enabled) nu_next = nu;
        psi = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
        nu = nu_next;
        xr = __fsub_rn(psi, __fmul_rn(nu, lat0));
      }
      if (lists)
        dense = __any_sync(0xffffffffu,
                           lane_ok && !frozen && !isfinite(xr));
    }
    for (int s = 0; s < p.record_every && !shfl; ++s) {
      bool bad = false;
      if (!frozen) {
        const float* xs = cur ? xs1 : xs0;
        const float acc =
            p.reg_terms && !(lists && dense)
                ? aggregate_regs<false>(rt, xs, nullptr, nullptr, nullptr,
                                        0.f, N, C)
                : aggregate<false>(A, lat, xs, nullptr, nullptr, 0.f, N, C,
                                   i);
        const float err = __fadd_rn(
            __fsub_rn(acc, __fmul_rn(__fadd_rn(psi, boff), deg)), lamsum);
        const float c_rel = __fmul_rn(kp, err);
        float nu_next =
            __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
        if (!enabled) nu_next = nu;
        psi = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
        nu = nu_next;
        bad = publish(1 - cur);
      }
      // One barrier: the new x is visible and the old buffer is free.
      const bool any_bad = sync_or<kWarp>(bad);
      dense = !lists || any_bad;
      cur = 1 - cur;
    }

    const size_t rec = ((size_t)t * p.B + bi) * N + i;
    if (live && !frozen) p.freq[rec] = nu;
    if (kBeta || kWm || kGuard) {
      // Per-node net occupancy of the post-update state, psi centred by
      // its row mean (beta is invariant under a uniform shift; centring
      // keeps the partial sums at the size of the psi spread).
      float* ps = s_psi + g * N;
      float* ns = s_nu + g * N;
      if (lane_ok) {
        ps[i] = psi;
        ns[i] = nu;
      }
      if (!kWarp && kGuard && i == 0) s_viol[g] = 0;
      sync_all<kWarp>();
      float mean = 0.f;
      bool bad = false;
      if (!frozen) {
        float sum = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) sum = __fadd_rn(sum, ps[j]);
        mean = __fdiv_rn(sum, (float)N);
        if (lists)
          for (int c = 0; c < C; ++c)
            bad |= !isfinite(__fsub_rn(__fsub_rn(psi, mean),
                                       __fmul_rn(nu, lat[c])));
      }
      const bool mdense = !lists || sync_or<kWarp>(lane_ok && bad);
      bool viol = false;
      if (!frozen) {
        const float bacc =
            p.reg_terms && !(lists && mdense)
                ? aggregate_regs<true>(rt, nullptr, ps, ns, lat, mean, N, C)
                : aggregate<true>(A, lat, nullptr, ps, ns, mean, N, C, i);
        const float bnode = __fadd_rn(
            __fsub_rn(bacc, __fmul_rn(__fsub_rn(psi, mean), deg)), lamsum);
        if (kBeta && live) p.beta[rec] = bnode;
        if (kWm) {
          // Strict > keeps the FIRST record reaching the max (np.argmax).
          const float babs = fabsf(bnode);
          if (t == 0) {
            w_bmax = babs;
            w_idx = 0;
            w_lo = nu;
            w_hi = nu;
          } else {
            if (babs > w_bmax) w_idx = t;
            w_bmax = max_nan(w_bmax, babs);
            w_lo = min_nan(w_lo, nu);
            w_hi = max_nan(w_hi, nu);
          }
        }
        // Strict inequalities: a node of degree 0 (beta == 0) never trips.
        viol = kGuard && lane_ok &&
               (bnode > __fmul_rn(ghi, deg) || bnode < __fmul_rn(glo, deg));
      }
      if (kGuard) {
        bool tripped;
        if (kWarp) {
          tripped = (__ballot_sync(0xffffffffu, viol) & draw_lanes) != 0u;
        } else {
          if (viol) s_viol[g] = 1;
          __syncthreads();
          tripped = s_viol[g] != 0;
        }
        if (tripped && !frozen) {
          trip = t;
          frozen = true;
        }
        // Every draw of the CTA (warp) frozen; idle slots count as frozen.
        if (sync_and<kWarp>(frozen || !live)) break;
      }
      // ps / ns / s_viol are next written at the following record, after
      // at least one period's barrier, so no barrier is needed here.
    }
  }

  if (live) {
    p.psi_out[row] = psi;
    p.nu_out[row] = nu;
    if (kWm) {
      p.wm_bmax[row] = w_bmax;
      p.wm_idx[row] = w_idx;
      p.wm_lo[row] = w_lo;
      p.wm_hi[row] = w_hi;
    }
    if (kGuard && i == 0) p.trip[bi] = trip;
  }
}

using Kernel = void (*)(const Params);

// The sixteen template instances, indexed by (warp, beta, watermarks,
// guard).
template <bool kWarp>
Kernel pick(int index) {
  static const Kernel kernels[8] = {
      bittide_fused_kernel<kWarp, false, false, false>,
      bittide_fused_kernel<kWarp, false, false, true>,
      bittide_fused_kernel<kWarp, false, true, false>,
      bittide_fused_kernel<kWarp, false, true, true>,
      bittide_fused_kernel<kWarp, true, false, false>,
      bittide_fused_kernel<kWarp, true, false, true>,
      bittide_fused_kernel<kWarp, true, true, false>,
      bittide_fused_kernel<kWarp, true, true, true>};
  return kernels[index];
}

}  // namespace

// Shared memory one block may opt in to on the current device, in bytes
// (negative: the CUDA error of the query).
extern "C" int bittide_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? bytes : -(int)e;
}

// The plan of the last accepted launch: out = {warp path, list slots (0:
// the dense loop), draws per CTA, CTAs, threads per CTA, dynamic shared
// bytes, stack in shared memory, draws per warp (0 on the block path),
// rows in registers}.
extern "C" void bittide_fused_plan(int* out) {
  for (int k = 0; k < 9; ++k) out[k] = g_plan[k];
}

// Plain C entry point (loaded with ctypes).  The plan (bittide_step.py::
// launch_plan) is checked here and refused when the kernel cannot run
// it: warp (N <= 32, draws_per_cta = warps x draws_per_warp with
// draws_per_warp = 32 / N) or block (draws_per_cta * N <= 1024 threads),
// list_slots in 1..kRegTerms with terms / counts and rows in registers
// (0: the dense loop), a_in_smem only with the dense loop.  Returns cudaGetLastError() after the launch:
// 0 when the launch was accepted.
extern "C" int bittide_fused_launch(
    const float* at, const int* terms, const int* counts, const float* psi0,
    const float* nu0, const float* nu_u, const float* kp,
    const float* beta_off, const float* mask, int mask_rows,
    const float* deg, const float* lamsum, const float* lat, float dt_frames,
    int B, int N, int C, int num_records, int record_every, int warp,
    int draws_per_cta, int draws_per_warp, int list_slots, int reg_terms,
    int a_in_smem,
    float* psi_out, float* nu_out, float* freq, float* beta, float* wm_bmax,
    int* wm_idx, float* wm_lo, float* wm_hi, const float* guard_lo,
    const float* guard_hi, int guard_stop, int* trip, void* stream) {
  const int G = draws_per_cta;
  int threads;
  if (warp) {
    if (N > 32 || draws_per_warp != 32 / N || G < draws_per_warp ||
        G % draws_per_warp != 0 || G / draws_per_warp > kMaxWarps)
      return (int)cudaErrorInvalidValue;
    threads = 32 * (G / draws_per_warp);
  } else {
    if (draws_per_warp != 0 || G < 1 || (long long)G * N > 1024)
      return (int)cudaErrorInvalidValue;
    threads = G * N;
  }
  if (C < 1 || C > kMaxClasses || N < 1 || B < 1 || list_slots < 0 ||
      list_slots > kRegTerms ||
      (list_slots > 0 && (terms == nullptr || counts == nullptr ||
                          !reg_terms || a_in_smem)) ||
      (reg_terms && list_slots == 0 && C * N > kRegTerms))
    return (int)cudaErrorInvalidValue;
  Params p{at, reinterpret_cast<const Term*>(terms), counts, psi0, nu0,
           nu_u, kp, beta_off, mask, deg, lamsum, lat, guard_lo, guard_hi,
           dt_frames, B, N, C, mask_rows, num_records, record_every, G,
           warp ? draws_per_warp : 0, list_slots, reg_terms != 0, a_in_smem,
           guard_stop,
           psi_out, nu_out, freq, beta, wm_bmax, wm_idx, wm_lo, wm_hi, trip};
  const bool want_beta = beta != nullptr, want_wm = wm_bmax != nullptr,
             want_guard = trip != nullptr;
  size_t smem = sizeof(float) * (2 * (size_t)G * C * N +
                                 2 * (size_t)G * N + (size_t)G * C);
  if (want_guard && !warp) smem += sizeof(int) * (size_t)G;
  if (a_in_smem) smem += sizeof(float) * (size_t)C * N * N;
  const int index = 4 * want_beta + 2 * want_wm + want_guard;
  const Kernel kern = warp ? pick<true>(index) : pick<false>(index);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + G - 1) / G;
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) {
    const int plan[9] = {warp,      list_slots, G,
                         blocks,    threads,    (int)smem,
                         a_in_smem, warp ? draws_per_warp : 0,
                         reg_terms != 0};
    for (int k = 0; k < 9; ++k) g_plan[k] = plan[k];
  }
  return (int)e;
}
