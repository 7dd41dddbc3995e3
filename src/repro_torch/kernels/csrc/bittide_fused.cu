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
// Design.  The TPU kernel carries the state in VMEM scratch across ordered
// grid steps.  Here a period of draw b needs every node of draw b and
// nothing of any other draw, so each CTA owns a block of G whole draws
// (thread = (draw, node) pair, blockDim = G*N) and loops over all periods
// itself: no grid-wide sync, one launch, two __syncthreads() per period
// (after x is read, after the new x is written).  The state lives in
// registers; shared memory holds x_c = psi - nu*lat_c for the draw's nodes
// and, when it fits, the (C, N, N) stack.  A is passed transposed
// (at[c][j][i] = A[c][i][j]) so neighbouring threads read neighbouring
// addresses, from shared memory if C*N*N*4 bytes fit beside the state,
// else from global memory (L2-resident: one copy serves every CTA).
// Watermarks are register aggregates written once at the end.
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
// sum runs in a fixed order: classes in order, nodes j = 0..N-1 in order,
// no atomics.  A draw's result therefore depends neither on B nor on the
// CTA that ran it, and it equals bit for bit the plain PyTorch version
// (bittide_step.py::bittide_fused_torch), which performs the same
// operations in the same order.
//
// Bound.  Work: B * steps * (2*C*N^2 + O(N)) float32 operations against
// 67 TFLOP/s (no tensor cores: the reference accumulates in float32 and
// TF32 would lose the 1e-6 ppm parity).  Bytes: every input read once plus
// the nu record (and beta record) written once, R*B*N*4 bytes each, against
// 3.35 TB/s.  The period recurrence is serial, so the time is also at least
// steps x (one period's dependent chain of C*N multiply-adds plus two block
// barriers); the design keeps that chain in shared memory and registers and
// fills the card with many independent CTAs instead of splitting a draw.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxClasses = 8;

struct Params {
  const float* at;        // (C, N, N), at[(c*N + j)*N + i] = A[c][i][j]
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
  int B, N, C, mask_rows, num_records, record_every, draws_per_cta;
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

template <bool kBeta, bool kWm, bool kGuard>
__global__ void bittide_fused_kernel(const Params p) {
  extern __shared__ float smem[];
  const int N = p.N, C = p.C, G = p.draws_per_cta;
  const int g = threadIdx.x / N;
  const int i = threadIdx.x - g * N;
  const int b = blockIdx.x * G + g;
  const bool live = b < p.B;
  const int bi = live ? b : 0;  // idle threads of a partial last CTA
                                // compute on draw 0 and write nothing

  float* s_x = smem;                 // (G, C, N)
  float* s_psi = s_x + G * C * N;    // (G, N) state at record points
  float* s_nu = s_psi + G * N;       // (G, N)
  int* s_viol = reinterpret_cast<int*>(s_nu + G * N);  // (G,) with kGuard
  const float* A = p.at;
  if (p.a_in_smem) {
    float* s_a = reinterpret_cast<float*>(s_viol + (kGuard ? G : 0));
    for (int k = threadIdx.x; k < C * N * N; k += blockDim.x) s_a[k] = p.at[k];
    A = s_a;
  }

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
  float lat[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) lat[c] = c < C ? p.lat[bi * C + c] : 0.f;

  float* xs = s_x + g * C * N;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c)
    if (c < C) xs[c * N + i] = __fsub_rn(psi, __fmul_rn(nu, lat[c]));
  __syncthreads();

  float glo = 0.f, ghi = 0.f;
  if (kGuard) {
    glo = p.guard_lo[bi];
    ghi = p.guard_hi[bi];
  }
  // Guard: records after guard_stop are not run, and a draw that tripped
  // runs nothing more (its threads keep meeting the block barriers).
  const int t_end = kGuard ? min(p.num_records, p.guard_stop + 1)
                           : p.num_records;
  bool frozen = false;
  int trip = p.num_records;

  float w_bmax = 0.f, w_lo = 0.f, w_hi = 0.f;
  int w_idx = 0;
  for (int t = 0; t < t_end; ++t) {
    for (int s = 0; s < p.record_every; ++s) {
      if (frozen) {
        __syncthreads();
        __syncthreads();
        continue;
      }
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C) {
          const float* a = A + (size_t)c * N * N + i;
          const float* x = xs + c * N;
          float part = 0.f;
          for (int j = 0; j < N; ++j)
            part = __fadd_rn(part, __fmul_rn(a[(size_t)j * N], x[j]));
          acc = __fadd_rn(acc, part);
        }
      }
      const float err = __fadd_rn(
          __fsub_rn(acc, __fmul_rn(__fadd_rn(psi, boff), deg)), lamsum);
      const float c_rel = __fmul_rn(kp, err);
      float nu_next = __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
      if (!enabled) nu_next = nu;
      psi = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
      nu = nu_next;
      __syncthreads();  // every thread of the draw has read the old x
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c)
        if (c < C) xs[c * N + i] = __fsub_rn(psi, __fmul_rn(nu, lat[c]));
      __syncthreads();  // the new x is visible
    }

    const size_t rec = ((size_t)t * p.B + bi) * N + i;
    if (live && !frozen) p.freq[rec] = nu;
    if (kBeta || kWm || kGuard) {
      // Per-node net occupancy of the post-update state, psi centred by
      // its row mean (beta is invariant under a uniform shift; centring
      // keeps the partial sums at the size of the psi spread).
      float* ps = s_psi + g * N;
      float* ns = s_nu + g * N;
      ps[i] = psi;
      ns[i] = nu;
      if (kGuard && i == 0) s_viol[g] = 0;
      __syncthreads();
      if (frozen) {
        if (kGuard) __syncthreads();
        if (kGuard && __syncthreads_and(frozen || !live)) break;
        continue;
      }
      float sum = 0.f;
      for (int j = 0; j < N; ++j) sum = __fadd_rn(sum, ps[j]);
      const float mean = __fdiv_rn(sum, (float)N);
      float bacc = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C) {
          const float* a = A + (size_t)c * N * N + i;
          float part = 0.f;
          for (int j = 0; j < N; ++j) {
            const float x = __fsub_rn(__fsub_rn(ps[j], mean),
                                      __fmul_rn(ns[j], lat[c]));
            part = __fadd_rn(part, __fmul_rn(a[(size_t)j * N], x));
          }
          bacc = __fadd_rn(bacc, part);
        }
      }
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
          w_bmax = fmaxf(w_bmax, babs);
          w_lo = fminf(w_lo, nu);
          w_hi = fmaxf(w_hi, nu);
        }
      }
      if (kGuard) {
        // Strict inequalities: a node of degree 0 (beta == 0) never trips.
        if (bnode > __fmul_rn(ghi, deg) || bnode < __fmul_rn(glo, deg))
          s_viol[g] = 1;
        __syncthreads();
        if (s_viol[g]) {
          trip = t;
          frozen = true;
        }
        // Every draw of the CTA frozen (idle threads count as frozen).
        if (__syncthreads_and(frozen || !live)) break;
      }
      // ps / ns / s_viol are next written at the following record, after
      // at least one period's barriers, so no barrier is needed here.
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

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int bittide_fused_launch(
    const float* at, const float* psi0, const float* nu0, const float* nu_u,
    const float* kp, const float* beta_off, const float* mask, int mask_rows,
    const float* deg, const float* lamsum, const float* lat, float dt_frames,
    int B, int N, int C, int num_records, int record_every, int draws_per_cta,
    int a_in_smem, float* psi_out, float* nu_out, float* freq, float* beta,
    float* wm_bmax, int* wm_idx, float* wm_lo, float* wm_hi,
    const float* guard_lo, const float* guard_hi, int guard_stop, int* trip,
    void* stream) {
  if (C < 1 || C > kMaxClasses || N < 1 || draws_per_cta < 1 ||
      draws_per_cta * N > 1024)
    return (int)cudaErrorInvalidValue;
  Params p{at, psi0, nu0, nu_u, kp, beta_off, mask, deg, lamsum, lat,
           guard_lo, guard_hi, dt_frames, B, N, C, mask_rows, num_records,
           record_every, draws_per_cta, a_in_smem, guard_stop, psi_out,
           nu_out, freq, beta, wm_bmax, wm_idx, wm_lo, wm_hi, trip};
  const int G = draws_per_cta;
  const bool want_beta = beta != nullptr, want_wm = wm_bmax != nullptr,
             want_guard = trip != nullptr;
  size_t smem = sizeof(float) * ((size_t)G * C * N + 2 * (size_t)G * N);
  if (want_guard) smem += sizeof(int) * (size_t)G;
  if (a_in_smem) smem += sizeof(float) * (size_t)C * N * N;
  // The eight template instances, indexed by (beta, watermarks, guard).
  void (*const kernels[8])(const Params) = {
      bittide_fused_kernel<false, false, false>,
      bittide_fused_kernel<false, false, true>,
      bittide_fused_kernel<false, true, false>,
      bittide_fused_kernel<false, true, true>,
      bittide_fused_kernel<true, false, false>,
      bittide_fused_kernel<true, false, true>,
      bittide_fused_kernel<true, true, false>,
      bittide_fused_kernel<true, true, true>};
  void (*kern)(const Params) =
      kernels[4 * want_beta + 2 * want_wm + want_guard];
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + G - 1) / G;
  kern<<<blocks, G * N, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
