// Per-step bittide engine for Hopper (sm_90a): one control period of one
// draw per launch.
//
// Replaces repro/kernels/bittide_step.py::_kernel (bittide_step_pallas),
// the reference's per-step baseline and capability fallback.  Per period,
// for node i of the one draw:
//
//   acc_i  = sum_c sum_j A[c,i,j] * (psi_j - nu_j * lat[c])
//   err_i  = acc_i - (psi_i + beta_off) * deg_i + lamsum_i
//   nu'_i  = nu_u_i + c_i + nu_u_i * c_i,  c_i = kp * err_i
//   nu'_i  = nu_i where the node is in holdover (mask <= 0.5)
//   psi'_i = psi_i + nu'_i * dt_frames
//
// deg and lamsum are the step-invariant folds of the stack and of lambda_eff
// (the (C, N, N) lambda_eff tensor never reaches the kernel).  The measure
// pass gives beta_i = acc_i - psi_i * deg_i + lamsum_i of the state with
// psi centred by its row mean (the reference's host-side psi - mean(psi)),
// and in its epilogue the watermarks and the reframing guard.
//
// Design.  One thread per destination row i, sum over classes in order
// and sources j = 0..N-1 in order; the stack is passed source-major
// (at[(c*N + j)*N + i] = A[c][i][j]), so the threads of a warp read 32
// consecutive floats of one source row.  The CTA stages x_j = psi_j -
// nu_j * lat[c] for kTileJ sources at a time in shared memory.  The state
// lives in device memory as a ping-pong pair (a period reads slot cur and
// writes slot 1 - cur), and the record loop runs here in C, every launch
// on the caller's stream with no sync: one chunk is one call.
//
// Numbers.  float32 with explicit round-to-nearest intrinsics, no fused
// multiply-add, one accumulator per row summed in the order of
// bittide_fused.cu / bittide_tiled.cu; the row mean is summed j = 0..N-1
// in order and divided by the true quotient, as bittide_row_mean does in
// bittide_tiled.cu.  A draw's bits therefore equal the fused and tiled
// kernels' and the plain PyTorch version's
// (bittide_step.py::bittide_perstep_torch).
//
// Guard.  One device-resident int, *trip, holds the draw's first trip
// record (num_records when none), lowered with atomicMin by the measure
// pass.  Every launch of record t reads it first and, when it is below t,
// only carries the state across the ping-pong pair: the nu record
// re-emits the frozen nu and the beta record is zeros (the reference's
// lax.cond(live, ..., frozen)).  The host issues no launch past the stop
// cap.
//
// Bound.  Bytes: every period reads the whole stack, C*N^2*4 bytes
// (453.5 MB at torus3d(22), C = 1: 0.135 ms at 3.35 TB/s), for 2*C*N^2
// flops.  A design this simple leaves the card mostly idle: one draw
// gives only N threads, each a serial chain of C*N dependent adds, so the
// loads in flight are few; the unrolled inner loop keeps kUnroll loads of
// each thread in flight.  Making it fast is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;    // destination rows per CTA
constexpr int kTileJ = 256;     // sources staged in shared memory
constexpr int kMeanThreads = 256;
constexpr int kMeanTile = 1024;

struct Params {
  const float* at;        // (C, N, N) source-major
  const float* nu_u;      // (N,)
  const float* mask;      // (N,)
  const float* deg;       // (N,)
  const float* lamsum;    // (N,)
  const float* lat;       // (C,)
  const float* psi_in;    // (N,) state before the pass
  const float* nu_in;
  float* psi_out;         // (N,) state after a period
  float* nu_out;
  float* freq_t;          // (N,) nu record of this record, or null
  float* beta_t;          // (N,) beta record of this record, or null
  float* wm_bmax;         // (N,) watermarks, or null
  int* wm_idx;
  float* wm_lo;
  float* wm_hi;
  const float* mean;      // row mean of psi for the measure pass
  int* trip;              // first trip record, or null without the guard
  float kp, beta_off, dt_frames, guard_lo, guard_hi;
  int N, C, t;
};

// One period (kMeasure = false) or one record's measure pass (true).
template <bool kMeasure>
__global__ void __launch_bounds__(kThreads)
bittide_step_pass(const Params p) {
  __shared__ float s_x[kTileJ];
  const int N = p.N;
  const int i = blockIdx.x * kThreads + threadIdx.x;

  if (p.trip != nullptr && *p.trip < p.t) {
    // Frozen by an earlier trip (the same word for every thread).
    if (i < N) {
      if (!kMeasure) {
        const float nu = p.nu_in[i];
        p.psi_out[i] = p.psi_in[i];
        p.nu_out[i] = nu;
        if (p.freq_t != nullptr) p.freq_t[i] = nu;
      } else if (p.beta_t != nullptr) {
        p.beta_t[i] = 0.f;
      }
    }
    return;
  }

  const float mean = kMeasure ? *p.mean : 0.f;
  const int ii = i < N ? i : N - 1;   // rows past N compute on node N-1
                                      // and write nothing
  float acc = 0.f;
  for (int c = 0; c < p.C; ++c) {
    const float lat = p.lat[c];
    const float* col = p.at + (size_t)c * N * N + ii;
    float part = 0.f;
    for (int j0 = 0; j0 < N; j0 += kTileJ) {
      const int tj = min(kTileJ, N - j0);
      __syncthreads();                 // the previous tile has been read
      for (int k = threadIdx.x; k < tj; k += kThreads) {
        const float ps = kMeasure ? __fsub_rn(p.psi_in[j0 + k], mean)
                                  : p.psi_in[j0 + k];
        s_x[k] = __fsub_rn(ps, __fmul_rn(p.nu_in[j0 + k], lat));
      }
      __syncthreads();
      const float* a = col + (size_t)j0 * N;
#pragma unroll 16
      for (int k = 0; k < tj; ++k)
        part = __fadd_rn(part, __fmul_rn(__ldg(a + (size_t)k * N), s_x[k]));
    }
    acc = __fadd_rn(acc, part);
  }
  if (i >= N) return;

  const float psi = p.psi_in[i];
  const float nu = p.nu_in[i];
  const float deg = p.deg[i];
  const float lamsum = p.lamsum[i];
  if (!kMeasure) {
    const float err = __fadd_rn(
        __fsub_rn(acc, __fmul_rn(__fadd_rn(psi, p.beta_off), deg)), lamsum);
    const float c_rel = __fmul_rn(p.kp, err);
    const float nu_u = p.nu_u[i];
    float nu_next = __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
    if (!(p.mask[i] > 0.5f)) nu_next = nu;
    p.psi_out[i] = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
    p.nu_out[i] = nu_next;
    if (p.freq_t != nullptr) p.freq_t[i] = nu_next;
    return;
  }
  const float bnode = __fadd_rn(
      __fsub_rn(acc, __fmul_rn(__fsub_rn(psi, mean), deg)), lamsum);
  if (p.beta_t != nullptr) p.beta_t[i] = bnode;
  if (p.wm_bmax != nullptr) {
    // Strict > keeps the FIRST record reaching the max (np.argmax).
    const float babs = fabsf(bnode);
    if (p.t == 0) {
      p.wm_bmax[i] = babs;
      p.wm_idx[i] = 0;
      p.wm_lo[i] = nu;
      p.wm_hi[i] = nu;
    } else {
      const float bmax = p.wm_bmax[i];
      if (babs > bmax) p.wm_idx[i] = p.t;
      p.wm_bmax[i] = fmaxf(bmax, babs);
      p.wm_lo[i] = fminf(p.wm_lo[i], nu);
      p.wm_hi[i] = fmaxf(p.wm_hi[i], nu);
    }
  }
  if (p.trip != nullptr) {
    // Strict inequalities: a node of degree 0 (beta == 0) never trips.
    if (bnode > __fmul_rn(p.guard_hi, deg) ||
        bnode < __fmul_rn(p.guard_lo, deg))
      atomicMin(p.trip, p.t);
  }
}

// Row mean of psi, summed j = 0..N-1 in order by one thread from tiles the
// CTA stages in shared memory, divided by the true quotient.
__global__ void __launch_bounds__(kMeanThreads)
bittide_step_mean(const float* psi, int N, float* mean, const int* trip,
                  int t) {
  __shared__ float s_psi[kMeanTile];
  if (trip != nullptr && *trip < t) return;
  float sum = 0.f;
  for (int j0 = 0; j0 < N; j0 += kMeanTile) {
    const int tj = min(kMeanTile, N - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < tj; k += kMeanThreads)
      s_psi[k] = psi[j0 + k];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < tj; ++k) sum = __fadd_rn(sum, s_psi[k]);
    }
  }
  if (threadIdx.x == 0) *mean = __fdiv_rn(sum, (float)N);
}

}  // namespace


// Plain C entry point (loaded with ctypes).  Runs records 0..last_record of
// num_records x record_every periods of one draw, plus the measure pass
// (row mean, then beta / watermarks / guard) per record when beta, wm_bmax
// or trip is given.  psi_buf / nu_buf are (2, N) ping-pong pairs whose
// slot 0 holds the initial state; after the call the state is in slot
// (launched periods) % 2.  trip must hold the sentinel num_records on
// entry.  kp, beta_off, dt_frames, the guard band (frames per unit degree)
// and the stop cap are runtime arguments.  Returns the first CUDA error of
// a launch (0 when every launch was accepted); nothing here synchronizes.
extern "C" int bittide_step_launch(
    const float* at, const float* nu_u, const float* mask, const float* deg,
    const float* lamsum, const float* lat, float kp, float beta_off,
    float dt_frames, int N, int C, int num_records, int record_every,
    int last_record, float* psi_buf, float* nu_buf, float* freq, float* beta,
    float* wm_bmax, int* wm_idx, float* wm_lo, float* wm_hi, float guard_lo,
    float guard_hi, int* trip, float* mean, void* stream) {
  if (C < 1 || N < 1 || num_records < 1 || record_every < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool measure = beta != nullptr || wm_bmax != nullptr ||
                       trip != nullptr;
  const int grid = (N + kThreads - 1) / kThreads;
  Params p{at, nu_u, mask, deg, lamsum, lat,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, mean, trip,
           kp, beta_off, dt_frames, guard_lo, guard_hi, N, C, 0};
  int cur = 0;
  const int t_end = min(num_records, last_record + 1);
  for (int t = 0; t < t_end; ++t) {
    p.t = t;
    p.beta_t = nullptr;
    p.wm_bmax = nullptr;
    p.wm_idx = nullptr;
    p.wm_lo = nullptr;
    p.wm_hi = nullptr;
    for (int s = 0; s < record_every; ++s) {
      p.psi_in = psi_buf + (size_t)cur * N;
      p.nu_in = nu_buf + (size_t)cur * N;
      p.psi_out = psi_buf + (size_t)(1 - cur) * N;
      p.nu_out = nu_buf + (size_t)(1 - cur) * N;
      p.freq_t = s == record_every - 1 ? freq + (size_t)t * N : nullptr;
      bittide_step_pass<false><<<grid, kThreads, 0, st>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      cur = 1 - cur;
    }
    if (!measure) continue;
    p.psi_in = psi_buf + (size_t)cur * N;
    p.nu_in = nu_buf + (size_t)cur * N;
    p.psi_out = nullptr;
    p.nu_out = nullptr;
    p.freq_t = nullptr;
    p.beta_t = beta != nullptr ? beta + (size_t)t * N : nullptr;
    p.wm_bmax = wm_bmax;
    p.wm_idx = wm_idx;
    p.wm_lo = wm_lo;
    p.wm_hi = wm_hi;
    bittide_step_mean<<<1, kMeanThreads, 0, st>>>(p.psi_in, N, mean, trip, t);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bittide_step_pass<true><<<grid, kThreads, 0, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
