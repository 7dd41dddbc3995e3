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
// Bound.  Every period reads the whole stack, C*N^2*4 bytes (453.5 MB at
// torus3d(22), C = 1), far above the 50 MB L2, for 2*C*N^2 flops: memory-
// bound, at least 0.135 ms per pass at 3.35 TB/s, which needs about
// 3.4 MB of loads in flight across the card (some 25 KB per SM).  One
// draw gives only N rows, each a serial chain of C*N dependent adds
// (about 24 us at torus3d(22)), so the loads in flight must not depend on
// how many threads there are.
//
// Design.  The one-draw, scalar-parameter case of bittide_tiled.cu's
// stream (bittide_stream.cuh).  A CTA owns kTileI = 32 destination rows,
// one lane each in one consumer warp, and a producer warp streams the
// (C*N, 32) column block of the stack its rows need through a ring of
// kStages = 4 panels of kTileJ = 32 sources (4 KB of A and 128 B of x
// each, 17 KB of shared memory): one TMA copy per panel, completion
// counted on a per-stage mbarrier with expect_tx, the consumer releasing
// each stage on another, no __syncthreads in the stream.  At torus3d(22)
// that is 333 CTAs of 64 threads, two or three per SM, each with up to
// four panels in flight.  The depth and panel height are the fastest of
// scripts/torch_ring_sweep.py's sweep on the H100 (PERF.md): for one draw,
// shorter panels and a shallower ring streamed faster than the tiled
// kernel's 64-source panels and deeper rings; 64 rows per CTA, no
// faster.  x_c = psi - nu * lat[c] is computed once per period: the
// epilogue of the period that produced psi' and nu' writes x' of its
// rows into a (C, NP) ping-pong array that the next period streams
// beside A; the first period of a call computes it from the state in the
// producer warp, and the row-mean launch of a measure pass writes the
// centred x.  A stack that TMA cannot address (N % 4 != 0, or a start
// that is not 16-byte aligned) is copied 4 bytes at a time with cp.async
// into the same ring, with the same bits.  The state lives in device
// memory as a ping-pong pair (a period reads slot cur and writes slot
// 1 - cur), and the record loop runs here in C, every launch on the
// caller's stream with no sync: one chunk is one call.
//
// Numbers.  float32 with explicit round-to-nearest intrinsics, no fused
// multiply-add, one accumulator per row and class summed over j = 0..N-1
// in order, then over the classes in order: the order of bittide_fused.cu
// and bittide_tiled.cu; the row mean is summed j = 0..N-1 in order and
// divided by the true quotient, as in bittide_tiled.cu.  A draw's bits
// therefore equal the fused and tiled kernels' and the plain PyTorch
// version's (bittide_step.py::bittide_perstep_torch).
//
// Guard.  One device-resident int, *trip, holds the draw's first trip
// record (num_records when none), lowered with atomicMin by the measure
// pass.  Every launch of record t reads it first and, when it is below t,
// only carries the state (psi, nu and x) across the ping-pong pair: the
// nu record re-emits the frozen nu and the beta record is zeros (the
// reference's lax.cond(live, ..., frozen)).  The host issues no launch
// past the stop cap.

#include "bittide_fold.cuh"
#include "bittide_stream.cuh"

namespace {

using namespace bittide_stream;

constexpr int kTileI = 32;   // destination rows per CTA
constexpr int kTileJ = 32;   // sources per panel
constexpr int kWarps = kTileI / 32 + 1;   // consumers, then the producer
constexpr int kStages = 4;   // panels in the ring

struct alignas(64) Params {
  CUtensorMap map;        // the stack as (C*N, N) when tma
  const float* at;        // (C, N, N) source-major
  const float* nu_u;      // (N,)
  const float* mask;      // (N,)
  const float* deg;       // (N,)
  const float* lamsum;    // (N,)
  const float* lat;       // (C,)
  const float* psi_in;    // (N,) state before the pass
  const float* nu_in;
  const float* x_in;      // (C, NP) x of that state, or null
  float* psi_out;         // (N,) state after a period
  float* nu_out;
  float* x_out;           // x of the state after a period
  float* freq_t;          // (N,) nu record of this record, or null
  float* beta_t;          // (N,) beta record of this record, or null
  float* wm_bmax;         // (N,) watermarks, or null
  int* wm_idx;
  float* wm_lo;
  float* wm_hi;
  const float* mean;      // row mean of psi for the measure pass
  int* trip;              // first trip record, or null without the guard
  float kp, beta_off, dt_frames, guard_lo, guard_hi;
  int N, C, NP, t;
  bool tma;
};

// x' of node i for every class.
__device__ __forceinline__ void write_x(const Params& p, int i, float psi,
                                        float nu) {
  for (int c = 0; c < p.C; ++c)
    p.x_out[(size_t)c * p.NP + i] = __fsub_rn(psi, __fmul_rn(nu, p.lat[c]));
}

// One period (kMeasure = false) or one record's measure pass (true).
template <bool kMeasure>
__global__ void __launch_bounds__(32 * kWarps)
bittide_step_pass(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int i0 = blockIdx.x * kTileI;
  const int i = i0 + 32 * w + lane;           // consumer warp w's row

  if (p.trip != nullptr && *p.trip < p.t) {
    // Frozen by an earlier trip (the same word for every thread).
    if (w < kWarps - 1 && i < N) {
      if (!kMeasure) {
        const float psi = p.psi_in[i], nu = p.nu_in[i];
        p.psi_out[i] = psi;
        p.nu_out[i] = nu;
        write_x(p, i, psi, nu);
        if (p.freq_t != nullptr) p.freq_t[i] = nu;
      } else if (p.beta_t != nullptr) {
        p.beta_t[i] = 0.f;
      }
    }
    return;
  }

  const Source src{p.at, p.x_in, p.psi_in, p.nu_in, p.lat, 1, i0, N, p.C,
                   p.NP, p.tma};
  Ring<1, kTileI, kTileJ, kStages> ring(smem);
  ring.init(src, kWarps - 1);
  if (w == kWarps - 1) {
    ring.produce(&p.map, src, lane);
    return;
  }
  float acc[1];
  ring.consume<1>(N, p.C, 32 * w + lane, 0, acc);
  if (i >= N) return;

  const float psi = p.psi_in[i];
  const float nu = p.nu_in[i];
  const float deg = p.deg[i];
  const float lamsum = p.lamsum[i];
  if (!kMeasure) {
    const float err = __fadd_rn(
        __fsub_rn(acc[0], __fmul_rn(__fadd_rn(psi, p.beta_off), deg)),
        lamsum);
    const float c_rel = __fmul_rn(p.kp, err);
    const float nu_u = p.nu_u[i];
    float nu_next = __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
    if (!(p.mask[i] > 0.5f)) nu_next = nu;
    const float psi_next = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
    p.psi_out[i] = psi_next;
    p.nu_out[i] = nu_next;
    write_x(p, i, psi_next, nu_next);
    if (p.freq_t != nullptr) p.freq_t[i] = nu_next;
    return;
  }
  const float mean = *p.mean;
  const float bnode = __fadd_rn(
      __fsub_rn(acc[0], __fmul_rn(__fsub_rn(psi, mean), deg)), lamsum);
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
      p.wm_bmax[i] = max_nan(bmax, babs);
      p.wm_lo[i] = min_nan(p.wm_lo[i], nu);
      p.wm_hi[i] = max_nan(p.wm_hi[i], nu);
    }
  }
  if (p.trip != nullptr) {
    // Strict inequalities: a node of degree 0 (beta == 0) never trips.
    if (bnode > __fmul_rn(p.guard_hi, deg) ||
        bnode < __fmul_rn(p.guard_lo, deg))
      atomicMin(p.trip, p.t);
  }
}

// The row mean of psi (one CTA; summed j = 0..N-1 in order and divided by
// the true quotient) and the centred x of the measure pass.
__global__ void __launch_bounds__(kMeanThreads)
bittide_step_mean(const float* psi, const float* nu, const float* lat, int N,
                  int C, int NP, float* mean, float* x, const int* trip,
                  int t) {
  if (trip != nullptr && *trip < t) return;
  row_mean_and_x(psi, nu, lat, N, C, NP, 1, mean, x);
}

}  // namespace


// Launch geometry: out = {dynamic shared memory bytes, CTAs resident per
// SM, ring stages, rows per CTA, sources per panel}.  Returns a CUDA
// error code.
extern "C" int bittide_step_plan(int* out) {
  const int smem = smem_bytes(1, kTileI, kTileJ, kStages);
  cudaError_t e = cudaFuncSetAttribute(
      bittide_step_pass<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, bittide_step_pass<false>, 32 * kWarps, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = smem;
  out[1] = ctas;
  out[2] = kStages;
  out[3] = kTileI;
  out[4] = kTileJ;
  return 0;
}

// Plain C entry point (loaded with ctypes).  Runs records 0..last_record of
// num_records x record_every periods of one draw, plus the measure pass
// (row mean, then beta / watermarks / guard) per record when beta, wm_bmax
// or trip is given.  psi_buf / nu_buf are (2, N) ping-pong pairs whose
// slot 0 holds the initial state; after the call the state is in slot
// (launched periods) % 2.  x_buf is scratch of 2 * C * NP floats (NP = N
// rounded up to 32).  trip must hold the sentinel num_records on entry.
// kp, beta_off, dt_frames, the guard band (frames per unit degree) and the
// stop cap are runtime arguments.  Returns the first CUDA error of a
// launch (0 when every launch was accepted); nothing here synchronizes.
extern "C" int bittide_step_launch(
    const float* at, const float* nu_u, const float* mask, const float* deg,
    const float* lamsum, const float* lat, float kp, float beta_off,
    float dt_frames, int N, int C, int num_records, int record_every,
    int last_record, float* psi_buf, float* nu_buf, float* freq, float* beta,
    float* wm_bmax, int* wm_idx, float* wm_lo, float* wm_hi, float guard_lo,
    float guard_hi, int* trip, float* mean, float* x_buf, void* stream) {
  if (C < 1 || N < 1 || num_records < 1 || record_every < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool measure = beta != nullptr || wm_bmax != nullptr ||
                       trip != nullptr;
  const int grid = (N + kTileI - 1) / kTileI;
  const dim3 block(32, kWarps);
  const int smem = smem_bytes(1, kTileI, kTileJ, kStages);
  const size_t xn = x_slot_floats(1, C, N, 1, kTileJ);
  const void* kernels[] = {(const void*)bittide_step_pass<false>,
                           (const void*)bittide_step_pass<true>};
  for (const void* kernel : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p{};
  p.tma = stack_tma_ok(at, N);
  if (p.tma) {
    const int e = encode_stack_map(&p.map, at, N, C, kTileI, kTileJ);
    if (e != 0) return e;
  }
  p.at = at;
  p.nu_u = nu_u;
  p.mask = mask;
  p.deg = deg;
  p.lamsum = lamsum;
  p.lat = lat;
  p.mean = mean;
  p.trip = trip;
  p.kp = kp;
  p.beta_off = beta_off;
  p.dt_frames = dt_frames;
  p.guard_lo = guard_lo;
  p.guard_hi = guard_hi;
  p.N = N;
  p.C = C;
  p.NP = padded_nodes(N, kTileJ);
  int cur = 0;
  bool first = true;
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
      p.x_in = first ? nullptr : x_buf + cur * xn;
      p.psi_out = psi_buf + (size_t)(1 - cur) * N;
      p.nu_out = nu_buf + (size_t)(1 - cur) * N;
      p.x_out = x_buf + (1 - cur) * xn;
      p.freq_t = s == record_every - 1 ? freq + (size_t)t * N : nullptr;
      bittide_step_pass<false><<<grid, block, smem, st>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      cur = 1 - cur;
      first = false;
    }
    if (!measure) continue;
    // The centred x goes to the free slot; the next period overwrites it.
    p.psi_in = psi_buf + (size_t)cur * N;
    p.nu_in = nu_buf + (size_t)cur * N;
    p.x_in = x_buf + (1 - cur) * xn;
    p.psi_out = nullptr;
    p.nu_out = nullptr;
    p.x_out = nullptr;
    p.freq_t = nullptr;
    p.beta_t = beta != nullptr ? beta + (size_t)t * N : nullptr;
    p.wm_bmax = wm_bmax;
    p.wm_idx = wm_idx;
    p.wm_lo = wm_lo;
    p.wm_hi = wm_hi;
    bittide_step_mean<<<1, kMeanThreads, 0, st>>>(
        p.psi_in, p.nu_in, lat, N, C, p.NP, mean, x_buf + (1 - cur) * xn,
        trip, t);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bittide_step_pass<true><<<grid, block, smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
