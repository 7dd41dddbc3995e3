// Tiled multi-period bittide engine for Hopper (sm_90a).
//
// Replaces repro/kernels/bittide_step.py::_tiled_kernel, the Pallas engine
// for dense networks whose (C, N, N) adjacency does not fit on chip (the
// Fig-18 tori, e.g. torus3d(22) with N = 10,648).  It computes the same
// contract as bittide_fused.cu: per period, per draw b and node i,
//
//   acc_i  = sum_c sum_j A[c,i,j] * (psi_j - nu_j * lat[b,c])
//   err_i  = acc_i - (psi_i + beta_off[b]) * deg_i + lamsum[b,i]
//   nu'_i  = nu_u_i + c_i + nu_u_i * c_i,  c_i = kp[b] * err_i
//   nu'_i  = nu_i where the node is in holdover (mask <= 0.5)
//   psi'_i = psi_i + nu'_i * dt_frames
//
// with the nu record at every record point and the optional measure pass
// (beta with psi centred by its row mean, watermarks, reframing guard).
//
// Bound.  Every pass reads the whole stack, C*N^2*4 bytes (453.5 MB at
// torus3d(22), C = 1), far above the 50 MB L2, against 2*C*N^2*B
// multiply-adds: memory-bound, at least 0.135 ms per pass at 3.35 TB/s.
// To stream at that rate the card needs about 3.4 MB of loads in flight
// (some 25 KB per SM), and the multiply-adds (a separate _rn multiply and
// add each, 2*C*N^2*B/32 warp instructions) must issue under the stream.
//
// Design.  The TPU kernel runs its grid (record, period, j panel) in
// order and carries the state in VMEM scratch; CTAs on the H100 run in
// no order and carry nothing.  So one period is one launch (the launch
// loop is written here in C, all launches on the caller's stream with no
// sync), and the state lives in device memory as a ping-pong pair: a
// period reads buffer `cur` and writes buffer `1 - cur`.  A CTA owns
// kTileI = 32 destination rows (the lanes) for a group of up to kMaxGroup
// draws: kDrawsPerWarp draws per consumer warp, one accumulator per draw
// in each thread, so each shared-memory read of A feeds four
// multiply-adds and one 16-byte read gives x of the warp's four draws.
// The column block of the stack its rows need streams through the ring of
// bittide_stream.cuh: kStages = 4 panels of kTileJ = 64 sources x 32 rows
// (8 KB of A and 2 KB of x each, 41 KB of shared memory) per CTA, filled
// by one producer warp with a TMA copy per panel and drained by the
// consumers on per-stage mbarriers.  At torus3d(22) x 8 draws that is 333
// CTAs of 96 threads, two or three per SM (five would fit), so 64-96 KB
// of A can be in flight per SM.  The depth and panel height are the
// fastest of scripts/torch_ring_sweep.py's sweep on the H100 (PERF.md):
// deeper rings, other panels and 64 rows per CTA streamed no faster.
// x_c = psi - nu * lat_c is computed once per period: the epilogue of
// the period that produced psi' and nu' writes x' of its rows into a
// (groups, C, NP, 8) ping-pong array, and the next period streams it
// beside A; the first period of a call computes it from the state in the
// producer warp, and the row-mean launch of a measure pass writes the
// centred x.  A stack that TMA cannot address (N % 4 != 0, or a start
// that is not 16-byte aligned) is copied 4 bytes at a time by the
// producer lanes with cp.async into the same ring, with the same bits.
//
// Numbers.  float32 with explicit round-to-nearest intrinsics and one
// accumulator per (b, i) summed over classes in order and j = 0..N-1 in
// order: the order of bittide_fused.cu.  A draw's bits therefore depend
// neither on B nor on the launch layout, and equal the fused kernel's and
// the plain PyTorch version's (bittide_step.py::bittide_tiled_torch).
//
// Guard.  One device-resident int, *trip_min, holds the batch's earliest
// trip record (num_records when none).  Every launch of record t reads it
// first and, when it is below t, does nothing but carry the state (psi,
// nu and x) across the ping-pong pair; launches on one stream run in
// order, so the batch-wide freeze is exact with no host sync.  The host
// issues no launch past guard_stop.

#include "bittide_fold.cuh"
#include "bittide_stream.cuh"

namespace {

using namespace bittide_stream;

constexpr int kTileI = 32;         // destination rows per CTA
constexpr int kTileJ = 64;         // sources per panel
constexpr int kStages = 4;         // panels in the ring
constexpr int kMaxGroup = 8;       // draws per CTA (the x panel's width)
constexpr int kDrawsPerWarp = 4;   // accumulators per thread

struct alignas(64) Params {
  CUtensorMap map;        // the stack as (C*N, N) when tma
  const float* at;        // (C, N, N) source-major
  const float* nu_u;      // (B, N)
  const float* kp;        // (B,)
  const float* beta_off;  // (B,)
  const float* mask;      // (mask_rows, N)
  const float* deg;       // (N,)
  const float* lamsum;    // (B, N)
  const float* lat;       // (B, C)
  const float* psi_in;    // (B, N) state before the pass
  const float* nu_in;
  const float* x_in;      // (groups, C, NP, 8) x of that state, or null
  float* psi_out;         // (B, N) state after a period pass
  float* nu_out;
  float* x_out;           // x of the state after a period pass
  float* freq_t;          // (B, N) nu record of this record, or null
  float* beta_t;          // (B, N) beta record of this record, or null
  float* wm_bmax;         // (B, N) watermarks, or null
  int* wm_idx;
  float* wm_lo;
  float* wm_hi;
  const float* mean;      // (B,) row mean of psi for the measure pass
  const float* guard_lo;  // (B,) guard band, frames per degree, or null
  const float* guard_hi;
  int* trip;              // (B,) first trip record, or null
  int* trip_min;          // earliest trip record of the batch, or null
  float dt_frames;
  int B, N, C, NP, mask_rows, t;
  bool tma;
};

// x' of one draw's node i for every class, into its group's x array.
__device__ __forceinline__ void write_x(const Params& p, float* x, int b,
                                        int i, float psi, float nu) {
  for (int c = 0; c < p.C; ++c)
    x[((size_t)c * p.NP + i) * kMaxGroup + b % kMaxGroup] =
        __fsub_rn(psi, __fmul_rn(nu, p.lat[(size_t)b * p.C + c]));
}

// One period (kMeasure = false) or one record's measure pass (true).
template <bool kMeasure>
__global__ void __launch_bounds__(
    32 * (kTileI / 32 * (kMaxGroup / kDrawsPerWarp) + 1))
bittide_tiled_pass(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N, B = p.B;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int consumers = blockDim.y - 1;      // the last warp produces
  const int i0 = blockIdx.x * kTileI;
  const int b0 = blockIdx.y * kMaxGroup;
  const int G = min(kMaxGroup, B - b0);      // draws of this group
  // Consumer warp w sums rows 32 * (w % kWarpRows) + lane for draws
  // g0..g0 + kDrawsPerWarp - 1.
  constexpr int kWarpRows = kTileI / 32;
  const int cta_row = 32 * (w % kWarpRows) + lane;
  const int i = i0 + cta_row;
  const int g0 = w / kWarpRows * kDrawsPerWarp;
  const size_t xg = (size_t)blockIdx.y * p.C * p.NP * kMaxGroup;

  if (p.trip_min != nullptr && *p.trip_min < p.t) {
    // Frozen by an earlier trip: carry the state to the other buffer.
    if (!kMeasure && w < consumers && i < N) {
      for (int k = 0; k < kDrawsPerWarp && g0 + k < G; ++k) {
        const int b = b0 + g0 + k;
        const size_t row = (size_t)b * N + i;
        const float psi = p.psi_in[row], nu = p.nu_in[row];
        p.psi_out[row] = psi;
        p.nu_out[row] = nu;
        write_x(p, p.x_out + xg, b, i, psi, nu);
      }
    }
    return;
  }

  const Source src{p.at, p.x_in == nullptr ? nullptr : p.x_in + xg,
                   p.psi_in + (size_t)b0 * N, p.nu_in + (size_t)b0 * N,
                   p.lat + (size_t)b0 * p.C, G, i0, N, p.C, p.NP, p.tma};
  Ring<kMaxGroup, kTileI, kTileJ, kStages> ring(smem);
  ring.init(src, consumers);
  if (w == consumers) {
    ring.produce(&p.map, src, lane);
    return;
  }
  float acc[kDrawsPerWarp];
  ring.consume<kDrawsPerWarp>(N, p.C, cta_row, g0, acc);

  if (i >= N) return;
  const float deg = p.deg[i];
#pragma unroll
  for (int k = 0; k < kDrawsPerWarp; ++k) {
    const int g = g0 + k;
    if (g >= G) break;
    const int b = b0 + g;
    const size_t row = (size_t)b * N + i;
    const float psi = p.psi_in[row];
    const float nu = p.nu_in[row];
    const float lamsum = p.lamsum[row];
    if (!kMeasure) {
      const float err = __fadd_rn(
          __fsub_rn(acc[k], __fmul_rn(__fadd_rn(psi, p.beta_off[b]), deg)),
          lamsum);
      const float c_rel = __fmul_rn(p.kp[b], err);
      const float nu_u = p.nu_u[row];
      float nu_next =
          __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
      const bool enabled =
          p.mask[(p.mask_rows == 1 ? (size_t)0 : (size_t)b * N) + i] > 0.5f;
      if (!enabled) nu_next = nu;
      const float psi_next = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
      p.psi_out[row] = psi_next;
      p.nu_out[row] = nu_next;
      write_x(p, p.x_out + xg, b, i, psi_next, nu_next);
      if (p.freq_t != nullptr) p.freq_t[row] = nu_next;
      continue;
    }
    const float mean = p.mean[b];
    const float bnode = __fadd_rn(
        __fsub_rn(acc[k], __fmul_rn(__fsub_rn(psi, mean), deg)), lamsum);
    if (p.beta_t != nullptr) p.beta_t[row] = bnode;
    if (p.wm_bmax != nullptr) {
      // Strict > keeps the FIRST record reaching the max (np.argmax).
      const float babs = fabsf(bnode);
      if (p.t == 0) {
        p.wm_bmax[row] = babs;
        p.wm_idx[row] = 0;
        p.wm_lo[row] = nu;
        p.wm_hi[row] = nu;
      } else {
        const float bmax = p.wm_bmax[row];
        if (babs > bmax) p.wm_idx[row] = p.t;
        p.wm_bmax[row] = max_nan(bmax, babs);
        p.wm_lo[row] = min_nan(p.wm_lo[row], nu);
        p.wm_hi[row] = max_nan(p.wm_hi[row], nu);
      }
    }
    if (p.trip != nullptr) {
      // Strict inequalities: a node of degree 0 (beta == 0) never trips.
      // Every writer of a record writes the same t, so the stores need no
      // atomics.
      if (bnode > __fmul_rn(p.guard_hi[b], deg) ||
          bnode < __fmul_rn(p.guard_lo[b], deg)) {
        p.trip[b] = p.t;
        *p.trip_min = p.t;
      }
    }
  }
}

// One CTA per draw: the row mean of psi (summed j = 0..N-1 in order, the
// fused kernel's order, divided by the true quotient) and the centred x
// of the measure pass.
__global__ void __launch_bounds__(kMeanThreads)
bittide_row_mean(const float* psi, const float* nu, const float* lat, int N,
                 int C, int NP, float* mean, float* x, const int* trip_min,
                 int t) {
  const int b = blockIdx.x;
  if (trip_min != nullptr && *trip_min < t) return;
  row_mean_and_x(psi + (size_t)b * N, nu + (size_t)b * N,
                 lat + (size_t)b * C, N, C, NP, kMaxGroup, mean + b,
                 x + (size_t)(b / kMaxGroup) * C * NP * kMaxGroup +
                     b % kMaxGroup);
}

}  // namespace


// Launch geometry for draws_per_cta draws per CTA: out = {dynamic shared
// memory bytes, CTAs resident per SM, ring stages, rows per CTA, sources
// per panel}.  Returns a CUDA error code.
extern "C" int bittide_tiled_plan(int draws_per_cta, int* out) {
  const int smem = smem_bytes(kMaxGroup, kTileI, kTileJ, kStages);
  const int threads = 32 * (kTileI / 32 *
                            ((draws_per_cta + kDrawsPerWarp - 1) /
                             kDrawsPerWarp) + 1);
  cudaError_t e = cudaFuncSetAttribute(
      bittide_tiled_pass<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, bittide_tiled_pass<false>, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = smem;
  out[1] = ctas;
  out[2] = kStages;
  out[3] = kTileI;
  out[4] = kTileJ;
  return 0;
}

// Plain C entry point (loaded with ctypes).  Runs records 0..last_record
// of num_records x record_every periods, plus a measure pass per record
// when beta, wm_bmax or trip is given.  psi_buf / nu_buf are (2, B, N)
// ping-pong pairs whose slot 0 holds the initial state; after the call the
// state is in slot (launched periods) % 2.  x_buf is scratch of
// 2 * groups * C * NP * 8 floats (groups = ceil(B / 8), NP = N rounded up
// to 64).  trip / trip_min must hold the sentinel num_records on entry.
// Returns the first CUDA error of a launch (0 when every launch was
// accepted); nothing here synchronizes.
extern "C" int bittide_tiled_launch(
    const float* at, const float* nu_u, const float* kp,
    const float* beta_off, const float* mask, int mask_rows,
    const float* deg, const float* lamsum, const float* lat, float dt_frames,
    int B, int N, int C, int num_records, int record_every, int last_record,
    int draws_per_cta, float* psi_buf, float* nu_buf, float* freq,
    float* beta, float* wm_bmax, int* wm_idx, float* wm_lo, float* wm_hi,
    const float* guard_lo, const float* guard_hi, int* trip, int* trip_min,
    float* mean, float* x_buf, void* stream) {
  if (C < 1 || N < 1 || B < 1 || draws_per_cta != min(B, kMaxGroup))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool measure = beta != nullptr || wm_bmax != nullptr ||
                       trip != nullptr;
  const int groups = (B + kMaxGroup - 1) / kMaxGroup;
  const size_t bn = (size_t)B * N;
  const size_t xn = x_slot_floats(groups, C, N, kMaxGroup, kTileJ);
  const int smem = smem_bytes(kMaxGroup, kTileI, kTileJ, kStages);
  const dim3 grid((N + kTileI - 1) / kTileI, groups);
  const dim3 block(32, kTileI / 32 *
                           ((draws_per_cta + kDrawsPerWarp - 1) /
                            kDrawsPerWarp) + 1);
  const void* kernels[] = {(const void*)bittide_tiled_pass<false>,
                           (const void*)bittide_tiled_pass<true>};
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
  p.kp = kp;
  p.beta_off = beta_off;
  p.mask = mask;
  p.deg = deg;
  p.lamsum = lamsum;
  p.lat = lat;
  p.mean = mean;
  p.guard_lo = guard_lo;
  p.guard_hi = guard_hi;
  p.trip = trip;
  p.trip_min = trip_min;
  p.dt_frames = dt_frames;
  p.B = B;
  p.N = N;
  p.C = C;
  p.NP = padded_nodes(N, kTileJ);
  p.mask_rows = mask_rows;
  int cur = 0;
  bool first = true;
  const int t_end = min(num_records, last_record + 1);
  for (int t = 0; t < t_end; ++t) {
    p.t = t;
    p.beta_t = nullptr;
    p.wm_bmax = nullptr;
    for (int s = 0; s < record_every; ++s) {
      p.psi_in = psi_buf + cur * bn;
      p.nu_in = nu_buf + cur * bn;
      p.x_in = first ? nullptr : x_buf + cur * xn;
      p.psi_out = psi_buf + (1 - cur) * bn;
      p.nu_out = nu_buf + (1 - cur) * bn;
      p.x_out = x_buf + (1 - cur) * xn;
      p.freq_t = s == record_every - 1 ? freq + t * bn : nullptr;
      bittide_tiled_pass<false><<<grid, block, smem, st>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      cur = 1 - cur;
      first = false;
    }
    if (!measure) continue;
    // The centred x goes to the free slot; the next period overwrites it.
    p.psi_in = psi_buf + cur * bn;
    p.nu_in = nu_buf + cur * bn;
    p.x_in = x_buf + (1 - cur) * xn;
    p.freq_t = nullptr;
    p.beta_t = beta != nullptr ? beta + t * bn : nullptr;
    p.wm_bmax = wm_bmax;
    p.wm_idx = wm_idx;
    p.wm_lo = wm_lo;
    p.wm_hi = wm_hi;
    bittide_row_mean<<<B, kMeanThreads, 0, st>>>(
        p.psi_in, p.nu_in, lat, N, C, p.NP, mean, x_buf + (1 - cur) * xn,
        trip_min, t);
    bittide_tiled_pass<true><<<grid, block, smem, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
