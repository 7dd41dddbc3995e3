// Sparse ELL multi-period bittide engine for Hopper (sm_90a).
//
// Replaces repro/kernels/bittide_sparse.py::_sparse_kernel, the Pallas
// engine for bounded-degree networks of 10^5-10^6 nodes (torus3d(100):
// 1,000,000 nodes, 6,000,000 edges).  Per period, per draw b and node i,
// over the slot-major ELL tables nbr (K, N), latf and w ((1|B), K, N):
//
//   acc_i  = sum_k w[k,i] * (psi[nbr[k,i]] - nu[nbr[k,i]] * latf[k,i])
//   deg_i  = sum_k w[k,i]
//   err_i  = acc_i - (psi_i + beta_off[b]) * deg_i + lamsum[b,i]
//   nu'_i  = nu_u_i + c_i + nu_u_i * c_i,  c_i = kp[b] * err_i
//   nu'_i  = nu_i where the node is in holdover (mask <= 0.5)
//   psi'_i = psi_i + nu'_i * dt_frames
//
// with the nu record at every record point and the optional measure pass
// (beta with psi centred by its row mean, watermarks, reframing guard).
//
// Launches.  On the TPU the (B, N) state lives whole in VMEM and the table
// panels stream past it; staging buffers hold a period's updates until
// its last panel commits them.  At 10^6 nodes x 8 draws the state is 32 MB
// per array, far beyond one SM, and CTAs run in no order.  So one period
// is one launch (the launch loop is written here in C, all launches on
// the caller's stream with no sync), and the state lives in device memory
// as a ping-pong pair: a period reads buffer `cur` and writes `1 - cur`,
// so its gathers only ever read the state from before the period, which
// takes the place of the staging buffers.  A record's measure pass is
// three launches: chunk sums of psi (contiguous chunks of kMeanChunk
// nodes, each summed in order), the chunk sums summed in order and
// divided by N, and the aggregation of the centred state.
//
// Two passes, by the plan (bittide_step.py::sparse_launch_plan, handed in
// and checked here).  Direct: a thread owns one (draw, node) pair and sums
// k = 0..K-1 in order; a CTA covers `tile` consecutive nodes of one draw,
// and the draw index runs fastest over the CTAs, so a shared table row is
// read from device memory once and from L2 by the other draws.  Per-draw
// tables pass a row stride of K*N, shared ones a stride of 0: one kernel
// instance serves both.  At torus3d(100) x 8 that reads each node's slots
// once per draw through L2 (0.58 GB of table reads per period, where
// device memory must deliver 0.072 GB), and the pass runs at L2's pace.  Grouped,
// for shared tables and a state too large for L2: a thread owns a node
// and a group of up to kGroupMax draws, loads each slot's nbr, latf and w
// once for the group (one deg per node), and runs the draws from
// registers with one accumulator each; the next slot's entries load while
// this slot gathers.  The gathers of psi[nbr] and nu[nbr] read device
// memory through L1 / L2 (no shared-memory window: its staging and
// barrier cost more than the near gathers it would serve).  Below 8 MiB of
// (B, N) psi + nu the state lives in L2, a pass is a chain of short
// latencies, and the direct pass's more resident threads win; per-draw
// tables share only nbr and always run direct.
//
// Numbers.  float32 with explicit round-to-nearest intrinsics in the
// reference's order (acc = acc + w*(g_psi - g_nu*lat); err = acc -
// (psi_i + beta_off)*deg + lamsum; nu' = nu_u + c + nu_u*c), each (b, i)
// summing k = 0..K-1 in order, deg in the same order, no atomics in any
// sum.  A draw's bits therefore depend neither on B, nor on the pass, nor
// on whether its tables are shared, and equal the plain PyTorch
// version's (bittide_sparse.py::bittide_sparse_torch).
//
// Guard.  One device-resident int, *trip_min, holds the batch's earliest
// trip record (num_records when none), lowered with atomicMin (order
// free).  Every launch of record t reads it first and, when it is below
// t, does nothing but carry the state across the ping-pong pair;
// launches on one stream run in order, so the batch-wide freeze is exact
// with no host sync.  The host issues no launch past guard_stop.
//
// Bound.  Memory.  A period reads the tables once, (4 + 8R)*K*N bytes
// (R = 1 shared, B per-draw), and moves about 24*B*N bytes of state (psi,
// nu, nu_u, lamsum read; psi', nu' written) against about (5K + 12)*B*N
// float operations.  At torus3d(100), B = 8, R = 1, K = 6 that is
// 0.072 + 0.192 = 0.264 GB per period, at least 0.079 ms at 3.35 TB/s,
// against 0.34 GFLOP (0.005 ms at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bittide_fold.cuh"

namespace {

constexpr int kMeanChunk = 1024;   // nodes per first-level chunk of the mean
constexpr int kMeanWarps = 4;      // chunks per CTA of the chunk sums
constexpr int kTile = 256;         // most nodes per CTA, one thread each
constexpr int kGroupMax = 8;       // draws per thread of the grouped pass

struct Params {
  const int* nbr;         // (K, N)
  const float* latf;      // (R_l, K, N)
  const float* w;         // (R_w, K, N)
  long long latf_stride;  // K*N per-draw, 0 shared
  long long w_stride;
  const float* nu_u;      // (B, N)
  const float* kp;        // (B,)
  const float* beta_off;  // (B,)
  const float* mask;      // (mask_rows, N)
  const float* lamsum;    // (B, N)
  const float* psi_in;    // (B, N) state before the pass
  const float* nu_in;
  float* psi_out;         // (B, N) state after a period pass
  float* nu_out;
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
  int B, N, K, mask_rows, t;
  int group;              // grouped pass: draws per thread
};

// The plan of the last accepted call (bittide_sparse_plan).
int g_plan[6] = {0, 0, 0, 0, 0, 0};

// The period's update of one (draw, node) from its aggregate.
__device__ __forceinline__ void period_out(const Params& p, int b,
                                           size_t row, int i, float acc,
                                           float deg) {
  const float psi = p.psi_in[row];
  const float nu = p.nu_in[row];
  const float err = __fadd_rn(
      __fsub_rn(acc, __fmul_rn(__fadd_rn(psi, p.beta_off[b]), deg)),
      p.lamsum[row]);
  const float c_rel = __fmul_rn(p.kp[b], err);
  const float nu_u = p.nu_u[row];
  float nu_next = __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
  const bool enabled =
      p.mask[(p.mask_rows == 1 ? (size_t)0 : (size_t)b * p.N) + i] > 0.5f;
  if (!enabled) nu_next = nu;
  p.psi_out[row] = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
  p.nu_out[row] = nu_next;
  if (p.freq_t != nullptr) p.freq_t[row] = nu_next;
}

// The measure pass's outputs for one (draw, node): beta, the watermarks,
// the guard.
__device__ __forceinline__ void measure_out(const Params& p, int b,
                                            size_t row, float acc,
                                            float deg, float mean) {
  const float nu = p.nu_in[row];
  const float bnode = __fadd_rn(
      __fsub_rn(acc, __fmul_rn(__fsub_rn(p.psi_in[row], mean), deg)),
      p.lamsum[row]);
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
    // Every writer of a draw's trip at record t writes t.
    if (bnode > __fmul_rn(p.guard_hi[b], deg) ||
        bnode < __fmul_rn(p.guard_lo[b], deg)) {
      p.trip[b] = p.t;
      atomicMin(p.trip_min, p.t);
    }
  }
}

// Frozen by an earlier trip: carry a (draw, node) to the other buffer.
__device__ __forceinline__ void carry(const Params& p, size_t row) {
  p.psi_out[row] = p.psi_in[row];
  p.nu_out[row] = p.nu_in[row];
}

// Direct pass: one thread per (draw, node), the draw fastest over the
// CTAs.  One period (kMeasure = false) or one record's measure pass.
template <bool kMeasure>
__global__ void bittide_sparse_direct(const Params p) {
  const int b = blockIdx.x % p.B;
  const int i = (blockIdx.x / p.B) * blockDim.x + threadIdx.x;
  if (i >= p.N) return;
  const size_t row = (size_t)b * p.N + i;
  if (p.trip_min != nullptr && *p.trip_min < p.t) {
    if (!kMeasure) carry(p, row);
    return;
  }

  const float* psi_b = p.psi_in + (size_t)b * p.N;
  const float* nu_b = p.nu_in + (size_t)b * p.N;
  const float* lat = p.latf + (size_t)b * (size_t)p.latf_stride;
  const float* wt = p.w + (size_t)b * (size_t)p.w_stride;
  const float mean = kMeasure ? p.mean[b] : 0.f;
  float acc = 0.f, deg = 0.f;
  for (int k = 0; k < p.K; ++k) {
    const size_t s = (size_t)k * p.N + i;
    const int j = p.nbr[s];
    const float wk = wt[s];
    const float g_psi = kMeasure ? __fsub_rn(psi_b[j], mean) : psi_b[j];
    acc = __fadd_rn(acc,
                    __fmul_rn(wk, __fsub_rn(g_psi, __fmul_rn(nu_b[j], lat[s]))));
    deg = __fadd_rn(deg, wk);
  }
  if (kMeasure)
    measure_out(p, b, row, acc, deg, mean);
  else
    period_out(p, b, row, i, acc, deg);
}

// Grouped pass, shared tables: one thread per node runs the p.group draws
// of CTA row blockIdx.y, with one slot load and one deg for all of them.
template <bool kMeasure>
__global__ void __launch_bounds__(kTile) bittide_sparse_grouped(
    const Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.y * p.group;
  const int gn = min(p.group, p.B - b0);
  if (i >= p.N) return;
  if (p.trip_min != nullptr && *p.trip_min < p.t) {
    if (!kMeasure)
      for (int d = 0; d < gn; ++d) carry(p, (size_t)(b0 + d) * p.N + i);
    return;
  }
  float mean[kGroupMax], acc[kGroupMax], deg = 0.f;
#pragma unroll
  for (int d = 0; d < kGroupMax; ++d) {
    mean[d] = kMeasure && d < gn ? p.mean[b0 + d] : 0.f;
    acc[d] = 0.f;
  }
  // Slot k's entries; the next slot's load while this one gathers.
  int j_next = p.nbr[i];
  float lat_next = p.latf[i], w_next = p.w[i];
  for (int k = 0; k < p.K; ++k) {
    const size_t s = (size_t)k * p.N + i;
    const int j = j_next;
    const float lk = lat_next, wk = w_next;
    if (k + 1 < p.K) {
      j_next = p.nbr[s + p.N];
      lat_next = p.latf[s + p.N];
      w_next = p.w[s + p.N];
    }
    deg = __fadd_rn(deg, wk);
#pragma unroll
    for (int d = 0; d < kGroupMax; ++d) {
      if (d < gn) {
        const size_t b = (size_t)(b0 + d);
        const float gp = p.psi_in[b * p.N + j];
        const float gv = p.nu_in[b * p.N + j];
        const float g_psi = kMeasure ? __fsub_rn(gp, mean[d]) : gp;
        acc[d] = __fadd_rn(
            acc[d], __fmul_rn(wk, __fsub_rn(g_psi, __fmul_rn(gv, lk))));
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kGroupMax; ++d) {
    if (d >= gn) break;
    const size_t row = (size_t)(b0 + d) * p.N + i;
    if (kMeasure)
      measure_out(p, b0 + d, row, acc[d], deg, mean[d]);
    else
      period_out(p, b0 + d, row, i, acc[d], deg);
  }
}

// First level of the row mean: partial[b*chunks + c] = the sum, in order,
// of psi[b, c*kMeanChunk .. min(N, (c+1)*kMeanChunk) - 1].  One warp per
// (draw, chunk) stages the chunk in shared memory with coalesced loads;
// its lane 0 sums it in order.
__global__ void __launch_bounds__(32 * kMeanWarps)
    bittide_chunk_sums(const float* psi, int B, int N, int chunks,
                       float* partial, const int* trip_min, int t) {
  __shared__ float stage[kMeanWarps][kMeanChunk];
  if (trip_min != nullptr && *trip_min < t) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long idx = (long long)blockIdx.x * kMeanWarps + warp;
  if (idx >= (long long)B * chunks) return;
  const int b = (int)(idx / chunks), c = (int)(idx - (long long)b * chunks);
  const float* r = psi + (size_t)b * N + (size_t)c * kMeanChunk;
  const int len = min(kMeanChunk, N - c * kMeanChunk);
  float* s = stage[warp];
  for (int j = lane; j < len; j += 32) s[j] = r[j];
  __syncwarp();
  if (lane != 0) return;
  float sum = 0.f;
#pragma unroll 8
  for (int j = 0; j < len; ++j) sum = __fadd_rn(sum, s[j]);
  partial[idx] = sum;
}

// Second level, one CTA per draw: the chunk sums staged in shared memory
// with coalesced loads, summed in order by thread 0, by the true quotient.
__global__ void bittide_chunk_mean(const float* partial, int N, int chunks,
                                   float* mean, const int* trip_min, int t) {
  __shared__ float stage[kMeanChunk];
  if (trip_min != nullptr && *trip_min < t) return;
  const float* r = partial + (size_t)blockIdx.x * chunks;
  float sum = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += kMeanChunk) {
    const int len = min(kMeanChunk, chunks - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < len; c += blockDim.x) stage[c] = r[c0 + c];
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int c = 0; c < len; ++c) sum = __fadd_rn(sum, stage[c]);
    }
  }
  if (threadIdx.x == 0) mean[blockIdx.x] = __fdiv_rn(sum, (float)N);
}

// One pass by the plan: the direct kernel over tiles x B CTAs (the draw
// fastest), or the grouped one over a (tiles, groups) grid.
template <bool kMeasure>
void launch_pass(bool grouped, int tiles, int groups, int tile,
                 cudaStream_t st, const Params& p) {
  if (grouped)
    bittide_sparse_grouped<kMeasure>
        <<<dim3(tiles, groups), tile, 0, st>>>(p);
  else
    bittide_sparse_direct<kMeasure><<<tiles * groups, tile, 0, st>>>(p);
}

}  // namespace

// The plan of the last accepted call: out = {grouped, nodes per CTA, draws
// per thread, CTAs over the nodes, CTAs over the draws, slots K}.
extern "C" void bittide_sparse_plan(int* out) {
  for (int k = 0; k < 6; ++k) out[k] = g_plan[k];
}

// Plain C entry point (loaded with ctypes).  Runs records 0..last_record
// of num_records x record_every periods, plus a measure pass per record
// when beta, wm_bmax or trip is given.  psi_buf / nu_buf are (2, B, N)
// ping-pong pairs whose slot 0 holds the initial state; after the call the
// state is in slot (launched periods) % 2.  trip / trip_min must hold the
// sentinel num_records on entry.  partial holds B * ceil(N / 1024) floats
// and mean B.  grouped, tile and group are the launch plan
// (bittide_step.py::sparse_launch_plan), refused here when the kernels
// cannot run it: tile a multiple of 32 up to kTile; direct with one draw
// per thread; grouped only for shared tables, with 1..kGroupMax draws per
// thread.  Returns the first CUDA error of a launch (0 when every launch
// was accepted); nothing here synchronizes.
extern "C" int bittide_sparse_launch(
    const int* nbr, const float* latf, long long latf_stride, const float* w,
    long long w_stride, const float* nu_u, const float* kp,
    const float* beta_off, const float* mask, int mask_rows,
    const float* lamsum, float dt_frames, int B, int N, int K,
    int num_records, int record_every, int last_record, int grouped,
    int tile, int group, float* psi_buf, float* nu_buf, float* freq,
    float* beta, float* wm_bmax, int* wm_idx, float* wm_lo, float* wm_hi,
    const float* guard_lo, const float* guard_hi, int* trip, int* trip_min,
    float* partial, float* mean, void* stream) {
  const bool shared = latf_stride == 0 && w_stride == 0;
  if (K < 1 || N < 1 || B < 1 || tile < 32 || tile > kTile || tile % 32 ||
      (grouped ? !shared || group < 1 || group > min(B, kGroupMax)
               : group != 1))
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)N + tile - 1) / tile;
  const long long groups = ((long long)B + group - 1) / group;
  const int chunks = (N + kMeanChunk - 1) / kMeanChunk;
  const long long sum_ctas =
      ((long long)B * chunks + kMeanWarps - 1) / kMeanWarps;
  if ((grouped && groups > 65535) || tiles * groups > 0x7fffffffLL ||
      sum_ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool measure = beta != nullptr || wm_bmax != nullptr ||
                       trip != nullptr;
  const size_t bn = (size_t)B * N;
  Params p{nbr, latf, w, latf_stride, w_stride, nu_u, kp, beta_off, mask,
           lamsum, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, mean, guard_lo, guard_hi,
           trip, trip_min, dt_frames, B, N, K, mask_rows, 0, group};
  const int plan[6] = {grouped != 0, tile, group, (int)tiles, (int)groups,
                       K};
  for (int k = 0; k < 6; ++k) g_plan[k] = plan[k];
  int cur = 0;
  const int t_end = min(num_records, last_record + 1);
  for (int t = 0; t < t_end; ++t) {
    p.t = t;
    p.beta_t = nullptr;
    p.wm_bmax = nullptr;
    for (int s = 0; s < record_every; ++s) {
      p.psi_in = psi_buf + cur * bn;
      p.nu_in = nu_buf + cur * bn;
      p.psi_out = psi_buf + (1 - cur) * bn;
      p.nu_out = nu_buf + (1 - cur) * bn;
      p.freq_t = s == record_every - 1 ? freq + t * bn : nullptr;
      launch_pass<false>(grouped, (int)tiles, (int)groups, tile, st, p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      cur = 1 - cur;
    }
    if (!measure) continue;
    p.psi_in = psi_buf + cur * bn;
    p.nu_in = nu_buf + cur * bn;
    p.freq_t = nullptr;
    p.beta_t = beta != nullptr ? beta + t * bn : nullptr;
    p.wm_bmax = wm_bmax;
    p.wm_idx = wm_idx;
    p.wm_lo = wm_lo;
    p.wm_hi = wm_hi;
    bittide_chunk_sums<<<(unsigned)sum_ctas, 32 * kMeanWarps, 0, st>>>(
        p.psi_in, B, N, chunks, partial, trip_min, t);
    bittide_chunk_mean<<<B, 128, 0, st>>>(partial, N, chunks, mean,
                                         trip_min, t);
    launch_pass<true>(grouped, (int)tiles, (int)groups, tile, st, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
