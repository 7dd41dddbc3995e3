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
// Design.  On the TPU the (B, N) state lives whole in VMEM and the table
// panels stream past it; staging buffers hold a period's updates until
// its last panel commits them.  At 10^6 nodes x 8 draws the state is 32 MB
// per array, far beyond one SM, and CTAs run in no order.  So one period
// is one launch (the launch loop is written here in C, all launches on
// the caller's stream with no sync), and the state lives in device memory
// as a ping-pong pair: a period reads buffer `cur` and writes `1 - cur`,
// so its gathers only ever read the state from before the period, which
// takes the place of the staging buffers.  A thread owns one (draw, node)
// pair and sums k = 0..K-1 in order; neighbouring threads take
// neighbouring nodes, so every slot row of the tables loads coalesced.  A
// CTA covers `tile` consecutive nodes of one draw, and the draw index
// runs fastest over the CTAs, so the CTAs of all draws over one node
// range run together and a shared table row is read from device memory
// once and from L2 by the other draws.  Per-draw tables pass a row
// stride of K*N, shared ones a stride of 0: one kernel instance serves
// both.  A record's measure pass is three launches: chunk sums of psi
// (contiguous chunks of kMeanChunk nodes, each summed in order), the
// chunk sums summed in order and divided by N, and the aggregation of
// the centred state.
//
// Numbers.  float32 with explicit round-to-nearest intrinsics in the
// reference's order (acc = acc + w*(g_psi - g_nu*lat); err = acc -
// (psi_i + beta_off)*deg + lamsum; nu' = nu_u + c + nu_u*c), deg summed
// over k in order, no atomics in any sum.  A draw's bits therefore depend
// neither on B nor on whether its tables are shared, and equal the plain
// PyTorch version's (bittide_sparse.py::bittide_sparse_torch).
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
// against 0.34 GFLOP (0.005 ms at 67 TFLOP/s).  The gathers psi[nbr] and
// nu[nbr] hit L2 for the near neighbours of a torus and device memory for
// the far ones.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMeanChunk = 1024;   // nodes per first-level chunk of the mean

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
};

// One period (kMeasure = false) or one record's measure pass (true).
template <bool kMeasure>
__global__ void bittide_sparse_pass(const Params p) {
  const int b = blockIdx.x % p.B;
  const int i = (blockIdx.x / p.B) * blockDim.x + threadIdx.x;
  if (i >= p.N) return;
  const size_t row = (size_t)b * p.N + i;

  if (p.trip_min != nullptr && *p.trip_min < p.t) {
    // Frozen by an earlier trip: carry the state to the other buffer.
    if (!kMeasure) {
      p.psi_out[row] = p.psi_in[row];
      p.nu_out[row] = p.nu_in[row];
    }
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

  const float psi = p.psi_in[row];
  const float nu = p.nu_in[row];
  const float lamsum = p.lamsum[row];
  if (!kMeasure) {
    const float err = __fadd_rn(
        __fsub_rn(acc, __fmul_rn(__fadd_rn(psi, p.beta_off[b]), deg)),
        lamsum);
    const float c_rel = __fmul_rn(p.kp[b], err);
    const float nu_u = p.nu_u[row];
    float nu_next = __fadd_rn(__fadd_rn(nu_u, c_rel), __fmul_rn(nu_u, c_rel));
    const bool enabled =
        p.mask[(p.mask_rows == 1 ? (size_t)0 : (size_t)b * p.N) + i] > 0.5f;
    if (!enabled) nu_next = nu;
    p.psi_out[row] = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
    p.nu_out[row] = nu_next;
    if (p.freq_t != nullptr) p.freq_t[row] = nu_next;
    return;
  }
  const float bnode = __fadd_rn(
      __fsub_rn(acc, __fmul_rn(__fsub_rn(psi, mean), deg)), lamsum);
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
      p.wm_bmax[row] = fmaxf(bmax, babs);
      p.wm_lo[row] = fminf(p.wm_lo[row], nu);
      p.wm_hi[row] = fmaxf(p.wm_hi[row], nu);
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

// First level of the row mean: partial[b*chunks + c] = the sum, in order,
// of psi[b, c*kMeanChunk .. min(N, (c+1)*kMeanChunk) - 1].
__global__ void bittide_chunk_sums(const float* psi, int B, int N,
                                   int chunks, float* partial,
                                   const int* trip_min, int t) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * chunks) return;
  if (trip_min != nullptr && *trip_min < t) return;
  const int b = (int)(idx / chunks), c = (int)(idx - (long long)b * chunks);
  const float* r = psi + (size_t)b * N + (size_t)c * kMeanChunk;
  const int len = min(kMeanChunk, N - c * kMeanChunk);
  float sum = 0.f;
#pragma unroll 8
  for (int j = 0; j < len; ++j) sum = __fadd_rn(sum, r[j]);
  partial[idx] = sum;
}

// Second level: the chunk sums of each draw in order, by the true quotient.
__global__ void bittide_chunk_mean(const float* partial, int B, int N,
                                   int chunks, float* mean,
                                   const int* trip_min, int t) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || (trip_min != nullptr && *trip_min < t)) return;
  const float* r = partial + (size_t)b * chunks;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum = __fadd_rn(sum, r[c]);
  mean[b] = __fdiv_rn(sum, (float)N);
}

}  // namespace


// Plain C entry point (loaded with ctypes).  Runs records 0..last_record
// of num_records x record_every periods, plus a measure pass per record
// when beta, wm_bmax or trip is given.  psi_buf / nu_buf are (2, B, N)
// ping-pong pairs whose slot 0 holds the initial state; after the call the
// state is in slot (launched periods) % 2.  trip / trip_min must hold the
// sentinel num_records on entry.  partial holds B * ceil(N / 1024) floats
// and mean B.  Returns the first CUDA error of a launch (0 when every
// launch was accepted); nothing here synchronizes.
extern "C" int bittide_sparse_launch(
    const int* nbr, const float* latf, long long latf_stride, const float* w,
    long long w_stride, const float* nu_u, const float* kp,
    const float* beta_off, const float* mask, int mask_rows,
    const float* lamsum, float dt_frames, int B, int N, int K,
    int num_records, int record_every, int last_record, int tile,
    float* psi_buf, float* nu_buf, float* freq, float* beta, float* wm_bmax,
    int* wm_idx, float* wm_lo, float* wm_hi, const float* guard_lo,
    const float* guard_hi, int* trip, int* trip_min, float* partial,
    float* mean, void* stream) {
  const long long tiles = tile > 0 ? ((long long)N + tile - 1) / tile : 0;
  if (K < 1 || N < 1 || B < 1 || tile < 32 || tile > 1024 || tile % 32 ||
      tiles * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool measure = beta != nullptr || wm_bmax != nullptr ||
                       trip != nullptr;
  const size_t bn = (size_t)B * N;
  const int chunks = (N + kMeanChunk - 1) / kMeanChunk;
  const unsigned grid = (unsigned)(tiles * B);
  const unsigned sum_grid =
      (unsigned)(((long long)B * chunks + 127) / 128);
  Params p{nbr, latf, w, latf_stride, w_stride, nu_u, kp, beta_off, mask,
           lamsum, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, mean, guard_lo, guard_hi,
           trip, trip_min, dt_frames, B, N, K, mask_rows, 0};
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
      bittide_sparse_pass<false><<<grid, tile, 0, st>>>(p);
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
    bittide_chunk_sums<<<sum_grid, 128, 0, st>>>(p.psi_in, B, N, chunks,
                                                 partial, trip_min, t);
    bittide_chunk_mean<<<(B + 127) / 128, 128, 0, st>>>(partial, B, N,
                                                        chunks, mean,
                                                        trip_min, t);
    bittide_sparse_pass<true><<<grid, tile, 0, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
