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
// Design.  The TPU kernel runs its grid (record, period, j panel) in
// order and carries the state in VMEM scratch; CTAs on the H100 run in
// no order and carry nothing.  So one period is one launch (the launch
// loop is written here in C, all launches on the caller's stream with no
// sync), and the state lives in device memory as a ping-pong pair: a
// period reads buffer `cur` and writes buffer `1 - cur`, so it only ever
// reads the state from before that period.  A CTA owns TI = 32
// destination rows i (the lanes) for a group of up to kMaxGroup draws,
// kDrawsPerWarp draws per warp, each thread keeping one accumulator per
// draw; it streams the (C, N, TI) column block of the stack that its rows
// need in panels of TJ source nodes, so each A tile is read once per pass
// for every draw of the group and each shared-memory read of A feeds
// kDrawsPerWarp multiply-adds.  Panels are double-buffered with cp.async:
// the copy of panel q+1 (A tile, psi and nu of the group's draws) is in
// flight while panel q is summed.  The stack is passed source-major
// (at[(c*N + j)*N + i] = A[c][i][j]) so a panel row is TI consecutive
// floats.  A record's measure pass is two more launches: the row mean of
// psi (summed j = 0..N-1 in order) and the aggregation of the centred
// state.
//
// Numbers.  float32 with explicit round-to-nearest intrinsics and one
// accumulator per (b, i) summed over classes in order and j = 0..N-1 in
// order: the order of bittide_fused.cu.  A draw's bits therefore depend
// neither on B nor on the launch layout, and equal the fused kernel's and
// the plain PyTorch version's (bittide_step.py::bittide_tiled_torch).
//
// Guard.  One device-resident int, *trip_min, holds the batch's earliest
// trip record (num_records when none).  Every launch of record t reads it
// first and, when it is below t, does nothing but carry the state across
// the ping-pong pair; launches on one stream run in order, so the
// batch-wide freeze is exact with no host sync.  The host issues no
// launch past guard_stop.
//
// Bound.  The work is memory-bound: every pass reads the whole stack,
// C*N^2*4 bytes (453.5 MB at torus3d(22), C = 1), against 2*C*N^2*B
// multiply-adds; at 3.35 TB/s a pass costs at least 0.135 ms there.  The
// stack (4*C*N^2 bytes) must fit in device memory beside the state.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileI = 32;         // destination rows per CTA (the lanes)
constexpr int kTileJ = 64;         // source nodes per shared-memory panel
constexpr int kMaxGroup = 8;       // draws per CTA
constexpr int kDrawsPerWarp = 4;   // accumulators per thread

struct Params {
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
  int B, N, C, mask_rows, t;
};

// Asynchronous global -> shared copies (sm_80+).  With src_bytes == 0 the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Panel {
  float a[kTileJ * kTileI];      // at rows j0..j0+tj, columns i0..i0+TI
  float psi[kMaxGroup * kTileJ]; // psi of the group's draws, nodes j0..
  float nu[kMaxGroup * kTileJ];
};

// One period (kMeasure = false) or one record's measure pass (true).
template <bool kMeasure>
__global__ void bittide_tiled_pass(const Params p) {
  __shared__ __align__(16) Panel s_panel[2];
  __shared__ float s_x[kMaxGroup * kTileJ];  // x of the group's draws
  const int N = p.N, B = p.B, C = p.C;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kTileI + lane, nthreads = blockDim.y * kTileI;
  const int i0 = blockIdx.x * kTileI;
  const int b0 = blockIdx.y * kMaxGroup;
  const int G = min(kMaxGroup, B - b0);      // draws of this group
  const int i = i0 + lane;
  const int ii = i < N ? i : 0;              // lanes past N compute on
                                             // node 0 and write nothing
  const int g0 = w * kDrawsPerWarp;          // this warp's first draw

  if (p.trip_min != nullptr && *p.trip_min < p.t) {
    // Frozen by an earlier trip: carry the state to the other buffer.
    if (!kMeasure && i < N) {
      for (int k = 0; k < kDrawsPerWarp && g0 + k < G; ++k) {
        const size_t row = (size_t)(b0 + g0 + k) * N + i;
        p.psi_out[row] = p.psi_in[row];
        p.nu_out[row] = p.nu_in[row];
      }
    }
    return;
  }

  const int panels = (N + kTileJ - 1) / kTileJ;
  const int steps = C * panels;
  // A rows can be copied 16 bytes at a time when every row starts on a
  // 16-byte boundary: the stack's start is aligned, N is a multiple of 4
  // and i0 one of 32.
  const bool vec4 =
      (N % 4) == 0 && (reinterpret_cast<uintptr_t>(p.at) & 15) == 0;

  auto issue = [&](int q, Panel& dst) {
    const int c = q / panels, j0 = (q - c * panels) * kTileJ;
    const int tj = min(kTileJ, N - j0);
    const float* src = p.at + ((size_t)c * N + j0) * N + i0;
    if (vec4) {
      for (int k = tid; k < tj * (kTileI / 4); k += nthreads) {
        const int jj = k / (kTileI / 4), col = (k - jj * (kTileI / 4)) * 4;
        const bool in = i0 + col < N;
        cp_async16(dst.a + jj * kTileI + col,
                   in ? src + (size_t)jj * N + col : p.at, in ? 16 : 0);
      }
    } else {
      for (int k = tid; k < tj * kTileI; k += nthreads) {
        const int jj = k / kTileI, col = k - jj * kTileI;
        const bool in = i0 + col < N;
        cp_async4(dst.a + k, in ? src + (size_t)jj * N + col : p.at,
                  in ? 4 : 0);
      }
    }
    for (int k = tid; k < G * tj; k += nthreads) {
      const int gg = k / tj, jj = k - gg * tj;
      const size_t at = (size_t)(b0 + gg) * N + j0 + jj;
      cp_async4(dst.psi + gg * kTileJ + jj, p.psi_in + at, 4);
      cp_async4(dst.nu + gg * kTileJ + jj, p.nu_in + at, 4);
    }
    cp_async_commit();
  };

  float part[kDrawsPerWarp], acc[kDrawsPerWarp];
#pragma unroll
  for (int k = 0; k < kDrawsPerWarp; ++k) acc[k] = 0.f;
  issue(0, s_panel[0]);
  for (int q = 0; q < steps; ++q) {
    const Panel& cur = s_panel[q & 1];
    if (q + 1 < steps) issue(q + 1, s_panel[(q + 1) & 1]);
    else cp_async_commit();                  // keep the group count
    cp_async_wait_one();                     // panel q has landed
    __syncthreads();
    const int c = q / panels, pidx = q - c * panels;
    const int tj = min(kTileJ, N - pidx * kTileJ);
    if (pidx == 0) {
#pragma unroll
      for (int k = 0; k < kDrawsPerWarp; ++k) part[k] = 0.f;
    }
    // x = psi - nu * lat_c (psi centred by its row mean in the measure
    // pass), once per (draw, node) of the panel.
    for (int k = tid; k < G * tj; k += nthreads) {
      const int gg = k / tj, jj = k - gg * tj;
      const int b = b0 + gg;
      const float lat = p.lat[(size_t)b * C + c];
      const float ps = kMeasure
          ? __fsub_rn(cur.psi[gg * kTileJ + jj], p.mean[b])
          : cur.psi[gg * kTileJ + jj];
      s_x[gg * kTileJ + jj] =
          __fsub_rn(ps, __fmul_rn(cur.nu[gg * kTileJ + jj], lat));
    }
    __syncthreads();
    for (int jj = 0; jj < tj; ++jj) {
      const float a = cur.a[jj * kTileI + lane];
#pragma unroll
      for (int k = 0; k < kDrawsPerWarp; ++k)
        part[k] = __fadd_rn(part[k],
                            __fmul_rn(a, s_x[(g0 + k) * kTileJ + jj]));
    }
    if (pidx == panels - 1) {
#pragma unroll
      for (int k = 0; k < kDrawsPerWarp; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
    }
    __syncthreads();   // panel q and s_x are read before they are refilled
  }

  if (i >= N) return;
  const float deg = p.deg[ii];
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
      p.psi_out[row] = __fadd_rn(psi, __fmul_rn(nu_next, p.dt_frames));
      p.nu_out[row] = nu_next;
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
        p.wm_bmax[row] = fmaxf(bmax, babs);
        p.wm_lo[row] = fminf(p.wm_lo[row], nu);
        p.wm_hi[row] = fmaxf(p.wm_hi[row], nu);
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

// Row mean of psi per draw, summed j = 0..N-1 in order (the fused
// kernel's order) and divided by the true quotient.
__global__ void bittide_row_mean(const float* psi, int B, int N, float* mean,
                                 const int* trip_min, int t) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || (trip_min != nullptr && *trip_min < t)) return;
  const float* r = psi + (size_t)b * N;
  float sum = 0.f;
#pragma unroll 8
  for (int j = 0; j < N; ++j) sum = __fadd_rn(sum, r[j]);
  mean[b] = __fdiv_rn(sum, (float)N);
}

}  // namespace


// Plain C entry point (loaded with ctypes).  Runs records 0..last_record
// of num_records x record_every periods, plus a measure pass per record
// when beta, wm_bmax or trip is given.  psi_buf / nu_buf are (2, B, N)
// ping-pong pairs whose slot 0 holds the initial state; after the call the
// state is in slot (launched periods) % 2.  trip / trip_min must hold the
// sentinel num_records on entry.  Returns the first CUDA error of a launch
// (0 when every launch was accepted); nothing here synchronizes.
extern "C" int bittide_tiled_launch(
    const float* at, const float* nu_u, const float* kp,
    const float* beta_off, const float* mask, int mask_rows,
    const float* deg, const float* lamsum, const float* lat, float dt_frames,
    int B, int N, int C, int num_records, int record_every, int last_record,
    int draws_per_cta, float* psi_buf, float* nu_buf, float* freq,
    float* beta, float* wm_bmax, int* wm_idx, float* wm_lo, float* wm_hi,
    const float* guard_lo, const float* guard_hi, int* trip, int* trip_min,
    float* mean, void* stream) {
  if (C < 1 || N < 1 || B < 1 || draws_per_cta != min(B, kMaxGroup))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool measure = beta != nullptr || wm_bmax != nullptr ||
                       trip != nullptr;
  const size_t bn = (size_t)B * N;
  const dim3 grid((N + kTileI - 1) / kTileI,
                  (B + kMaxGroup - 1) / kMaxGroup);
  const dim3 block(kTileI,
                   (draws_per_cta + kDrawsPerWarp - 1) / kDrawsPerWarp);
  Params p{at, nu_u, kp, beta_off, mask, deg, lamsum, lat,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, mean, guard_lo, guard_hi,
           trip, trip_min, dt_frames, B, N, C, mask_rows, 0};
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
      bittide_tiled_pass<false><<<grid, block, 0, st>>>(p);
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
    bittide_row_mean<<<(B + 127) / 128, 128, 0, st>>>(p.psi_in, B, N, mean,
                                                      trip_min, t);
    bittide_tiled_pass<true><<<grid, block, 0, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
