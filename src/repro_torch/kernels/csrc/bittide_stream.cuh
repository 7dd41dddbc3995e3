// The ring that streams a dense bittide stack through shared memory on
// Hopper (sm_90a), shared by bittide_tiled.cu and bittide_step.cu.
//
// Both kernels compute, per destination row i of a CTA's kTI rows and per
// draw of its group,
//
//   acc_i = sum_c ( sum_{j = 0..N-1, in order} A[c,i,j] * x_c[j] ),
//   x_c[j] = psi_j - nu_j * lat_c  (psi centred by its row mean in the
//                                   measure pass),
//
// one accumulator per (row, draw, class) summed over j in order with _rn
// intrinsics, then acc = acc + part over the classes in order.  The stack
// is passed source-major (at[(c*N + j)*N + i] = A[c][i][j]), so the rows
// a CTA needs are a (C*N, kTI) column block, read in panels of kTJ
// source rows.
//
// The ring.  kS stages in dynamic shared memory, each one panel of A
// (kTJ x kTI floats) and the x of the same kTJ sources for the group's
// draws (kTJ x kGW floats, kGW draws side by side).  Each kernel picks its
// rows kTI, panel height kTJ and depth kS (see its header).  One producer
// warp fills it and the consumer warps (32 rows each, one lane per row)
// drain it; per stage a "full" mbarrier says the panel has
// landed and an "empty" one that every consumer thread has read it, so no
// __syncthreads runs in the stream.  The producer fills a stage with
//   * the A panel: one TMA copy of a (kTJ, kTI) box of the tensor
//     map over the (C*N, N) stack, counted on the full barrier with
//     expect_tx (N % 4 == 0 and a 16-byte aligned stack), else 4-byte
//     cp.async copies by the 32 lanes, each lane arriving on the barrier
//     when its copies land (cp.async.mbarrier.arrive.noinc) — a layout
//     path for a stack that TMA cannot address, with the same bits;
//   * the x panel: one 1-D bulk copy from the x array that the previous
//     period's epilogue (or the row-mean launch, for the measure pass)
//     wrote, or, in the first period of a call, x computed by the
//     producer lanes from the state (no launch before it has written x).
// A box column past N is zero-filled by TMA and by cp.async; a panel row
// past the end of class c is never read (the consumers sum its tj rows).
//
// The x array: (groups, C, NP, kGW) floats per slot, NP = N rounded up to
// kTJ, so a panel's x is kTJ * kGW contiguous, 16-byte aligned floats.
// Two slots: a period reads one and its epilogue writes x' of its rows
// into the other, as it writes psi' and nu'.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace bittide_stream {

constexpr int kMeanThreads = 256;
constexpr int kMeanTile = 1024;

// Dynamic shared memory of a ring of `stages` panels of `tj` sources x
// `ti` rows whose x panels hold gw draws: the A panels, the x panels, then
// the full and empty barriers.
__host__ __device__ constexpr int smem_bytes(int gw, int ti, int tj,
                                             int stages) {
  return stages * (4 * tj * (ti + gw) + 16);
}

// N rounded up to whole panels of tj sources.
__host__ __device__ constexpr int padded_nodes(int N, int tj) {
  return (N + tj - 1) / tj * tj;
}

// Floats of one x slot: groups x C x NP x gw.
__host__ __device__ inline size_t x_slot_floats(int groups, int C, int N,
                                                int gw, int tj) {
  return (size_t)groups * C * padded_nodes(N, tj) * gw;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A (tj, ti) box of the stack's tensor map at column i0, row r.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map,
                                            int i0, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(bar)), "r"(i0), "r"(r) : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes, both ends 16-byte aligned.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One float; with src_bytes == 0 the destination is zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// The barrier counts one arrival once this thread's cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where one pass's panels come from.
struct Source {
  const float* at;   // (C*N, N) source-major stack
  const float* x;    // the group's x, (C, NP, gw), or null: from the state
  const float* psi;  // the group's first draw's state, rows of N (for x
  const float* nu;   //   from the state)
  const float* lat;  // the group's first draw's class latencies, rows of C
  int draws, i0, N, C, NP;
  bool tma;          // A through the tensor map, else 4-byte cp.async
};

// The ring's kS stages of (kTJ sources x kTI rows) panels in dynamic
// shared memory, x panels kGW draws wide.
template <int kGW, int kTI, int kTJ, int kS>
struct Ring {
  static_assert(kTI % 32 == 0, "whole warps of rows");
  float* a;          // kS x (kTJ x kTI)
  float* x;          // kS x (kTJ x kGW)
  uint64_t* full;    // kS
  uint64_t* empty;   // kS

  __device__ explicit Ring(unsigned char* smem)
      : a(reinterpret_cast<float*>(smem)),
        x(a + kS * kTJ * kTI),
        full(reinterpret_cast<uint64_t*>(x + kS * kTJ * kGW)),
        empty(full + kS) {}

  // Every thread of the CTA calls this once.  The full barrier counts the
  // producer's expect_tx arrival, plus one per lane when A comes by
  // cp.async and one per lane when x is computed from the state; the
  // empty barrier one per consumer thread.
  __device__ void init(const Source& s, int consumers) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      const int count = 1 + (s.tma ? 0 : 32) + (s.x ? 0 : 32);
      for (int k = 0; k < kS; ++k) {
        mbar_init(full + k, count);
        mbar_init(empty + k, 32 * consumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer warp: fill the stages with every (class, panel) in
  // order.  `map` is the stack's tensor map (read only when s.tma).
  __device__ void produce(const CUtensorMap* map, const Source& s,
                          int lane) const {
    const int panels = (s.N + kTJ - 1) / kTJ;
    const int steps = s.C * panels;
    for (int q = 0; q < steps; ++q) {
      const int st = q % kS;
      // A fresh barrier is in phase 0, so the first round passes.
      mbar_wait(empty + st, ((q / kS) & 1) ^ 1);
      const int c = q / panels, j0 = (q - c * panels) * kTJ;
      const int tj = min(kTJ, s.N - j0);
      float* sa = a + st * kTJ * kTI;
      float* sx = x + st * kTJ * kGW;
      if (lane == 0) {
        const uint32_t tx = (s.tma ? 4 * kTJ * kTI : 0) +
                            (s.x ? 4 * kTJ * kGW : 0);
        mbar_arrive_expect_tx(full + st, tx);
        if (s.tma) tma_load_2d(sa, map, s.i0, c * s.N + j0, full + st);
        if (s.x)
          bulk_load(sx, s.x + ((size_t)c * s.NP + j0) * kGW,
                    4 * kTJ * kGW, full + st);
      }
      if (!s.tma) {
        // Row jj of the panel is kTI floats at column i0; lanes take
        // columns lane, lane + 32, ...
        for (int col = lane; col < kTI; col += 32) {
          const bool in = s.i0 + col < s.N;
          const float* src =
              s.at + ((size_t)c * s.N + j0) * s.N + s.i0 + col;
          for (int jj = 0; jj < tj; ++jj)
            cp_async4(sa + jj * kTI + col,
                      in ? src + (size_t)jj * s.N : s.at, in ? 4 : 0);
        }
        cp_async_arrive(full + st);
      }
      if (s.x == nullptr) {
        for (int k = lane; k < s.draws * tj; k += 32) {
          const int g = k / tj, jj = k - g * tj;
          const size_t node = (size_t)g * s.N + j0 + jj;
          sx[jj * kGW + g] = __fsub_rn(
              s.psi[node], __fmul_rn(s.nu[node], s.lat[(size_t)g * s.C + c]));
        }
        mbar_arrive(full + st);
      }
    }
    if (!s.tma) cp_async_wait_all();
  }

  // A consumer warp: acc[k] for draw g0 + k of the group and row `row`
  // of the CTA's kTI, classes in order, j = 0..N-1 in order within each.
  template <int kDraws>
  __device__ void consume(int N, int C, int row, int g0,
                          float (&acc)[kDraws]) const {
    const int panels = (N + kTJ - 1) / kTJ;
    const int steps = C * panels;
    float part[kDraws];
#pragma unroll
    for (int k = 0; k < kDraws; ++k) acc[k] = 0.f;
    for (int q = 0; q < steps; ++q) {
      const int st = q % kS;
      mbar_wait(full + st, (q / kS) & 1);
      const int c = q / panels, pidx = q - c * panels;
      const int tj = min(kTJ, N - pidx * kTJ);
      if (pidx == 0) {
#pragma unroll
        for (int k = 0; k < kDraws; ++k) part[k] = 0.f;
      }
      const float* sa = a + st * kTJ * kTI + row;
      const float* sx = x + st * kTJ * kGW + g0;
      if (tj == kTJ) sum_panel<kDraws>(sa, sx, kTJ, part);
      else sum_panel<kDraws>(sa, sx, tj, part);
      mbar_arrive(empty + st);
      if (pidx == panels - 1) {
#pragma unroll
        for (int k = 0; k < kDraws; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
      }
    }
  }

  template <int kDraws>
  __device__ __forceinline__ static void sum_panel(const float* sa,
                                                   const float* sx, int tj,
                                                   float (&part)[kDraws]) {
    static_assert(kDraws == 1 || kDraws == 4, "1 or 4 draws per warp");
#pragma unroll 8
    for (int jj = 0; jj < tj; ++jj) {
      const float av = sa[jj * kTI];
      if constexpr (kDraws == 4) {
        const float4 xv = *reinterpret_cast<const float4*>(sx + jj * kGW);
        part[0] = __fadd_rn(part[0], __fmul_rn(av, xv.x));
        part[1] = __fadd_rn(part[1], __fmul_rn(av, xv.y));
        part[2] = __fadd_rn(part[2], __fmul_rn(av, xv.z));
        part[3] = __fadd_rn(part[3], __fmul_rn(av, xv.w));
      } else {
        part[0] = __fadd_rn(part[0], __fmul_rn(av, sx[jj * kGW]));
      }
    }
  }
};

// One CTA per draw: the row mean of psi (one thread sums j = 0..N-1 in
// order from tiles the CTA stages in shared memory, then divides by the
// true quotient), then the centred x of every class and node,
// x[(c*NP + j)*gw] = (psi_j - mean) - nu_j * lat[c], for the measure pass.
__device__ inline void row_mean_and_x(const float* psi, const float* nu,
                                      const float* lat, int N, int C, int NP,
                                      int gw, float* mean, float* x) {
  __shared__ float s_psi[kMeanTile];
  __shared__ float s_mean;
  float sum = 0.f;
  for (int j0 = 0; j0 < N; j0 += kMeanTile) {
    const int tj = min(kMeanTile, N - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < tj; k += blockDim.x) s_psi[k] = psi[j0 + k];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < tj; ++k) sum = __fadd_rn(sum, s_psi[k]);
    }
  }
  if (threadIdx.x == 0) {
    s_mean = __fdiv_rn(sum, (float)N);
    *mean = s_mean;
  }
  __syncthreads();
  const float m = s_mean;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float ps = __fsub_rn(psi[j], m);
    const float v = nu[j];
    for (int c = 0; c < C; ++c)
      x[((size_t)c * NP + j) * gw] = __fsub_rn(ps, __fmul_rn(v, lat[c]));
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the CUDA runtime
// so that the library does not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Whether TMA can address the stack: rows of 16-byte multiples and a
// 16-byte aligned start.
inline bool stack_tma_ok(const float* at, int N) {
  return N % 4 == 0 && (reinterpret_cast<uintptr_t>(at) & 15) == 0;
}

// The tensor map of the (C*N, N) float32 stack with (tj, ti) boxes;
// columns past N read as zeros.  Returns a CUDA error code.
inline int encode_stack_map(CUtensorMap* map, const float* at, int N, int C,
                            int ti, int tj) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)C * N};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)ti, (cuuint32_t)tj};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(at), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace bittide_stream
