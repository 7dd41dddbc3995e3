"""Measure, on the CUDA card, the cycle latencies that chip_smoke.py's
fused-kernel latency bound (``fused_latency_bound``) counts.

One CTA runs each probe alone and times its loop with ``clock64()``:

* ``fadd`` / ``fmul``: a dependent chain of ``__fadd_rn`` / ``__fmul_rn``
  (one thread), cycles per operation;
* ``warp``: one round of the fused kernel's warp path with x in shared
  memory — store x, ``__syncwarp``, the ``__any_sync`` vote, load a
  neighbour's x, add — less one add;
* ``shfl``: one round of its shuffle path — ``__shfl_sync`` of a
  neighbour's x, add — less one add;
* ``block_<T>``: one round of its block path at T threads — store x,
  ``__syncthreads_or`` vote, load a neighbour's x, add — less one add.

Each probe runs 4,096 rounds, five times; the least is kept.  Prints one
JSON object with the cycles and the card's name and power limit.  Run on
the card machine (no arguments):

    python3 scripts/torch_latency_probe.py

It builds ``build/latency_probe/libprobe.so`` with nvcc (a few seconds).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kRounds = 4096;

__global__ void chain(int mul, float x, float y, long long* cyc,
                      float* out) {
  float a = x;
  const long long t0 = clock64();
  if (mul) {
#pragma unroll 64
    for (int k = 0; k < kRounds; ++k) a = __fmul_rn(a, y);
  } else {
#pragma unroll 64
    for (int k = 0; k < kRounds; ++k) a = __fadd_rn(a, y);
  }
  const long long t1 = clock64();
  out[0] = a;
  cyc[0] = t1 - t0;
}

__global__ void warp_round(int shfl, float x0, long long* cyc, float* out) {
  __shared__ float buf[2 * 32];
  const int lane = threadIdx.x & 31, next = (lane + 1) & 31;
  float x = x0 + lane;
  __syncwarp();
  const long long t0 = clock64();
  if (shfl) {
#pragma unroll 16
    for (int k = 0; k < kRounds; ++k)
      x = __fadd_rn(x, __shfl_sync(0xffffffffu, x, next));
  } else {
#pragma unroll 16
    for (int k = 0; k < kRounds; ++k) {
      float* b = buf + (k & 1) * 32;
      b[lane] = x;
      __syncwarp();
      const bool v = __any_sync(0xffffffffu, !isfinite(x));
      x = __fadd_rn(x, b[next]);
      if (v) x = 0.f;
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}

__global__ void block_round(float x0, long long* cyc, float* out) {
  extern __shared__ float buf[];
  const int t = threadIdx.x, n = blockDim.x, next = (t + 1) % n;
  float x = x0 + t;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < kRounds; ++k) {
    float* b = buf + (k & 1) * n;
    b[t] = x;
    const int v = __syncthreads_or(!isfinite(x));
    x = __fadd_rn(x, b[next]);
    if (v) x = 0.f;
  }
  const long long t1 = clock64();
  out[t] = x;
  if (t == 0) cyc[0] = t1 - t0;
}

}  // namespace

// which: 0 fadd, 1 fmul, 2 warp, 3 shfl, 4 block of `threads`.  Writes the
// cycles of kRounds rounds to *cycles; returns a CUDA error (0: none).
extern "C" int probe(int which, int threads, long long* cycles) {
  long long* cyc = nullptr;
  float* out = nullptr;
  cudaError_t e = cudaMalloc(&cyc, sizeof(long long));
  if (e == cudaSuccess) e = cudaMalloc(&out, sizeof(float) * 1024);
  if (e != cudaSuccess) return (int)e;
  if (which <= 1)
    chain<<<1, 1>>>(which, 1.0f, 1.0000001f, cyc, out);
  else if (which <= 3)
    warp_round<<<1, 32>>>(which == 3, 1.0f, cyc, out);
  else
    block_round<<<1, threads, 2 * threads * sizeof(float)>>>(1.0f, cyc,
                                                              out);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpy(cycles, cyc, sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(cyc);
  cudaFree(out);
  return (int)e;
}

extern "C" int rounds(void) { return kRounds; }
"""


def build_probe() -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    out = ROOT / "build" / "latency_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE)
    lib = out / "libprobe.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                    str(out / "probe.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    lib = build_probe()
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_longlong)]
    n = lib.rounds()

    def cycles(which, threads=0) -> float:
        best = None
        for _ in range(5):
            got = ctypes.c_longlong()
            rc = lib.probe(which, threads, ctypes.byref(got))
            if rc != 0:
                raise RuntimeError(f"probe {which} failed: CUDA error {rc}")
            best = got.value if best is None else min(best, got.value)
        return best / n

    fadd = cycles(0)
    res = dict(card=smi, rounds=n, fadd=fadd, fmul=cycles(1),
               warp=cycles(2) - fadd, shfl=cycles(3) - fadd)
    for threads in (64, 128, 216, 512, 1024):
        res[f"block_{threads}"] = cycles(4, threads) - fadd
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
