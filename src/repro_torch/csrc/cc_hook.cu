// One fused Shiloach–Vishkin hook + jump step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/cc_hook.py (cc_hook_step,
// body _kernel).  Over an ELL adjacency nbr (N, K) int32 (PAD = -1) and a
// parent vector par (N,) int32, per row u:
//   hooked = min(par[u], min over valid lanes v of par[v])
//   out[u] = par[hooked]
// The jump reads the PREVIOUS parent vector (the TPU kernel's VMEM-resident
// input), so the step is a pure function of (nbr, par).  Integer min and
// gathers are exact: the output equals the plain PyTorch version
// repro_torch/kernels/cc_hook.py::cc_hook_ref exactly.
//
// Design: one thread per row, blocks of 256 threads, grid ceil(N / 256),
// the ragged last block masked.  Bound: nbr read once (4K bytes a row), par
// read for the own entry and the jump and out written (12 bytes a row):
// N·(4K + 12) bytes; the neighbor gathers of par (4N bytes, under 1 MB on
// the main path) are L2 hits.  Adjacent threads read rows 4K bytes apart,
// so a warp's nbr loads are strided and served through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void cc_hook_kernel(const int32_t* __restrict__ nbr,
                               const int32_t* __restrict__ par,
                               int32_t* __restrict__ out, int n, int k) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n) return;
  const int32_t* nu = nbr + (long long)u * k;
  int32_t hooked = par[u];
  for (int j = 0; j < k; ++j) {
    const int32_t v = nu[j];
    if (v >= 0) hooked = min(hooked, par[v]);
  }
  out[u] = par[hooked];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, types, contiguity and that n > 0.
extern "C" int cc_hook_step(const void* nbr, const void* par, void* out, int n,
                            int k, void* stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  cc_hook_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)par, (int32_t*)out, n, k);
  return (int)cudaGetLastError();
}
