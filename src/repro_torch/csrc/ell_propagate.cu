// Fused DynLP frontier sweep (paper Alg. 2 L23-32) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ell_propagate.py
// (ell_propagate_step, body _kernel).  Per ELL row u it gathers F[nbr],
// computes
//   nbr_term = sum_k wgt * (F_v - F_u)        (PAD lanes give 0)
//   Wall     = sum_k wgt + wl0 + wl1
//   dF       = (0 - F_u) * wl0 + (1 - F_u) * wl1 + nbr_term
//   F'       = F_u + (Wall > 0 ? dF / max(Wall, 1e-30) : 0)   on frontier rows
//   F'       = F_u                                             elsewhere
//   changed  = |F' - F_u| > delta
// with F_u = F[min(u + row_offset, Nf - 1)], so a row block can index a
// longer global F (the multi-device layout); the clamp is the TPU kernel's.
//
// Design: one thread per row, blocks of 256 threads, grid ceil(N / 256), the
// ragged last block masked.  A row off the frontier writes F_u and returns
// before its K loop, so it reads none of its nbr / wgt / wl0 / wl1 bytes.  A
// frontier row loops over K in column order 0..K-1 and rounds every
// operation on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, never
// a contracted FMA), so it gives the same bits as the plain PyTorch version
// in repro_torch/kernels/ell_propagate.py.
//
// Bound: every row reads frontier (1 byte) and writes F' and changed (5
// bytes); F is read once (4 bytes per label); a frontier row also reads its
// nbr and wgt lanes (8 bytes each) and wl0, wl1 (8 bytes):
// 6 N + 4 Nf + |frontier| (8K + 8) bytes from device memory.  F itself
// (under 1 MB on the main path) stays in the 50 MB L2, so the neighbor
// gathers are L2 hits.  Adjacent threads read rows K * 8 bytes apart, so a
// warp's nbr/wgt loads are strided, and frontier rows scattered among
// off-frontier ones leave lanes of a warp idle; a later version can stage a
// row tile through shared memory or give each row a few lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void ell_propagate_kernel(
    const int32_t* __restrict__ nbr, const float* __restrict__ wgt,
    const float* __restrict__ wl0, const float* __restrict__ wl1,
    const uint8_t* __restrict__ frontier, const float* __restrict__ f,
    float* __restrict__ fout, uint8_t* __restrict__ changed,
    int n, int k, int nf, float delta, int row_offset) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const long long g = min((long long)row + row_offset, (long long)nf - 1);
  const float fu = f[g];
  if (!frontier[row]) {  // F' = F_u; the same `changed` test as below
    fout[row] = fu;
    changed[row] = fabsf(__fsub_rn(fu, fu)) > delta ? 1 : 0;
    return;
  }
  const int32_t* nr = nbr + (long long)row * k;
  const float* wr = wgt + (long long)row * k;

  float nbr_term = 0.0f;
  float wsum = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int32_t v = nr[j];
    const float w = wr[j];
    const float d = v >= 0 ? __fsub_rn(f[v], fu) : 0.0f;
    nbr_term = __fadd_rn(nbr_term, __fmul_rn(w, d));
    wsum = __fadd_rn(wsum, w);
  }
  const float a0 = wl0[row];
  const float a1 = wl1[row];
  const float wall = __fadd_rn(__fadd_rn(wsum, a0), a1);
  const float df = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(0.0f, fu), a0),
                __fmul_rn(__fsub_rn(1.0f, fu), a1)),
      nbr_term);
  const float upd = wall > 0.0f ? __fdiv_rn(df, fmaxf(wall, 1e-30f)) : 0.0f;
  const float fnew = __fadd_rn(fu, upd);
  fout[row] = fnew;
  changed[row] = fabsf(__fsub_rn(fnew, fu)) > delta ? 1 : 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, types, contiguity and that n > 0, nf > 0.
extern "C" int ell_propagate_step(
    const void* nbr, const void* wgt, const void* wl0, const void* wl1,
    const void* frontier, const void* f, void* fout, void* changed,
    int n, int k, int nf, float delta, int row_offset, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  ell_propagate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const float*)wgt, (const float*)wl0,
      (const float*)wl1, (const uint8_t*)frontier, (const float*)f,
      (float*)fout, (uint8_t*)changed, n, k, nf, delta, row_offset);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
