// Fused cosine argkmin over the device embedding store, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/argkmin.py
// (_argkmin_pallas_impl, body _kernel).  For a batch of M normalized rows
// already appended to a store of C rows (row == global vertex id) it
// computes w = (batch . store^T + 1) / 2 and returns
//   val, idx (M, TK): per batch row the top-TK store rows under the order
//                     (w desc, row asc), masking dead rows and the row's own
//                     store row (base_id + i); empty slots are (-inf, -1);
//   disp (C,):        valid & row < base_id & max_{valid batch rows} w
//                     > kth - slack (the rows a batch may displace).
//
// Arithmetic: every dot product sums D terms in order 0..D-1, each multiply
// and add rounded on its own (__fmul_rn / __fadd_rn, no FMA, no tensor
// cores), then w = (s + 1) * 0.5 as two rounded ops.  The plain PyTorch
// version in repro_torch/kernels/argkmin.py does the same ops in the same
// order, so both give the same bits.  TF32 (~1e-3 error) would swamp the
// selection slack of 1e-5 + 1e-7 * D.
//
// Design: three launches on one stream.
//  1. argkmin_tile_kernel<D>: grid (ceil(M / 128), S).  A block owns 128
//     batch rows (one per thread, its row held in registers) and one
//     contiguous split of the store rows.  It walks its split in tiles of
//     about 4096 / D rows staged in shared memory (every thread reads the
//     same store row: a broadcast), four store rows per step so that four
//     independent dot products hide each other's latency.  Each thread
//     keeps its own top-TK list in registers, inserting a row only when it
//     beats the list's last entry, so ties keep the lower row.  For each
//     store row the block also reduces max_i w over its valid batch rows
//     (warp shuffles, then the four warps through shared memory) into
//     pcol[blockIdx.x][row].
//  2. argkmin_merge_kernel: one thread per batch row merges the S split
//     lists in split order.  Splits are ascending row ranges, so inserting
//     only strictly better entries keeps the (w desc, row asc) order.
//  3. argkmin_disp_kernel: one thread per store row reduces pcol over the
//     row blocks and writes disp.
// Blocks run in no order; nothing carries from one to the next except
// through the scratch buffers pval, pidx (S, M, TK) and pcol
// (ceil(M / 128), C), which the caller allocates.
//
// Bound: operation-bound.  2 M C D flops (a multiply and an add per term)
// against 67 TFLOP/s of fp32 outside the tensor cores; that peak counts an
// FMA as two flops, and the no-FMA rule runs the multiply and the add
// separately, so half of it is the most this arithmetic can reach.  The
// bytes (C D 4 + M D 4 + 9 C + 8 M TK) take microseconds at 3.35 TB/s.
// Beside the dot, each (batch row, store row) pair costs a compare and a
// share of a warp shuffle reduction.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;        // batch rows per block, one per thread
constexpr int kTkMax = 32;        // compile-time bound on TK (the wrapper checks)
constexpr int kTileFloats = 4096; // store tile in shared memory: 4096 / D rows
constexpr int kWarps = kRows / 32;
constexpr int kRowStep = 4;       // store rows per step of a thread's inner loop

// Insert (w, j) into the list (v, ix), sorted by value desc then index asc
// over its first tk entries, after every entry >= w; the caller has checked
// w > v[tk - 1].  Fully unrolled so the list stays in registers.
__device__ __forceinline__ void topk_insert(float (&v)[kTkMax], int (&ix)[kTkMax],
                                            int tk, float w, int j, float& worst) {
#pragma unroll
  for (int p = kTkMax - 1; p >= 0; --p) {
    if (p < tk) {
      const float prev = v[p > 0 ? p - 1 : 0];
      if (p > 0 && prev < w) {  // shift down
        v[p] = prev;
        ix[p] = ix[p > 0 ? p - 1 : 0];
      } else if (v[p] < w) {  // the first entry below w: w goes here
        v[p] = w;
        ix[p] = j;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kTkMax; ++p)
    if (p == tk - 1) worst = v[p];
}

template <int D>
__global__ void __launch_bounds__(kRows) argkmin_tile_kernel(
    const float* __restrict__ store, const uint8_t* __restrict__ valid,
    const float* __restrict__ batch, const uint8_t* __restrict__ bvalid,
    float* __restrict__ pval, int* __restrict__ pidx, float* __restrict__ pcol,
    int c, int m, int tk, int split_len, int base_id) {
  constexpr int kTileRows = (kTileFloats / D) / kRowStep * kRowStep;
  __shared__ __align__(16) float tile[kTileRows * D];
  __shared__ uint8_t tvalid[kTileRows];
  __shared__ float wmax[kWarps][kTileRows];

  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + t;  // this thread's batch row
  const bool active = i < m;
  const bool qvalid = active && bvalid[i];
  const int self_row = base_id + i;
  const int lo = blockIdx.y * split_len;
  const int hi = min(c, lo + split_len);

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = active ? batch[(size_t)i * D + d] : 0.0f;

  float v[kTkMax];
  int ix[kTkMax];
#pragma unroll
  for (int p = 0; p < kTkMax; ++p) {
    v[p] = -CUDART_INF_F;
    ix[p] = -1;
  }
  float worst = -CUDART_INF_F;

  for (int t0 = lo; t0 < hi; t0 += kTileRows) {
    const int rows = min(kTileRows, hi - t0);
    __syncthreads();  // the previous tile and its wmax are consumed
    const float4* src = reinterpret_cast<const float4*>(store + (size_t)t0 * D);
    float4* dst = reinterpret_cast<float4*>(tile);
    for (int e = t; e < kTileRows * D / 4; e += kRows)
      dst[e] = (e * 4) / D < rows ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = t; r < kTileRows; r += kRows) tvalid[r] = r < rows ? valid[t0 + r] : 0;
    __syncthreads();

    // kRowStep store rows at a time: independent dot products and shuffle
    // chains interleave; rows past `rows` read the zero-filled tile tail
    for (int r0 = 0; r0 < rows; r0 += kRowStep) {
      float acc[kRowStep];
#pragma unroll
      for (int u = 0; u < kRowStep; ++u) acc[u] = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int u = 0; u < kRowStep; ++u)
          acc[u] = __fadd_rn(acc[u], __fmul_rn(q[d], tile[(r0 + u) * D + d]));
      }
      float cm[kRowStep];
#pragma unroll
      for (int u = 0; u < kRowStep; ++u) {  // in row order: ties keep the lower row
        const int r = r0 + u;
        const int j = t0 + r;
        const float w = __fmul_rn(__fadd_rn(acc[u], 1.0f), 0.5f);
        if (active && tvalid[r] && j != self_row && w > worst) topk_insert(v, ix, tk, w, j, worst);
        cm[u] = qvalid ? w : -CUDART_INF_F;
      }
      // column max over this warp's valid batch rows (every thread takes part)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kRowStep; ++u)
          cm[u] = fmaxf(cm[u], __shfl_xor_sync(0xffffffffu, cm[u], off));
      }
      if ((t & 31) == 0) {
#pragma unroll
        for (int u = 0; u < kRowStep; ++u) wmax[t >> 5][r0 + u] = cm[u];
      }
    }
    __syncthreads();
    for (int r = t; r < rows; r += kRows) {
      const int j = t0 + r;
      float cm = -CUDART_INF_F;
      if (tvalid[r] && j < base_id) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) cm = fmaxf(cm, wmax[w][r]);
      }
      pcol[(size_t)blockIdx.x * c + j] = cm;
    }
  }

  if (active) {
    const size_t out = ((size_t)blockIdx.y * m + i) * tk;
#pragma unroll
    for (int p = 0; p < kTkMax; ++p) {
      if (p < tk) {
        pval[out + p] = v[p];
        pidx[out + p] = ix[p];
      }
    }
  }
}

__global__ void argkmin_merge_kernel(const float* __restrict__ pval,
                                     const int* __restrict__ pidx,
                                     float* __restrict__ val, int* __restrict__ idx,
                                     int m, int tk, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float v[kTkMax];
  int ix[kTkMax];
#pragma unroll
  for (int p = 0; p < kTkMax; ++p) {
    v[p] = -CUDART_INF_F;
    ix[p] = -1;
  }
  float worst = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) {
    const size_t base = ((size_t)s * m + i) * tk;
    for (int p = 0; p < tk; ++p) {
      const float w = pval[base + p];
      if (!(w > worst)) break;  // the rest of this list ranks below the kept entries
      topk_insert(v, ix, tk, w, pidx[base + p], worst);
    }
  }
#pragma unroll
  for (int p = 0; p < kTkMax; ++p) {
    if (p < tk) {
      val[(size_t)i * tk + p] = v[p];
      idx[(size_t)i * tk + p] = ix[p];
    }
  }
}

__global__ void argkmin_disp_kernel(const float* __restrict__ pcol,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ kth,
                                    uint8_t* __restrict__ disp, int c, int row_blocks,
                                    int base_id, float slack) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c) return;
  uint8_t out = 0;
  if (valid[j] && j < base_id) {
    float cm = -CUDART_INF_F;
    for (int b = 0; b < row_blocks; ++b) cm = fmaxf(cm, pcol[(size_t)b * c + j]);
    out = cm > __fsub_rn(kth[j], slack) ? 1 : 0;
  }
  disp[j] = out;
}

}  // namespace

#define REPRO_ARGKMIN_CASE(DD)                                                   \
  case DD:                                                                       \
    argkmin_tile_kernel<DD><<<grid, kRows, 0, s>>>(                              \
        (const float*)store, (const uint8_t*)valid, (const float*)batch,         \
        (const uint8_t*)bvalid, (float*)pval, (int*)pidx, (float*)pcol, c, m,    \
        tk, split_len, base_id);                                                 \
    break;

// Launches the three kernels on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for a D the kernel is not built for).  The
// caller has checked shapes, types, contiguity, 16-byte alignment of
// `store`, 8 <= D <= 128 with D % 8 == 0, 1 <= tk <= 32, m, c >= 1, and that
// c * D and base_id + m fit in 32 bits.
extern "C" int argkmin(const void* store, const void* valid, const void* kth,
                       const void* batch, const void* bvalid, void* val, void* idx,
                       void* disp, void* pval, void* pidx, void* pcol, int c, int d,
                       int m, int tk, int splits, int base_id, float slack,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int row_blocks = (m + kRows - 1) / kRows;
  const int split_len = (c + splits - 1) / splits;
  const dim3 grid(row_blocks, splits);
  switch (d) {
    REPRO_ARGKMIN_CASE(8)
    REPRO_ARGKMIN_CASE(16)
    REPRO_ARGKMIN_CASE(24)
    REPRO_ARGKMIN_CASE(32)
    REPRO_ARGKMIN_CASE(40)
    REPRO_ARGKMIN_CASE(48)
    REPRO_ARGKMIN_CASE(56)
    REPRO_ARGKMIN_CASE(64)
    REPRO_ARGKMIN_CASE(72)
    REPRO_ARGKMIN_CASE(80)
    REPRO_ARGKMIN_CASE(88)
    REPRO_ARGKMIN_CASE(96)
    REPRO_ARGKMIN_CASE(104)
    REPRO_ARGKMIN_CASE(112)
    REPRO_ARGKMIN_CASE(120)
    REPRO_ARGKMIN_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argkmin_merge_kernel<<<(m + 255) / 256, 256, 0, s>>>(
      (const float*)pval, (const int*)pidx, (float*)val, (int*)idx, m, tk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argkmin_disp_kernel<<<(c + 255) / 256, 256, 0, s>>>(
      (const float*)pcol, (const uint8_t*)valid, (const float*)kth, (uint8_t*)disp, c,
      row_blocks, base_id, slack);
  return (int)cudaGetLastError();
}
