// Block-sparse SpMV y = A·x over row-padded BSR tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmv.py (bsr_spmv, body
// _kernel), the aggregation of the `bsr` backend.  A is stored as R block
// rows of J tile slots: blocks (R, J, BS, BS) float32 or bfloat16 tiles,
// block_cols (R, J) int32 with -1 on empty slots; x has C·BS entries and y
// R·BS float32 entries.  For block row i and tile row r:
//   y[i·BS + r] = sum over slots j in order, block_cols[i, j] >= 0, of
//                 s_j = sum over c in order of blocks[i, j, r, c] · x[col·BS + c]
// Tiles and x are widened to float32, as the TPU kernel casts them.
//
// Design: one thread per output row (i, r), blocks of 256 threads, grid
// ceil(R·BS / 256), the ragged last block masked; any BS works (8, 16, 32,
// 128 are the ones tested).  The BS threads of a block row read each slot's
// column id once (a broadcast within the warp) and all skip an empty slot.
// Every operation is rounded on its own (__fmul_rn / __fadd_rn, never a
// contracted FMA), in the order of the plain PyTorch version
// repro_torch/kernels/bsr_spmv.py::bsr_spmv_ref, so the two give the same
// bits.  Offsets into `blocks` are 64-bit: R·J·BS² passes 2^31 at BS = 128
// on large graphs.
//
// Bound: the tiles are read once, R·J·BS²·(4 or 2) bytes, and dominate; the
// column ids add 4·R·J, x 4·C·BS, y 4·R·BS.  x (under 1 MB on the main path)
// stays in the 50 MB L2.  With BS = 8 a warp covers four block rows; per
// slot each thread reads its 32-byte tile row, so a warp's loads fall in
// four 256-byte tiles.  No tensor cores: on kNN graphs the touched tiles are
// ~2% full at BS = 8 (PERF.md), so the work is the bytes, and fp32 through
// TF32 would break bit-equality with the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void bsr_spmv_kernel(const T* __restrict__ blocks,
                                const int32_t* __restrict__ cols,
                                const T* __restrict__ x, float* __restrict__ y,
                                int n_rows, int j_slots, int bs) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_rows) return;
  const int i = g / bs;
  const int r = g - i * bs;
  const int32_t* ci = cols + (long long)i * j_slots;
  float acc = 0.0f;
  for (int j = 0; j < j_slots; ++j) {
    const int32_t col = ci[j];
    if (col < 0) continue;
    const T* a = blocks + (((long long)i * j_slots + j) * bs + r) * bs;
    const T* xs = x + (long long)col * bs;
    float s = 0.0f;
    for (int c = 0; c < bs; ++c) {
      s = __fadd_rn(s, __fmul_rn(widen(a[c]), widen(xs[c])));
    }
    acc = __fadd_rn(acc, s);
  }
  y[g] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, types, contiguity and that n_rows = R·BS > 0.
extern "C" int bsr_spmv(const void* blocks, const void* cols, const void* x,
                        void* y, int n_rows, int j_slots, int bs, int is_bf16,
                        void* stream) {
  const int grid = (n_rows + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    bsr_spmv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)blocks, (const int32_t*)cols,
        (const __nv_bfloat16*)x, (float*)y, n_rows, j_slots, bs);
  } else {
    bsr_spmv_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)blocks, (const int32_t*)cols, (const float*)x,
        (float*)y, n_rows, j_slots, bs);
  }
  return (int)cudaGetLastError();
}
