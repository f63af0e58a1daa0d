// Canonical re-selection of a batch's kNN lists on the card, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference re-selects on the host, in numpy
// (repro/graph/dynamic.py, apply_batch: pair_weights, then topk_pairs).  For
// each of M new rows, already appended to the store at base_id + i, and its
// TK candidate ids from argkmin (-1 for an empty slot), it computes the
// canonical weight of every (row, candidate) pair and returns the top k
// under (weight desc, id asc):
//   out_idx (M, k) int64, out_w (M, k) float32, an empty or non-finite slot
//   as (-1, -inf), ties of weight and id kept in candidate order.
// These are graph.knn.topk_pairs(pair_weights(q, b), cand, k)'s bits.
//
// Arithmetic: pair_weights is numpy's float32 multiply, then numpy's sum
// over the last axis, which for D <= 128 terms is its pairwise_sum: eight
// running sums r[j] take the products j, j + 8, j + 16, ... in order, they
// combine as ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), and the
// D mod 8 tail is added after, in order; below D = 8 the sum is plain
// sequential.  Every multiply and add is __fmul_rn / __fadd_rn, so nvcc
// cannot contract them into FMAs, and w = (s + 1) * 0.5 is two rounded ops.
// The sum runs over the true width D, not the store's padded width dp: zero
// padding is inert in a sequential sum but not in the eight lanes (at
// D = 12 numpy adds elements 8..11 after the tree).  The plain PyTorch
// version kernels/knn_rerank.py::rerank_ref does the same ops in the same
// order.  (numpy starts the reduction from 0 + s, which can only turn a
// -0 into +0; w is the same either way.)
//
// Bound: bytes.  The candidate rows, the query rows, the candidate ids and
// the (M, k) output: M TK D 4 + M D 4 + M TK 4 + M k 12 bytes at
// 3.35 TB/s, 0.85 ms at (M, TK, D) = (400000, 13, 128); the arithmetic,
// 2 M TK D operations issued as two instructions a term, takes a fifth of
// that.  The rows are random gathers of dp floats each (512 B at D = 128).
//
// Design: a warp takes 32 / L rows, L lanes a row (L = 8, 16 or 32, the
// smallest that holds TK), one lane a candidate: two rows a warp at TK = 13,
// 26 of its 32 lanes busy.  The warp stages its rows' query and candidate
// rows in shared memory with cp.async, 16 bytes a lane, consecutive lanes
// on consecutive bytes of a row, every copy of the warp in flight at once
// (14 KB a warp at TK = 13, D = 128) and no registers held for them.  A row
// is dp + 4 floats apart in shared memory, so the float4 reads of 8 lanes at
// one column of 8 different rows fall in 8 different bank quads
// ((dp + 4) / 4 is odd since dp % 8 == 0).  Each lane then sums its pair in
// registers in numpy's order and finds its place in the row's list by
// counting the lanes that rank above it under (w desc, id asc, lane asc),
// L shuffles of (w, id); the first k places write.  Nothing is shared
// between warps: a block of 4 warps is a scheduling unit only.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps a block

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sum_i q[i] * b[i] over i < d in numpy's pairwise order (d <= 128); q and b
// are 16-byte aligned rows in shared memory
__device__ __forceinline__ float pairwise_dot(const float* q, const float* b, int d) {
  if (d < 8) {
    float s = 0.0f;
    for (int i = 0; i < d; ++i) s = __fadd_rn(s, __fmul_rn(q[i], b[i]));
    return s;
  }
  float r[8];
  const int full = d & ~7;
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    const float4 qa = *reinterpret_cast<const float4*>(q + j);
    const float4 ba = *reinterpret_cast<const float4*>(b + j);
    r[j] = __fmul_rn(qa.x, ba.x);
    r[j + 1] = __fmul_rn(qa.y, ba.y);
    r[j + 2] = __fmul_rn(qa.z, ba.z);
    r[j + 3] = __fmul_rn(qa.w, ba.w);
  }
  for (int i = 8; i < full; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q + i + j);
      const float4 ba = *reinterpret_cast<const float4*>(b + i + j);
      r[j] = __fadd_rn(r[j], __fmul_rn(qa.x, ba.x));
      r[j + 1] = __fadd_rn(r[j + 1], __fmul_rn(qa.y, ba.y));
      r[j + 2] = __fadd_rn(r[j + 2], __fmul_rn(qa.z, ba.z));
      r[j + 3] = __fadd_rn(r[j + 3], __fmul_rn(qa.w, ba.w));
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[1]), __fadd_rn(r[2], r[3])),
                      __fadd_rn(__fadd_rn(r[4], r[5]), __fadd_rn(r[6], r[7])));
  for (int i = full; i < d; ++i) s = __fadd_rn(s, __fmul_rn(q[i], b[i]));
  return s;
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32) knn_rerank_kernel(
    const float* __restrict__ store, const int* __restrict__ cand,
    long long* __restrict__ out_idx, float* __restrict__ out_w, int c, int dp, int d, int m,
    int tk, int k, int base_id) {
  constexpr int kRowsPerWarp = 32 / L;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / L;     // this lane's row of the warp
  const int slot = lane % L;  // this lane's candidate
  const int stride = dp + 4;  // floats between staged rows
  const int staged = tk + 1;  // staged rows a row: its query, then its candidates
  float* rows = smem + (size_t)warp * kRowsPerWarp * staged * stride;
  const int first = (blockIdx.x * kWarps + warp) * kRowsPerWarp;  // the warp's first row
  const int row = first + g;
  const bool live = row < m;

  // this lane's candidate id; -1 for an empty slot, one out of the store,
  // or a lane past TK
  int id = -1;
  if (live && slot < tk) {
    const int j = cand[(size_t)row * tk + slot];
    id = (j >= 0 && j < c) ? j : -1;
  }

  // stage: float4 e of the warp's kRowsPerWarp * staged rows of dp / 4; a
  // candidate row's id comes from the lane that holds it
  const int row4 = dp >> 2;
  const int total = kRowsPerWarp * staged * row4;
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = min(e0 + lane, total - 1);
    const int r = e / row4;
    const int col = e - r * row4;
    const int rg = r / staged;     // the warp row it belongs to
    const int s = r - rg * staged;  // 0: the query; s >= 1: candidate s - 1
    const int j = __shfl_sync(kFull, id, rg * L + max(s - 1, 0));
    const int src = s == 0 ? (first + rg < m ? base_id + first + rg : -1) : j;
    if (e0 + lane < total && src >= 0)
      cp_async16(rows + (size_t)r * stride + col * 4, store + (size_t)src * dp + col * 4);
  }
  cp_async_wait_all();
  __syncwarp();

  float w = -CUDART_INF_F;
  if (id >= 0) {
    const float* q = rows + (size_t)g * staged * stride;
    const float s = pairwise_dot(q, q + (size_t)(1 + slot) * stride, d);
    w = __fmul_rn(__fadd_rn(s, 1.0f), 0.5f);
    if (!(fabsf(w) < CUDART_INF_F)) {  // NaN or inf
      w = -CUDART_INF_F;
      id = -1;
    }
  }

  // this lane's place: the lanes of its row that rank above it
  int pos = 0;
#pragma unroll
  for (int x = 0; x < L; ++x) {
    const float wx = __shfl_sync(kFull, w, x, L);
    const int ix = __shfl_sync(kFull, id, x, L);
    pos += (wx > w || (wx == w && (ix < id || (ix == id && x < slot)))) ? 1 : 0;
  }
  if (!live) return;
  const size_t out = (size_t)row * k;
  if (slot < tk && pos < k) {
    out_idx[out + pos] = id;
    out_w[out + pos] = w;
  }
  for (int p = tk + slot; p < k; p += L) {  // k > TK: the tail is empty
    out_idx[out + p] = -1;
    out_w[out + p] = -CUDART_INF_F;
  }
}

template <int L>
int launch(const float* store, const int* cand, long long* out_idx, float* out_w, int c,
           int dp, int d, int m, int tk, int k, int base_id, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarps * (32 / L);
  const size_t smem = (size_t)kRowsPerBlock * (tk + 1) * (dp + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_rerank_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  knn_rerank_kernel<L><<<blocks, kWarps * 32, smem, stream>>>(store, cand, out_idx, out_w, c,
                                                              dp, d, m, tk, k, base_id);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns the launch error (0 on
// success; cudaErrorInvalidValue for a TK above 32).  The caller has checked
// shapes, types, contiguity, 16-byte alignment of `store`, dp % 8 == 0,
// 1 <= d <= min(dp, 128), 1 <= tk <= 32, k >= 1, m >= 1 and
// base_id + m <= c, all in 32 bits.
extern "C" int knn_rerank(const void* store, const void* cand, void* out_idx, void* out_w,
                          int c, int dp, int d, int m, int tk, int k, int base_id,
                          void* stream) {
  const float* st = (const float*)store;
  const int* ca = (const int*)cand;
  long long* oi = (long long*)out_idx;
  float* ow = (float*)out_w;
  cudaStream_t s = (cudaStream_t)stream;
  if (tk <= 8) return launch<8>(st, ca, oi, ow, c, dp, d, m, tk, k, base_id, s);
  if (tk <= 16) return launch<16>(st, ca, oi, ow, c, dp, d, m, tk, k, base_id, s);
  if (tk <= 32) return launch<32>(st, ca, oi, ow, c, dp, d, m, tk, k, base_id, s);
  return (int)cudaErrorInvalidValue;
}
