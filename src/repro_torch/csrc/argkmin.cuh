// The argkmin tile and merge kernels, templated on the store width D and on
// the list bound TKB (the wrapper's smallest of 8, 16, 32 that holds TK).
// argkmin.cu says what they compute and how; argkmin_tkb{8,16,32}.cu each
// instantiate one list bound for every D, so the three compile in parallel.
// Keep kRows and kTileFloats in step with kernels/argkmin.py.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace repro_argkmin {

constexpr int kRows = 128;        // batch rows per block, one per thread
constexpr int kTileFloats = 4096; // store tile in shared memory: 4096 / D rows
constexpr int kWarps = kRows / 32;

// max over the warp of a[u] (lane's value for store row r0 + u) for each
// u < S, as a reduce-scatter: shuffles at offsets 16, 8 (and 4 for S = 8)
// halve the values a lane keeps (lane bits 4, 3, 2 pick which), the rest
// finish the max of the one row left; one lane per row writes wrow[row].
template <int S>
__device__ __forceinline__ void column_max(const float (&a)[S], int lane, float* wrow) {
  const unsigned full = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float h2[2];
  if constexpr (S == 8) {
    float h4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      h4[u] = fmaxf(b4 ? a[u + 4] : a[u], __shfl_xor_sync(full, b4 ? a[u] : a[u + 4], 16));
#pragma unroll
    for (int u = 0; u < 2; ++u)
      h2[u] = fmaxf(b3 ? h4[u + 2] : h4[u], __shfl_xor_sync(full, b3 ? h4[u] : h4[u + 2], 8));
    float h = fmaxf(b2 ? h2[1] : h2[0], __shfl_xor_sync(full, b2 ? h2[0] : h2[1], 4));
    h = fmaxf(h, __shfl_xor_sync(full, h, 2));
    h = fmaxf(h, __shfl_xor_sync(full, h, 1));
    if ((lane & 3) == 0) wrow[lane >> 2] = h;  // row 4 b4 + 2 b3 + b2
  } else {
    static_assert(S == 4, "column_max takes 4 or 8 rows");
#pragma unroll
    for (int u = 0; u < 2; ++u)
      h2[u] = fmaxf(b4 ? a[u + 2] : a[u], __shfl_xor_sync(full, b4 ? a[u] : a[u + 2], 16));
    float h = fmaxf(b3 ? h2[1] : h2[0], __shfl_xor_sync(full, b3 ? h2[0] : h2[1], 8));
    h = fmaxf(h, __shfl_xor_sync(full, h, 4));
    h = fmaxf(h, __shfl_xor_sync(full, h, 2));
    h = fmaxf(h, __shfl_xor_sync(full, h, 1));
    if ((lane & 7) == 0) wrow[lane >> 3] = h;  // row 2 b4 + b3
  }
}

// (a, ia) ranks below (w, j) in the order (value desc, row asc).
__device__ __forceinline__ bool ranks_below(float a, int ia, float w, int j) {
  return a < w || (a == w && ia > j);
}

// Insert (w, j) into the list (v, ix), sorted by (value desc, row asc)
// over its first tk entries; the caller has checked that (w, j) ranks
// above (v[tk - 1], ix[tk - 1]).  kRowsAscend: the caller offers rows in
// ascending order, so a value tie always ranks (w, j) below and the rows
// need not be compared.  Fully unrolled so the list stays in registers.
template <int TKB, bool kRowsAscend>
__device__ __forceinline__ void topk_insert(float (&v)[TKB], int (&ix)[TKB], int tk,
                                            float w, int j) {
#pragma unroll
  for (int p = TKB - 1; p >= 0; --p) {
    if (p < tk) {
      const float prev = v[p > 0 ? p - 1 : 0];
      const int prev_ix = ix[p > 0 ? p - 1 : 0];
      const bool prev_below = kRowsAscend ? prev < w : ranks_below(prev, prev_ix, w, j);
      const bool here_below = kRowsAscend ? v[p] < w : ranks_below(v[p], ix[p], w, j);
      if (p > 0 && prev_below) {  // shift down
        v[p] = prev;
        ix[p] = prev_ix;
      } else if (here_below) {  // the first entry below: (w, j) goes here
        v[p] = w;
        ix[p] = j;
      }
    }
  }
}

template <int TKB>
__device__ __forceinline__ void kth_of(const float (&v)[TKB], const int (&ix)[TKB], int tk,
                                       float& w, int& j) {
  w = v[0];
  j = ix[0];
#pragma unroll
  for (int p = 1; p < TKB; ++p)
    if (p == tk - 1) {
      w = v[p];
      j = ix[p];
    }
}

// One split of the pass over the store's C rows for 128 batch rows:
// tiles blockIdx.y, blockIdx.y + S, blockIdx.y + 2 S, ... (S = gridDim.y),
// so every split meets its share of dead rows and of the store's unused
// capacity.  The split's top-TK list of every batch row goes to
// pval/pidx[blockIdx.y], the max over the block's valid batch rows
// of w for every store row to pcol[blockIdx.x].  Store row r of the block
// is global row row0 + r (0 for a whole store; a shard's offset under the
// sharded sweep): candidate ids, the self-match and the displacement test
// are in global ids.
template <int D, int TKB>
__global__ void __launch_bounds__(kRows) argkmin_tile_kernel(
    const float* __restrict__ store, const uint8_t* __restrict__ valid,
    const float* __restrict__ batch, const uint8_t* __restrict__ bvalid,
    float* __restrict__ pval, int* __restrict__ pidx, float* __restrict__ pcol, int c, int m,
    int tk, int base_id, int row0) {
  // store rows per step (one transposing max each): 8, or 4 for D > 64,
  // where the batch row's D registers leave less room
  constexpr int kRowStep = D > 64 ? 4 : 8;
  constexpr int kTileRows = (kTileFloats / D) / 8 * 8;
  __shared__ __align__(16) float tile[kTileRows * D];
  __shared__ uint8_t tvalid[kTileRows];
  __shared__ float wmax[kWarps][kTileRows];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int i = blockIdx.x * kRows + t;  // this thread's batch row
  const bool active = i < m;
  const bool qvalid = active && bvalid[i];
  const int self_row = base_id + i;

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = active ? batch[(size_t)i * D + d] : 0.0f;

  float v[TKB];
  int ix[TKB];
#pragma unroll
  for (int p = 0; p < TKB; ++p) {
    v[p] = -CUDART_INF_F;
    ix[p] = -1;
  }
  // the list's TK-th value (-inf while under-full); an inactive thread
  // never inserts: its threshold is +inf
  float thr = active ? -CUDART_INF_F : CUDART_INF_F;

  for (int t0 = blockIdx.y * kTileRows; t0 < c; t0 += gridDim.y * kTileRows) {
    const int rows = min(kTileRows, c - t0);
    __syncthreads();  // the previous tile and its wmax are consumed
    const float4* src = reinterpret_cast<const float4*>(store + (size_t)t0 * D);
    float4* dst = reinterpret_cast<float4*>(tile);
    for (int e = t; e < kTileRows * D / 4; e += kRows)
      dst[e] = (e * 4) / D < rows ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    int live = 0;
    for (int r = t; r < kTileRows; r += kRows) {
      const uint8_t ok = r < rows ? valid[t0 + r] : 0;
      tvalid[r] = ok;
      live |= ok;
    }
    if (!__syncthreads_or(live)) {  // no valid row: nothing to insert, pcol -inf
      for (int r = t; r < rows; r += kRows) pcol[(size_t)blockIdx.x * c + t0 + r] = -CUDART_INF_F;
      continue;
    }

    // kRowStep store rows at a time: independent dot products interleave;
    // rows past `rows` read the zero-filled tile tail
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
      unsigned cand = 0;  // rows that beat the threshold as it stood before this step
#pragma unroll
      for (int u = 0; u < kRowStep; ++u) {
        acc[u] = __fmul_rn(__fadd_rn(acc[u], 1.0f), 0.5f);  // w
        if (acc[u] > thr) cand |= 1u << u;
      }
      // rare once the list holds its TK entries: one insertion site, so the
      // list's unrolled code exists once and stays in registers; rows in
      // ascending order, so a later row that ties the TK-th value never
      // enters
      while (cand) {
        const int u = __ffs(cand) - 1;
        cand &= cand - 1;
        float w = acc[0];
#pragma unroll
        for (int x = 1; x < kRowStep; ++x)
          if (x == u) w = acc[x];
        const int r = r0 + u;
        const int j = row0 + t0 + r;
        if (w > thr && tvalid[r] && j != self_row) {
          topk_insert<TKB, true>(v, ix, tk, w, j);
          float kw;
          int kj;
          kth_of<TKB>(v, ix, tk, kw, kj);
          thr = kw;
        }
      }
#pragma unroll
      for (int u = 0; u < kRowStep; ++u) acc[u] = qvalid ? acc[u] : -CUDART_INF_F;
      column_max<kRowStep>(acc, lane, &wmax[t >> 5][r0]);
    }
    __syncthreads();
    for (int r = t; r < rows; r += kRows) {
      const int j = t0 + r;
      float cm = -CUDART_INF_F;
      if (tvalid[r] && row0 + j < base_id) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) cm = fmaxf(cm, wmax[w][r]);
      }
      pcol[(size_t)blockIdx.x * c + j] = cm;
    }
  }

  if (active) {
    const size_t out = ((size_t)blockIdx.y * m + i) * tk;
#pragma unroll
    for (int p = 0; p < TKB; ++p) {
      if (p < tk) {
        pval[out + p] = v[p];
        pidx[out + p] = ix[p];
      }
    }
  }
}

// One thread per batch row merges the `lists` split lists, each sorted by
// (value desc, row asc), inserting an entry only if it ranks above the
// kept TK-th one; the rest of a list then ranks below it too.
template <int TKB>
__global__ void argkmin_merge_kernel(const float* __restrict__ pval,
                                     const int* __restrict__ pidx,
                                     float* __restrict__ val, int* __restrict__ idx,
                                     int m, int tk, int lists) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float v[TKB];
  int ix[TKB];
#pragma unroll
  for (int p = 0; p < TKB; ++p) {
    v[p] = -CUDART_INF_F;
    ix[p] = -1;
  }
  float kw = -CUDART_INF_F;
  int kj = -1;
  for (int s = 0; s < lists; ++s) {
    const size_t base = ((size_t)s * m + i) * tk;
    for (int p = 0; p < tk; ++p) {
      const float w = pval[base + p];
      const int j = pidx[base + p];
      if (!ranks_below(kw, kj, w, j)) break;
      topk_insert<TKB, false>(v, ix, tk, w, j);
      kth_of<TKB>(v, ix, tk, kw, kj);
    }
  }
#pragma unroll
  for (int p = 0; p < TKB; ++p) {
    if (p < tk) {
      val[(size_t)i * tk + p] = v[p];
      idx[(size_t)i * tk + p] = ix[p];
    }
  }
}

template <int D, int TKB>
cudaError_t launch_tile(dim3 grid, cudaStream_t s, const float* store, const uint8_t* valid,
                        const float* batch, const uint8_t* bvalid, float* pval, int* pidx,
                        float* pcol, int c, int m, int tk, int base_id, int row0) {
  argkmin_tile_kernel<D, TKB><<<grid, kRows, 0, s>>>(store, valid, batch, bvalid, pval, pidx,
                                                     pcol, c, m, tk, base_id, row0);
  return cudaGetLastError();
}

#define REPRO_ARGKMIN_D(DD) \
  case DD:                  \
    return launch_tile<DD, TKB>(grid, s, store, valid, batch, bvalid, pval, pidx, pcol, c, m, \
                                tk, base_id, row0);

template <int TKB>
cudaError_t tile_pass(int d, dim3 grid, cudaStream_t s, const float* store,
                      const uint8_t* valid, const float* batch, const uint8_t* bvalid,
                      float* pval, int* pidx, float* pcol, int c, int m, int tk,
                      int base_id, int row0) {
  switch (d) {
    REPRO_ARGKMIN_D(8)
    REPRO_ARGKMIN_D(16)
    REPRO_ARGKMIN_D(24)
    REPRO_ARGKMIN_D(32)
    REPRO_ARGKMIN_D(40)
    REPRO_ARGKMIN_D(48)
    REPRO_ARGKMIN_D(56)
    REPRO_ARGKMIN_D(64)
    REPRO_ARGKMIN_D(72)
    REPRO_ARGKMIN_D(80)
    REPRO_ARGKMIN_D(88)
    REPRO_ARGKMIN_D(96)
    REPRO_ARGKMIN_D(104)
    REPRO_ARGKMIN_D(112)
    REPRO_ARGKMIN_D(120)
    REPRO_ARGKMIN_D(128)
    default:
      return cudaErrorInvalidValue;
  }
}

#undef REPRO_ARGKMIN_D

// Blocks of the tile kernel the card holds at once (blocks per SM from the
// occupancy calculator, times the SMs), or -1.
template <int D, int TKB>
int resident_blocks() {
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, argkmin_tile_kernel<D, TKB>,
                                                    kRows, 0) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

template <int TKB>
int resident_blocks_for(int d) {
  switch (d) {
    case 8: return resident_blocks<8, TKB>();
    case 16: return resident_blocks<16, TKB>();
    case 24: return resident_blocks<24, TKB>();
    case 32: return resident_blocks<32, TKB>();
    case 40: return resident_blocks<40, TKB>();
    case 48: return resident_blocks<48, TKB>();
    case 56: return resident_blocks<56, TKB>();
    case 64: return resident_blocks<64, TKB>();
    case 72: return resident_blocks<72, TKB>();
    case 80: return resident_blocks<80, TKB>();
    case 88: return resident_blocks<88, TKB>();
    case 96: return resident_blocks<96, TKB>();
    case 104: return resident_blocks<104, TKB>();
    case 112: return resident_blocks<112, TKB>();
    case 120: return resident_blocks<120, TKB>();
    case 128: return resident_blocks<128, TKB>();
    default: return -1;
  }
}

// The pass over the store in `splits` interleaved splits and the merge of
// their lists.  Returns the first launch error.
template <int TKB>
int argkmin_lists(const void* store, const void* valid, const void* batch,
                  const void* bvalid, void* val, void* idx, void* pval, void* pidx,
                  void* pcol, int c, int d, int m, int tk, int splits, int base_id,
                  int row0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int row_blocks = (m + kRows - 1) / kRows;
  const float* st = (const float*)store;
  const uint8_t* va = (const uint8_t*)valid;
  const float* ba = (const float*)batch;
  const uint8_t* bv = (const uint8_t*)bvalid;
  float* pv = (float*)pval;
  int* pi = (int*)pidx;
  float* pc = (float*)pcol;
  const cudaError_t err =
      tile_pass<TKB>(d, dim3(row_blocks, splits), s, st, va, ba, bv, pv, pi, pc, c, m, tk, base_id,
                     row0);
  if (err != cudaSuccess) return (int)err;
  argkmin_merge_kernel<TKB><<<(m + 255) / 256, 256, 0, s>>>(pv, pi, (float*)val, (int*)idx, m,
                                                           tk, splits);
  return (int)cudaGetLastError();
}

}  // namespace repro_argkmin

#define REPRO_ARGKMIN_LISTS_ARGS                                                           \
  const void *store, const void *valid, const void *batch, const void *bvalid, void *val, \
      void *idx, void *pval, void *pidx, void *pcol, int c, int d, int m, int tk,         \
      int splits, int base_id, int row0, void *stream
