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
// Design: warp-cooperative.  Blocks of kWarps warps; each warp owns 32
// consecutive rows, one per lane, and takes __ballot_sync of their frontier
// bytes.  Off-frontier rows write F_u and `changed` at once (coalesced) and
// read none of their nbr / wgt / wl0 / wl1 bytes; a warp with no frontier
// row stops there.  The warp's rows are contiguous in nbr and wgt, so it
// walks them in column chunks of at most kChunk = 32, item by item: while
// the warp has fewer frontier rows than the chunk has columns, an item is
// one frontier row (lane = column); else it is one step of a flat walk over
// the chunk, lane l taking element e = 32 t + l (row e / kc, column e % kc,
// by a multiply-high with a per-chunk magic number), so the lanes of one
// load read 128 consecutive bytes.  kItems items at a time, in three
// phases, so that all their loads are in flight together: the lane's nbr /
// wgt elements (a lane with nothing to do reads the segment's first element
// instead: in bounds, one sector for all), the F[v] gathers (L2 hits), then
// d = F_v - F_u and p = w * d with __fsub_rn / __fmul_rn into the row's
// slot of a shared-memory tile whose row stride is odd, so that in the fold
// lane r's reads of its own row hit 32 distinct banks.  Lane r then folds row r's
// chunk into its running nbr_term / wsum in column order with __fadd_rn
// and, after the last chunk, finishes Wall, dF, F' and `changed` exactly
// as the plain version does.  The products and the order of every sum are
// the plain PyTorch version's (repro_torch/kernels/ell_propagate.py), so
// the two give the same bits.  The launcher below sizes the grid (one warp
// per 32 rows), the odd stride (min(K, 32) + 1 or + 2) and the dynamic
// shared memory, kWarps * (2 * 32 * stride + 32) * 4 bytes (26 KB at K = 24,
// 34 KB at most).
//
// Timed on an H100 against one thread a row, with its loads one column at a
// time (PR 11's design) or a row's loads batched in 16-byte vectors
// (PERF.md): the fastest of the three on the main path's own sweeps and
// with every row on the frontier, the slowest on synthetic frontiers spread
// at random over 5% to a third of the rows.
//
// Bound: every row reads frontier (1 byte) and writes F' and changed (5
// bytes); F is read once (4 bytes per label); a frontier row also reads its
// nbr and wgt lanes (8 bytes each) and wl0, wl1 (8 bytes):
// 6 N + 4 Nf + |frontier| (8K + 8) bytes from device memory, 2.4 us mean
// over the main path's sweeps at (N, K) = (107200, 24).  Operations (4 per
// lane, 12 per row) are far below.  On the card a sweep takes the order of
// a launch: an empty kernel timed the same way takes about 4.8 us, and a
// warp's dependent chain (frontier byte, ballot, nbr, F[v], fold, store)
// adds a few microseconds however few rows are on the frontier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps per block
constexpr int kChunk = 32;  // columns of a warp's rows staged in shared memory at a time
constexpr int kItems = 8;   // items of a warp's walk whose loads are in flight together

__global__ void __launch_bounds__(kWarps * 32) ell_propagate_kernel(
    const int32_t* __restrict__ nbr, const float* __restrict__ wgt,
    const float* __restrict__ wl0, const float* __restrict__ wl1,
    const uint8_t* __restrict__ frontier, const float* __restrict__ f,
    float* __restrict__ fout, uint8_t* __restrict__ changed,
    int n, int k, int nf, float delta, int row_offset, int stride) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* sp = smem + warp * (2 * 32 * stride + 32);  // p = w * d, [row][col]
  float* sw = sp + 32 * stride;                      // w, [row][col]
  float* su = sw + 32 * stride;                      // F_u of the warp's rows

  const int row0 = (blockIdx.x * kWarps + warp) * 32;
  const int row = row0 + lane;
  const bool in = row < n;
  const int g = (int)min((long long)row + row_offset, (long long)nf - 1);
  const float fu = in ? f[g] : 0.0f;
  const bool fr = in && frontier[row];
  const unsigned bits = __ballot_sync(0xffffffffu, fr);
  if (in && !fr) {  // F' = F_u; the same `changed` test as below
    fout[row] = fu;
    changed[row] = fabsf(__fsub_rn(fu, fu)) > delta ? 1 : 0;
  }
  if (bits == 0) return;  // warp-uniform
  su[lane] = fu;
  __syncwarp();

  float nbr_term = 0.0f;
  float wsum = 0.0f;
  const int nrows = __popc(bits);
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int kc = min(kChunk, k - c0);
    // e / kc for e < 32 kc: floor(e * ceil(2^32 / kc) / 2^32) is exact here
    const unsigned long long magic = ((1ull << 32) + kc - 1) / kc;
    const int32_t* nseg = nbr + (long long)row0 * k + c0;
    const float* wseg = wgt + (long long)row0 * k + c0;
    // items (see the header): frontier rows while they are fewer than the
    // columns, else steps of the flat walk; kItems at a time, in phases
    const bool by_row = nrows < kc;
    const int items = by_row ? nrows : kc;
    unsigned rest = bits;
    for (int i0 = 0; i0 < items; i0 += kItems) {
      int r[kItems], c[kItems];
      bool on[kItems];
      int32_t v[kItems];
      float w[kItems], fv[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int i = i0 + u;
        if (by_row) {
          r[u] = rest ? __ffs(rest) - 1 : 0;
          rest &= rest - 1;
          c[u] = lane;
          on[u] = i < items && lane < kc;
        } else {
          const int e = i * 32 + lane;
          r[u] = (int)(((unsigned long long)e * magic) >> 32);
          c[u] = e - r[u] * kc;
          on[u] = i < items && ((bits >> r[u]) & 1u);
        }
        const int off = on[u] ? r[u] * k + c[u] : 0;
        v[u] = nseg[off];
        w[u] = wseg[off];
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) fv[u] = f[v[u] >= 0 ? v[u] : 0];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (on[u]) {
          const float d = v[u] >= 0 ? __fsub_rn(fv[u], su[r[u]]) : 0.0f;
          sp[r[u] * stride + c[u]] = __fmul_rn(w[u], d);
          sw[r[u] * stride + c[u]] = w[u];
        }
      }
    }
    __syncwarp();
    if (fr) {  // row `lane`, this chunk, in column order
      const float* pr = sp + lane * stride;
      const float* wr = sw + lane * stride;
#pragma unroll 4
      for (int j = 0; j < kc; ++j) {
        nbr_term = __fadd_rn(nbr_term, pr[j]);
        wsum = __fadd_rn(wsum, wr[j]);
      }
    }
    __syncwarp();  // the tile is free for the next chunk
  }
  if (!fr) return;
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
// caller has checked shapes, types, contiguity, n > 0, nf > 0, and that
// n * k and n + row_offset fit in 32 bits.
extern "C" int ell_propagate_step(
    const void* nbr, const void* wgt, const void* wl0, const void* wl1,
    const void* frontier, const void* f, void* fout, void* changed,
    int n, int k, int nf, float delta, int row_offset, void* stream) {
  const int rows_per_block = kWarps * 32;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const int stride = ((k < kChunk ? k : kChunk) + 1) | 1;  // odd: distinct banks a row
  const size_t smem = (size_t)kWarps * (2 * 32 * stride + 32) * sizeof(float);
  ell_propagate_kernel<<<blocks, rows_per_block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const float*)wgt, (const float*)wl0,
      (const float*)wl1, (const uint8_t*)frontier, (const float*)f,
      (float*)fout, (uint8_t*)changed, n, k, nf, delta, row_offset, stride);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
