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
// "row" is a global id, row0 + the store row: a shard of a row-sharded store
// passes its offset row0, a whole store 0.
//
// Arithmetic: every dot product sums D terms in order 0..D-1, each multiply
// and add rounded on its own (__fmul_rn / __fadd_rn, no FMA, no tensor
// cores), then w = (s + 1) * 0.5 as two rounded ops.  The plain PyTorch
// version in repro_torch/kernels/argkmin.py does the same ops in the same
// order, so both give the same bits.  TF32 (~1e-3 error) would swamp the
// selection slack of 1e-5 + 1e-7 * D.
//
// Design: three launches on one stream (argkmin.cuh holds the
// templates; argkmin_tkb{8,16,32}.cu instantiate them for every D = 8, 16,
// ..., 128 at one list bound TKB each, the smallest of 8, 16, 32 that holds
// TK, so a list is no longer than it needs to be and the three files build
// in parallel).  The wrapper (kernels/argkmin.py::argkmin_geometry) chooses
// the geometry.  At the main path's (C, D, M, TK) = (131072, 16, 8192, 13):
// TKB 16, 64 row blocks of 128 batch rows, tiles of 256 store rows, 8
// splits (4 blocks of 121 registers fit an SM: 528 on 132 SMs), 512
// blocks, 21 KB of static shared memory a block.
//  1. argkmin_tile_kernel<D, TKB>, grid (ceil(M / 128), S): a block owns 128
//     batch rows (one per thread, its row held in registers) and every S-th
//     tile of 4096 / D store rows, staged in shared memory (every thread
//     reads the same store row: a broadcast).  Dealing tiles round-robin
//     gives every split its share of dead rows and of the store's unused
//     capacity; a tile with no valid row is skipped after its valid bytes
//     are read (its rows enter no list and get -inf in pcol).  A thread
//     walks its tiles eight store rows a step (four for D > 64), so eight
//     independent dot products hide each other's latency, and keeps its
//     top-TK in registers: a row enters only if it beats the list's TK-th
//     value, at one insertion site (a step's candidates are taken in row
//     order from a bit mask), so the list's unrolled code exists once and
//     needs no stack.  For every store row the block also reduces max_i w
//     over its valid batch rows: eight rows at a time as a transposing
//     butterfly (a reduce-scatter: shuffles at offsets 16, 8 and 4 halve
//     the values each lane keeps, 2 and 1 finish the max; 9 shuffles for 8
//     rows instead of 40), then the four warps through shared memory, into
//     pcol[blockIdx.x][row].
//  2. argkmin_merge_kernel<TKB>: one thread per batch row merges the split
//     lists, inserting an entry only if it ranks above the kept TK-th one
//     under (w desc, row asc): with interleaved splits a tie may sit in any
//     split, so rows are compared too.
//  3. argkmin_disp_kernel: one thread per store row reduces pcol over the
//     row blocks and writes disp.
// Blocks run in no order; nothing carries from one to the next except
// through the scratch buffers pval, pidx (S, M, TK) and pcol
// (ceil(M / 128), C), which the caller allocates.
//
// Bound: operation-bound.  2 M C_valid D flops (a multiply and an add per
// term) against 67 TFLOP/s of fp32 outside the tensor cores; that peak
// counts an FMA as two flops, and the no-FMA rule issues the multiply and
// the add as two instructions, so the arithmetic alone takes at least
// twice that (0.72 ms at the main path's shape).  The bytes (C D 4 + M D 4
// + 9 C + 8 M TK) take microseconds at 3.35 TB/s.  Beside the dot, each
// (batch row, store row) pair costs the w = (s + 1) / 2 ops, a compare, a
// select, a share of the butterfly and of the broadcast tile reads: about
// 50 instructions a pair at D = 16 (SASS), 1.4 ms at the full issue rate.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "argkmin.cuh"

extern "C" int argkmin_lists_tkb8(REPRO_ARGKMIN_LISTS_ARGS);
extern "C" int argkmin_lists_tkb16(REPRO_ARGKMIN_LISTS_ARGS);
extern "C" int argkmin_lists_tkb32(REPRO_ARGKMIN_LISTS_ARGS);
extern "C" int argkmin_resident_tkb8(int d);
extern "C" int argkmin_resident_tkb16(int d);
extern "C" int argkmin_resident_tkb32(int d);

namespace {

__global__ void argkmin_disp_kernel(const float* __restrict__ pcol,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ kth,
                                    uint8_t* __restrict__ disp, int c, int row_blocks,
                                    int base_id, int row0, float slack) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c) return;
  uint8_t out = 0;
  if (valid[j] && row0 + j < base_id) {
    float cm = -CUDART_INF_F;
    for (int b = 0; b < row_blocks; ++b) cm = fmaxf(cm, pcol[(size_t)b * c + j]);
    out = cm > __fsub_rn(kth[j], slack) ? 1 : 0;
  }
  disp[j] = out;
}

}  // namespace

// Launches the three kernels on `stream` and returns the first launch error
// (0 on success; cudaErrorInvalidValue for a D or a list bound the kernels
// are not built for).  The caller has checked shapes, types, contiguity,
// 16-byte alignment of `store`, 8 <= D <= 128 with D % 8 == 0,
// 1 <= tk <= tkb, m, c >= 1, that c * D, base_id + m and row0 + c fit in 32
// bits, and chosen splits >= 1.  row0 is the global id of the store's row 0
// (0 for a whole store, a shard's offset under the sharded sweep).
extern "C" int argkmin(const void* store, const void* valid, const void* kth,
                       const void* batch, const void* bvalid, void* val, void* idx,
                       void* disp, void* pval, void* pidx, void* pcol, int c, int d,
                       int m, int tk, int tkb, int splits, int base_id, int row0,
                       float slack, void* stream) {
  int err;
  switch (tkb) {
    case 8:
      err = argkmin_lists_tkb8(store, valid, batch, bvalid, val, idx, pval, pidx, pcol, c, d,
                               m, tk, splits, base_id, row0, stream);
      break;
    case 16:
      err = argkmin_lists_tkb16(store, valid, batch, bvalid, val, idx, pval, pidx, pcol, c, d,
                                m, tk, splits, base_id, row0, stream);
      break;
    case 32:
      err = argkmin_lists_tkb32(store, valid, batch, bvalid, val, idx, pval, pidx, pcol, c, d,
                                m, tk, splits, base_id, row0, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int row_blocks = (m + repro_argkmin::kRows - 1) / repro_argkmin::kRows;
  argkmin_disp_kernel<<<(c + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)pcol, (const uint8_t*)valid, (const float*)kth, (uint8_t*)disp, c,
      row_blocks, base_id, row0, slack);
  return (int)cudaGetLastError();
}

// Blocks of the tile kernel for (d, tkb) that the current card holds at
// once; the wrapper sizes the pass to one such wave.  -1 for a
// (d, tkb) the kernels are not built for, or an error.
extern "C" int argkmin_resident_blocks(int d, int tkb) {
  switch (tkb) {
    case 8: return argkmin_resident_tkb8(d);
    case 16: return argkmin_resident_tkb16(d);
    case 32: return argkmin_resident_tkb32(d);
    default: return -1;
  }
}
