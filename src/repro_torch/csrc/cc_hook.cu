// The Shiloach–Vishkin hook + jump step, and its loop run to the fixpoint
// in one cooperative launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/cc_hook.py (cc_hook_step,
// body _kernel) and its loop connected_components_pallas.  Over an ELL
// adjacency nbr (N, K) int32 (PAD = -1) and a parent vector par (N,) int32,
// per row u:
//   hooked = min(par[u], min over valid lanes v of par[v])
//   out[u] = par[hooked]
// The jump reads the PREVIOUS parent vector (the TPU kernel's VMEM-resident
// input), so a step is a pure function of (nbr, par).  Integer min and
// gathers are exact: the step equals the plain PyTorch version
// repro_torch/kernels/cc_hook.py::cc_hook_ref exactly, in any order.
//
// Bound: nbr read once (4K bytes a row) and the labels written once.  What
// a step costs on top is its gathers of par: one random 4-byte read per
// valid lane (about 0.8 M a step on the main path's kNN snapshot), each a
// 32-byte L2 sector; par itself (4N bytes, under 1 MB) stays in L2.
//
// Design: a warp owns 32 consecutive rows, whose 32·K lanes are contiguous.
// It reads them coalesced in passes of at most 8 cells a row: 16-byte cells
// (32 columns a pass; one pass when K <= 32) when K % 4 == 0 and nbr starts
// on 16 bytes, else 4-byte cells (8 columns a pass).  A pass gives each
// lane at most 8 cells, so its loads, then the gathers par[v] of all its
// cells, are issued together (unrolled, in flight at once) and held in
// registers.  A lane folds a 16-byte cell's four to one and stores the
// result into the warp's tile in shared memory at (row, cell), row stride
// 9 (odd: no bank conflict when row r's lane reads its row).  Row r's lane
// folds its row's min, then jumps.  hook_rows holds this body once; the
// step kernel runs it once per warp, the fixpoint kernel once per step for
// every row group it strides over.
//
// The fixpoint: a persistent cooperative launch (as many blocks as are
// resident at once, or as the rows need), a grid barrier between steps,
// two parent buffers swapped each step (the Jacobi semantics of
// connected_components_pallas), and one device word that a block which
// moved a parent at step s raises to s + 1 with atomicMax.  After the
// barrier every block reads the word: below s + 1, nothing moved and every
// block stops.  The word only grows, so no block has to clear it while
// another may still read it.  A warp's row groups are the same at every
// step, so where they fit (cc_fixpoint_plan) each warp keeps its rows'
// lanes in shared memory at the first step and reads them there after:
// nbr leaves device memory once.  The step count and the labels (copied
// into the first buffer when the last step wrote the second) are left on
// the card; max_iters is honoured on the card.  par is read with plain
// loads: the grid barrier orders the previous step's writes before them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCells = 8;            // cells a row a pass; so a lane's a pass
constexpr int kStride = kCells + 1;  // tile row stride: odd, no bank conflict
constexpr int kFixpointBlocks = 2;   // fixpoint blocks an SM the registers allow
constexpr int kKeepBytes = 160 * 1024;  // most shared memory a block keeps lanes in

// The (row, cell) pairs one lane handles in a pass: cells lane, lane + 32,
// ... of the pass's row-major cells, `width` cells a row (width <= 8).
struct Cells {
  int r, j, dr, dj, width;
  __device__ Cells(int lane, int w) : width(w) {
    r = lane / w;
    j = lane - r * w;
    dr = 32 / w;
    dj = 32 - dr * w;
  }
  __device__ void next() {
    r += dr;
    j += dj;
    if (j >= width) {
      j -= width;
      ++r;
    }
  }
};

__device__ __forceinline__ int32_t lane_par(const int32_t* par, int32_t v) {
  return v >= 0 ? par[v] : INT_MAX;
}
__device__ __forceinline__ int32_t cell_min(const int32_t* par, int32_t v) {
  return lane_par(par, v);
}
__device__ __forceinline__ int32_t cell_min(const int32_t* par, int4 v) {
  return min(min(lane_par(par, v.x), lane_par(par, v.y)),
             min(lane_par(par, v.z), lane_par(par, v.w)));
}
__device__ __forceinline__ void pad_cell(int32_t& c) { c = -1; }
__device__ __forceinline__ void pad_cell(int4& c) { c = make_int4(-1, -1, -1, -1); }

// One pass over a warp's rows: `src` points at the pass's first lane of
// the warp's first row (rows k entries apart; in shared memory when
// kShared, else in global memory, read-only), `width` cells a row of
// `rows` rows; with `keep`, each cell read is also stored at the same
// place under `keep`.  Returns the min parent over the pass's valid lanes
// of this lane's row (INT_MAX past the last row or where every lane is
// PAD).
template <typename Cell, bool kShared>
__device__ __forceinline__ int32_t fold_pass(const int32_t* src, int32_t* keep,
                                             const int32_t* par, int k, int rows, int width,
                                             int32_t* tile) {
  constexpr int kEach = sizeof(Cell) / sizeof(int32_t);
  const int lane = threadIdx.x & 31;
  const int cells = rows * width;
  Cell cell[kCells];
  Cells at(lane, width);
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (32 * i >= cells) break;
    pad_cell(cell[i]);
    if (at.r < rows) {
      const int off = at.r * k + at.j * kEach;
      const Cell* at_cell = reinterpret_cast<const Cell*>(src + off);
      cell[i] = kShared ? *at_cell : __ldg(at_cell);
      if (keep) *reinterpret_cast<Cell*>(keep + off) = cell[i];
    }
    at.next();
  }
  int32_t low[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (32 * i >= cells) break;
    low[i] = cell_min(par, cell[i]);
  }
  Cells to(lane, width);
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (32 * i >= cells) break;
    if (to.r < rows) tile[to.r * kStride + to.j] = low[i];
    to.next();
  }
  __syncwarp();
  int32_t best = INT_MAX;
  if (lane < rows)
    for (int j = 0; j < width; ++j) best = min(best, tile[lane * kStride + j]);
  __syncwarp();
  return best;
}

// One step over the 32 rows of row group `group` (warp-uniform), whose
// lanes `src` points at (see fold_pass; `keep`: where to keep a copy, or
// null): out[u] for each of them.  Returns whether this lane's row moved
// (out[u] != par[u]).
template <bool kShared>
__device__ __forceinline__ bool hook_rows(const int32_t* src, int32_t* keep, const int32_t* par,
                                          int32_t* out, int n, int k, bool vec, int group,
                                          int32_t* tile) {
  const int lane = threadIdx.x & 31;
  const int row0 = group * 32;
  const int rows = min(32, n - row0);
  const bool mine = lane < rows;
  const int32_t own = mine ? par[row0 + lane] : 0;
  const int each = vec ? 4 : 1;  // lanes a cell
  int32_t low = INT_MAX;
  for (int c0 = 0; c0 < k; c0 += kCells * each) {
    const int width = min(kCells, (k - c0) / each);
    int32_t* kept = keep ? keep + c0 : nullptr;
    low = min(low, vec ? fold_pass<int4, kShared>(src + c0, kept, par, k, rows, width, tile)
                       : fold_pass<int32_t, kShared>(src + c0, kept, par, k, rows, width, tile));
  }
  if (!mine) return false;
  const int32_t next = par[min(own, low)];
  out[row0 + lane] = next;
  return next != own;
}

__global__ void __launch_bounds__(kThreads, 4)
    cc_hook_kernel(const int32_t* __restrict__ nbr, const int32_t* __restrict__ par,
                   int32_t* __restrict__ out, int n, int k, int vec) {
  __shared__ int32_t tiles[kWarps][32 * kStride];
  const int warp = threadIdx.x >> 5;
  const int group = blockIdx.x * kWarps + warp;
  if (group * 32 < n)
    hook_rows<false>(nbr + group * 32 * k, nullptr, par, out, n, k, vec, group, tiles[warp]);
}

// state[0]: the last step that moved a parent (1-based; 0 before any);
// state[1]: the steps run.  With keep_groups > 0 every warp keeps the lanes
// of its first keep_groups row groups in dynamic shared memory from the
// first step on, and later steps read them there.
__global__ void __launch_bounds__(kThreads, kFixpointBlocks)
    cc_fixpoint_kernel(const int32_t* __restrict__ nbr, int32_t* a, int32_t* b,
                       int32_t* state, int n, int k, int vec, int max_iters, int keep_groups) {
  __shared__ int32_t tiles[kWarps][32 * kStride];
  extern __shared__ int4 kept_lanes[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int groups = (n + 31) / 32;
  const int stride = gridDim.x * kThreads;
  int32_t* kept = reinterpret_cast<int32_t*>(kept_lanes) + warp * keep_groups * 32 * k;
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < n; u += stride) a[u] = u;
  if (blockIdx.x == 0 && threadIdx.x == 0) state[0] = 0;
  grid.sync();
  int it = 0;
  while (it < max_iters) {
    const int32_t* par = (it & 1) ? b : a;
    int32_t* out = (it & 1) ? a : b;
    bool moved = false;
    int j = 0;
    for (int g = blockIdx.x * kWarps + warp; g < groups; g += gridDim.x * kWarps, ++j) {
      int32_t* mine = j < keep_groups ? kept + j * 32 * k : nullptr;
      if (mine && it > 0)
        moved |= hook_rows<true>(mine, nullptr, par, out, n, k, vec, g, tiles[warp]);
      else
        moved |= hook_rows<false>(nbr + g * 32 * k, it == 0 ? mine : nullptr, par, out, n, k,
                                  vec, g, tiles[warp]);
    }
    ++it;
    if (__syncthreads_or(moved) && threadIdx.x == 0) atomicMax(state, it);
    grid.sync();
    // a block that already runs step it + 1 raises the word only further
    if (*(volatile int32_t*)state < it) break;
  }
  if (it & 1)
    for (int u = blockIdx.x * kThreads + threadIdx.x; u < n; u += stride) a[u] = b[u];
  if (blockIdx.x == 0 && threadIdx.x == 0) state[1] = it;
}

int use_vec(const void* nbr, int k) {
  return k > 0 && k % 4 == 0 && reinterpret_cast<uintptr_t>(nbr) % 16 == 0;
}

// What the planner needs of a device, queried once per device: its SMs,
// the fixpoint blocks an SM holds without a kept copy, and, by the bytes a
// block keeps, the blocks an SM holds with them.
struct Residency {
  int sms = 0, per_sm = 0;
  std::map<long long, int> per_sm_kept;
};
std::mutex residency_mutex;
std::map<int, Residency> residency_by_device;

}  // namespace

// Launches one step on `stream` and returns cudaGetLastError() (0 on
// success).  The caller has checked shapes, types, contiguity and n > 0.
extern "C" int cc_hook_step(const void* nbr, const void* par, void* out, int n, int k,
                            void* stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  cc_hook_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)par, (int32_t*)out, n, k, use_vec(nbr, k));
  return (int)cudaGetLastError();
}

// The fixpoint's launch over (n, k) on the current device: as many blocks
// as are resident at once, at most as many as the rows need, at least 1;
// and the row groups each warp keeps in shared memory (all of them, when
// their lanes fit kKeepBytes a block and every block stays resident; else
// none).  out[0] = blocks, out[1] = kept groups a warp, out[2] = blocks
// resident without a kept copy.  Returns the first CUDA error (0 on
// success).
extern "C" int cc_fixpoint_plan(int n, int k, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(residency_mutex);
  auto found = residency_by_device.find(dev);
  if (found == residency_by_device.end()) {
    Residency r;
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
    // set once: no launch asks for more, so no call shrinks it under another
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cc_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kKeepBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.per_sm, cc_fixpoint_kernel, kThreads,
                                                          0);
    if (err != cudaSuccess) return (int)err;
    found = residency_by_device.emplace(dev, r).first;
  }
  Residency& r = found->second;
  const int resident = r.per_sm * r.sms;
  const int need = (n + kThreads - 1) / kThreads;
  int blocks = need < resident ? need : resident;
  if (blocks < 1) blocks = 1;  // the launch reports why it cannot run
  const long long warps = (long long)blocks * kWarps;
  const long long groups = (n + 31) / 32;
  const int per_warp = (int)((groups + warps - 1) / warps);
  const long long bytes = (long long)kWarps * per_warp * 32 * k * (long long)sizeof(int32_t);
  int keep = 0;
  if (k > 0 && bytes <= kKeepBytes) {
    auto kept = r.per_sm_kept.find(bytes);
    if (kept == r.per_sm_kept.end()) {
      int per_sm_kept = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_kept, cc_fixpoint_kernel,
                                                          kThreads, (size_t)bytes);
      if (err != cudaSuccess) return (int)err;
      kept = r.per_sm_kept.emplace(bytes, per_sm_kept).first;
    }
    if ((long long)kept->second * r.sms >= blocks) keep = per_warp;
  }
  out[0] = blocks;
  out[1] = keep;
  out[2] = resident;
  return 0;
}

// Launches the whole fixpoint on `stream` as one cooperative kernel, as
// cc_fixpoint_plan plans it, and returns the first CUDA error (0 on
// success); a refused launch is reported, never retried smaller.  a and
// b are (N,) int32 buffers and state (2,) int32, all left for the kernel
// to fill: the labels end in a, the step count in state[1].  The caller
// has checked shapes, types, contiguity and n > 0.
extern "C" int cc_fixpoint(const void* nbr, void* a, void* b, void* state, int n, int k,
                           int max_iters, void* stream) {
  int plan[3];
  cudaError_t err = (cudaError_t)cc_fixpoint_plan(n, k, plan);
  if (err != cudaSuccess) return (int)err;
  const int32_t* nbr_ = (const int32_t*)nbr;
  int32_t *a_ = (int32_t*)a, *b_ = (int32_t*)b, *state_ = (int32_t*)state;
  int vec = use_vec(nbr, k), keep = plan[1];
  void* args[] = {&nbr_, &a_, &b_, &state_, &n, &k, &vec, &max_iters, &keep};
  const size_t bytes = (size_t)kWarps * keep * 32 * k * sizeof(int32_t);
  err = cudaLaunchCooperativeKernel((const void*)cc_fixpoint_kernel, dim3(plan[0]),
                                    dim3(kThreads), args, bytes, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return (int)(err != cudaSuccess ? err : last);
}
