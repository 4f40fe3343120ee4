// Fused intersection count of one logical device-step, both buckets (sm_90a).
//
// Replaces the TPU kernel `_fused_panel_kernel` (src/repro/kernels/tc_fused/
// tc_fused.py:40, launched at :146 by `fused_short_counts`) together with the
// lax long bucket of `count_pair_fused` (src/repro/kernels/tc_fused/ops.py:126),
// which the TPU kernel left to plain ops because it had a panel width.  One
// launch computes, for tile g of `tile` consecutive tasks (ti[t], tj[t]),
//
//     out[g] = sum over the tile's tasks t < tcount of
//              |row_A(ti[t])[:a_cap]  ∩  row_B(tj[t])[:b_cap]|
//
// with sorted, duplicate-free CSR rows.  Tasks [0, n_long) are the long
// bucket (a_cap = a_cap_long, b_cap = b_cap_long, INT_MAX for a whole B row);
// tasks [n_long, tmax) the short bucket (a_cap = b_cap = d_short).  Tiles
// start at 0 and again at n_long, so the last ceil((tmax - n_long) / tile)
// outputs are the short bucket's per-tile counts; with n_long = 0 this is the
// TPU kernel's function.  Tasks at or past tcount contribute 0.
//
// What bounds it on an H100: bytes.  The least it must move is every input
// once -- 8 B of task ids per task, and the row pointers and column ids (cut
// at the caps) of every distinct row the tasks name -- over 3.35 TB/s; it
// does about min(len) * log2(max(len)) integer compares per task, a few
// operations per byte.  What keeps a kernel far above that bound is the
// search: each probe is a chain of dependent loads, and rows are shared by
// many tasks, so the tasks read each row many times over (from L2).
//
// What the design does about it.  A warp takes one tile at a time (warps
// stride over the tiles; the grid is as many blocks as fit on the card at
// once).  Lane k loads the ids, row pointers and capped lengths of task
// t0 + k, so one round of dependent loads serves 32 tasks.  The planner
// orders a bucket's tasks by ti, so consecutive tasks share their A row: a
// run of equal (ti, capped length) stages that row once in the warp's
// shared buffer (kStage ids), and a run that began in another tile stages
// it again.  Over the run's tasks the warp flattens the probes, so lane l
// takes probe l, l + 32, ... of the run whichever task it belongs to, in
// two passes: B's ids, read coalesced, searched in the staged A row (every
// lane halves the same row the same number of times), for tasks whose B is
// at most kRatio times A's length; then A's ids searched in B's row where it
// lies, for the rest.  Searching in shared memory is the cheaper probe, so
// it is worth up to kRatio times as many.  A row longer than kStage (a hub)
// is searched where it lies in global memory: nothing goes back to the
// host.  The count is int32 per tile, written by the one warp that owns the
// tile: no atomics, so the result does not depend on the schedule; the
// caller sums tiles in int64.  Where its time goes, and the variants that
// were measured no faster (a hash table instead of the sorted row, both
// rows staged, probes unrolled, tiles taken from an atomic counter), is in
// PERF.md; `python -m repro_torch.launch.fused_sweep` re-measures kRatio,
// the grid, the tile and the cost of each pass.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWarps = 8;              // warps a block, one tile each
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 512;            // ids of an A row a warp stages (2 KiB)
constexpr int kRatio = 2;              // B ids into A while |B| <= kRatio |A|
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* a_indptr;
  const int* a_indices;
  const int* b_indptr;
  const int* b_indices;
  const int* ti;
  const int* tj;
  int tlive;         // min(tcount, tmax): tasks below it count
  int n_long;        // tasks [0, n_long) are the long bucket
  int tmax;          // tmax + 2 tile + 64 fits an int
  int tile;
  int ntile_long;    // ceil(n_long / tile)
  int ntile;         // all tiles
  int a_cap_long;
  int b_cap_long;
  int d_short;
  int* out;
};

struct WarpShared {
  int row[kStage];  // the staged A row
  int pre_b[33];    // exclusive prefix of the tasks' B-id probes
  int pre_a[33];    // exclusive prefix of the tasks' A-id probes
  int b_start[32];
  int b_len[32];    // capped
};

// 1 if v is one of keys[0, n), n >= 1, keys sorted and distinct: the last
// key <= v, found in ceil(log2 n) halvings, is v.
__device__ __forceinline__ int contains(const int* keys, int n, int v) {
  const int* base = keys;
  while (n > 1) {
    const int half = n >> 1;
    if (base[half] <= v) base += half;
    n -= half;
  }
  return *base == v;
}

// Hits of the run's B ids [p0, p1) of the flattened B probes searched in
// its A row: task k owns positions [pre_b[k], pre_b[k + 1]).  All lanes
// search the same row, so the halvings are the same for every lane.
__device__ __forceinline__ int probe_b_ids(const int* a_row, int a_len,
                                           const WarpShared& s,
                                           const int* __restrict__ b_indices,
                                           int k, int p0, int p1, int lane) {
  int hits = 0;
  for (int pos = p0 + lane; pos < p1; pos += 32) {
    while (s.pre_b[k + 1] <= pos) ++k;
    const int e = pos - s.pre_b[k];
    hits += contains(a_row, a_len, __ldg(b_indices + s.b_start[k] + e));
  }
  return hits;
}

// Hits of the run's A ids [p0, p1) of the flattened A probes, each
// searched in its task's B row where it lies in global memory.
__device__ __forceinline__ int probe_a_ids(const int* a_row,
                                           const WarpShared& s,
                                           const int* __restrict__ b_indices,
                                           int k, int p0, int p1, int lane) {
  int hits = 0;
  for (int pos = p0 + lane; pos < p1; pos += 32) {
    while (s.pre_a[k + 1] <= pos) ++k;
    const int e = pos - s.pre_a[k];
    hits += contains(b_indices + s.b_start[k], s.b_len[k], a_row[e]);
  }
  return hits;
}

__global__ void __launch_bounds__(kThreads) fused_counts_kernel(const Params p) {
  __shared__ WarpShared shared[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpShared& s = shared[warp];
  int staged_i = -1, staged_len = 0;  // warp-uniform: what s.row holds

  for (int g = blockIdx.x * kWarps + warp; g < p.ntile;
       g += gridDim.x * kWarps) {
    const bool is_long = g < p.ntile_long;
    int t0, t1;
    if (is_long) {
      t0 = g * p.tile;
      t1 = t0 + p.tile < p.n_long ? t0 + p.tile : p.n_long;
    } else {
      t0 = p.n_long + (g - p.ntile_long) * p.tile;
      t1 = t0 + p.tile < p.tmax ? t0 + p.tile : p.tmax;
    }
    if (t1 > p.tlive) t1 = p.tlive;
    const int a_cap = is_long ? p.a_cap_long : p.d_short;
    const int b_cap = is_long ? p.b_cap_long : p.d_short;

    int count = 0;
    for (int b0 = t0; b0 < t1; b0 += 32) {
      const int t = b0 + lane;
      int i = -1, a_start = 0, a_len = 0, b_start = 0, b_len = 0;
      if (t < t1) {
        i = p.ti[t];
        const int j = p.tj[t];
        a_start = p.a_indptr[i];
        a_len = min(p.a_indptr[i + 1] - a_start, a_cap);
        b_start = p.b_indptr[j];
        b_len = min(p.b_indptr[j + 1] - b_start, b_cap);
        if (a_len <= 0 || b_len <= 0) a_len = b_len = 0;
      }
      // B ids into A while B is not much the longer (A's row is staged),
      // else A ids into B
      const bool b_ids = b_len <= (a_len <= kStage ? kRatio : 1) * a_len;
      const int probe_b = b_ids ? b_len : 0;
      const int probe_a = b_ids ? 0 : a_len;
      int incl_b = probe_b, incl_a = probe_a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int vb = __shfl_up_sync(kFull, incl_b, o);
        const int va = __shfl_up_sync(kFull, incl_a, o);
        if (lane >= o) incl_b += vb, incl_a += va;
      }
      __syncwarp();  // the previous batch has read s.pre_* / b_start / b_len
      s.pre_b[lane] = incl_b - probe_b;
      s.pre_a[lane] = incl_a - probe_a;
      if (lane == 31) s.pre_b[32] = incl_b, s.pre_a[32] = incl_a;
      s.b_start[lane] = b_start;
      s.b_len[lane] = b_len;
      __syncwarp();

      // a run: consecutive tasks with the same A row at the same cap
      const int prev_i = __shfl_up_sync(kFull, i, 1);
      const int prev_len = __shfl_up_sync(kFull, a_len, 1);
      unsigned heads = __ballot_sync(
          kFull, lane == 0 || i != prev_i || a_len != prev_len);
      while (heads) {
        const int k0 = __ffs(heads) - 1;
        heads &= heads - 1;
        const int k1 = heads ? __ffs(heads) - 1 : 32;
        const int pb0 = s.pre_b[k0], pb1 = s.pre_b[k1];
        const int pa0 = s.pre_a[k0], pa1 = s.pre_a[k1];
        const int run_i = __shfl_sync(kFull, i, k0);
        const int run_len = __shfl_sync(kFull, a_len, k0);
        const int run_start = __shfl_sync(kFull, a_start, k0);
        if (pb1 == pb0 && pa1 == pa0) continue;  // nothing to probe
        if (run_len <= kStage) {
          if (run_i != staged_i || run_len > staged_len) {
            __syncwarp();  // every lane is done with the old row
            for (int e = lane; e < run_len; e += 32)
              s.row[e] = __ldg(p.a_indices + run_start + e);
            __syncwarp();
            staged_i = run_i;
            staged_len = run_len;
          }
          count += probe_b_ids(s.row, run_len, s, p.b_indices, k0, pb0, pb1,
                               lane);
          count += probe_a_ids(s.row, s, p.b_indices, k0, pa0, pa1, lane);
        } else {  // hub row: search it in global memory
          const int* a_row = p.a_indices + run_start;
          count += probe_b_ids(a_row, run_len, s, p.b_indices, k0, pb0, pb1,
                               lane);
          count += probe_a_ids(a_row, s, p.b_indices, k0, pa0, pa1, lane);
        }
      }
    }
    count = __reduce_add_sync(kFull, count);
    if (lane == 0) p.out[g] = count;
  }
}

}  // namespace

// Plain C entry point.  Launches on `stream` of card `device` (the
// operands' card, made the thread's current device here), does not
// synchronise, allocates nothing.  `out` holds `ntile` int32: ceil(n_long / tile) long
// tiles, then max(1, ceil((tmax - n_long) / tile)) short ones (none where
// n_long >= tmax).  b_cap_long < 0 means the whole B row.  Returns the CUDA
// error as an int (0 = launched).
extern "C" int tc_fused_counts(const void* a_indptr, const void* a_indices,
                               const void* b_indptr, const void* b_indices,
                               const void* ti, const void* tj,
                               long long tcount, long long tmax,
                               long long n_long, int tile, int a_cap_long,
                               int b_cap_long, int d_short, int ntile,
                               void* out, void* stream, int device) {
  if (tile <= 0 || d_short <= 0 || a_cap_long <= 0 || tmax < 0 ||
      n_long < 0 || n_long > tmax || tmax + 2LL * tile + 64 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long ntile_long = (n_long + tile - 1) / tile;
  const long long ntile_short =
      n_long < tmax ? std::max(1LL, (tmax - n_long + tile - 1) / tile)
                    : (tmax == 0 ? 1 : 0);
  if (ntile != ntile_long + ntile_short) return (int)cudaErrorInvalidValue;
  Params p;
  p.a_indptr = (const int*)a_indptr;
  p.a_indices = (const int*)a_indices;
  p.b_indptr = (const int*)b_indptr;
  p.b_indices = (const int*)b_indices;
  p.ti = (const int*)ti;
  p.tj = (const int*)tj;
  p.tlive = (int)std::max(0LL, std::min(tcount, tmax));
  p.n_long = (int)n_long;
  p.tmax = (int)tmax;
  p.tile = tile;
  p.ntile_long = (int)ntile_long;
  p.ntile = ntile;
  p.a_cap_long = a_cap_long;
  p.b_cap_long = b_cap_long < 0 ? INT_MAX : b_cap_long;
  p.d_short = d_short;
  p.out = (int*)out;

  // one warp a tile, but no more blocks than fit on the card at once: the
  // warps loop over the rest.  This library has its own runtime, so the
  // card is set from the operands' device, not read from the runtime.
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_counts_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = std::min<long long>(
      (ntile + kWarps - 1) / kWarps, (long long)sms * std::max(per_sm, 1));
  fused_counts_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}

extern "C" int tc_fused_stage_limit() { return kStage; }

extern "C" const char* tc_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
