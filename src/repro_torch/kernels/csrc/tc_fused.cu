// Fused short-task intersection for one logical device-step (sm_90a).
//
// Replaces the TPU kernel `_fused_panel_kernel` (entry `fused_short_counts`)
// of src/repro/kernels/tc_fused/tc_fused.py.  Same function: for tile g of
// `tile` tasks (ti[t], tj[t]), out[g] = sum over the tile's tasks t < tcount
// of |row_A(ti[t])[:d]  ∩  row_B(tj[t])[:d]|, rows being sorted,
// duplicate-free CSR fragments.  Tasks at index >= tcount contribute 0.
//
// What bounds it on an H100: bytes, not operations.  The least the function
// must move is every input once — 8 B of task ids per task, and the row
// pointers and column ids of every distinct row the tasks name — over
// 3.35 TB/s; it does about min(len)*log2(max(len)) integer compares per
// task, a few operations per byte against a card that wants hundreds.
// What the tasks actually read is far more, 16 B of row pointers and
// 4*(len_A + len_B) B of column ids per task, because a row is shared by
// many tasks: that re-read traffic is for the caches to serve and is no
// part of the bound.  This kernel does not arrange for it (tasks of a tile
// are not grouped by row), which is why it sits far above its bound.
//
// What the design does about it: nothing is staged.  The TPU kernel copied
// both whole index arrays into on-chip memory and compared two (tile, d)
// panels all-against-all, (tile, d, d) compares; here every row is read
// straight from global memory exactly where it lies.  One block takes one
// tile; each warp takes tasks of the tile in turn; the 32 lanes read the
// shorter of the two fragments coalesced, one element per lane, and each lane
// binary-searches its element in the longer fragment (which the warp's
// neighbouring lanes keep hot in L1/L2).  Hits are counted with
// __ballot_sync/__popc, one shared-memory reduction writes out[g].  No
// atomics, no cross-block state, so the per-tile result is deterministic.
// Shared-memory panels, TMA and persistent blocks are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_short_counts_kernel(const int* __restrict__ a_indptr,
                          const int* __restrict__ a_indices,
                          const int* __restrict__ b_indptr,
                          const int* __restrict__ b_indices,
                          const int* __restrict__ ti,
                          const int* __restrict__ tj,
                          int tlive,  // min(tcount, tmax): tasks that count
                          int tile, int d, int* __restrict__ out) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * tile;

  int count = 0;  // meaningful on lane 0 only
  for (int t = warp; t < tile; t += kWarps) {
    const long long idx = base + t;
    if (idx >= tlive) break;  // tasks are ordered: the rest are padding too
    const int i = ti[idx];
    const int j = tj[idx];
    const int a_start = a_indptr[i];
    const int b_start = b_indptr[j];
    const int a_len = min(a_indptr[i + 1] - a_start, d);
    const int b_len = min(b_indptr[j + 1] - b_start, d);
    if (a_len <= 0 || b_len <= 0) continue;

    // probe the shorter fragment into the longer one
    const int* probe;
    const int* keys;
    int n_probe, n_keys;
    if (a_len <= b_len) {
      probe = a_indices + a_start; n_probe = a_len;
      keys = b_indices + b_start;  n_keys = b_len;
    } else {
      probe = b_indices + b_start; n_probe = b_len;
      keys = a_indices + a_start;  n_keys = a_len;
    }

    for (int e0 = 0; e0 < n_probe; e0 += 32) {
      const int e = e0 + lane;
      bool hit = false;
      if (e < n_probe) {
        const int v = probe[e];
        int lo = 0, hi = n_keys;  // first position with keys[pos] >= v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (keys[mid] < v) lo = mid + 1; else hi = mid;
        }
        hit = (lo < n_keys) && (keys[lo] == v);
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      count += __popc(m);
    }
  }

  if (lane == 0) warp_sum[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    out[blockIdx.x] = s;
  }
}

}  // namespace

// Plain C entry point.  Launches on `stream`, does not synchronise, allocates
// nothing.  Returns cudaGetLastError() as an int (0 = launched).
extern "C" int tc_fused_short_counts(const void* a_indptr, const void* a_indices,
                                     const void* b_indptr, const void* b_indices,
                                     const void* ti, const void* tj,
                                     long long tcount, long long tmax,
                                     int tile, int d, int ntile, void* out,
                                     void* stream) {
  if (ntile <= 0 || tile <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  long long tlive = tcount < tmax ? tcount : tmax;
  if (tlive < 0) tlive = 0;
  if (tlive > 2147483647LL) return (int)cudaErrorInvalidValue;
  fused_short_counts_kernel<<<ntile, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a_indptr, (const int*)a_indices, (const int*)b_indptr,
      (const int*)b_indices, (const int*)ti, (const int*)tj, (int)tlive, tile,
      d, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* tc_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
