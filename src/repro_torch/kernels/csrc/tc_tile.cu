// Bit-packed tile intersection for active tile triples (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/tc_tile/tc_tile.py, entry
// `tile_triple_counts`: `_kernel_popcount` (mode "popcount") and
// `_kernel_mxu` with `unpack_bits_tile` (mode "mxu").  Same function for
// both: a tile is 128 rows of 4 32-bit words (128x128 bits); for triple g =
// (a_slot, b_slot, m_slot, valid)
//
//     out[g] = valid > 0 ? sum_{i,j} M[i,j] * popcount(A[i,:] & B[j,:]) : 0
//
// with A = a_tiles[a_slot], B = b_tiles[b_slot], M = m_tiles[m_slot].
// Padding triples are (0,0,0,0) and slot 0 is a real tile, so `valid`
// decides.  Column c of a tile row is bit c % 32 of word c / 32.  A total is
// at most 128^3 = 2^21 and fits int32.
//
// What bounds them on an H100: bytes.  The function needs only the pairs
// (i, j) whose mask bit is set -- on the tile path about 4.6 of a triple's
// 16,384 -- so it is the tiles it names (2 KiB each, each read once) over
// the memory rate, not the 128*128*4 AND+popcount of every (i, j).  Each
// triple must still read its whole mask tile to find its set bits: 2 KiB a
// triple, mostly from L2, and on the tile path that mask scan (about 0.7 GB
// a device-step) is what the kernels' time follows (PERF.md).
//
// What the designs do about it.
//  Both: one warp per triple, 8 warps a block, a grid of as many blocks as
//    fit on the card at once (the launch asks the occupancy calculator);
//    warp w of the grid takes triples w, w + warps, w + 2 * warps, ...
//    Lane l reads mask rows l, l + 32, l + 64, l + 96 as 16-byte loads and
//    keeps them in registers.  An invalid triple writes 0 and reads no
//    tile.  Copying the next triple's mask tile with `cp.async` into
//    shared memory while this one is counted was measured no faster (the
//    scan is bandwidth-, not latency-bound) and cost registers (PERF.md).
//  popcount (CUDA cores): the warp sums the set bits of the mask.  Up to
//    kDenseThreshold of them (sparse route) each lane walks its own set
//    bits with __ffs and, for each, reads row A[i] and row B[j] as one
//    16-byte load each and adds 4 __popc.  Above it (dense route) the warp
//    stages B in its shared buffer and each lane takes its 4 rows against
//    all 128 j, selecting by the mask bit, as a dense mask needs.
//  mxu (tensor cores, packed bits): mma.sync m16n8k128 .b1 with .and.popc
//    (wgmma has no b1 type).  A tile row is exactly one k = 128 operand row:
//    the A fragment of rows 16s+g and 16s+g+8 is word t of each row and the
//    B fragment word t of row 8b+g of B (g = lane / 4, t = lane % 4), plain
//    4-byte loads with no unpack.  The warp ORs its mask rows into a
//    128-bit map of live 16x8 output blocks and issues one MMA per live
//    block only; the C fragment's layout is fixed (c0,c1: row g, columns
//    2t, 2t+1; c2,c3: row g+8), so the mask bits reach the accumulators
//    by warp shuffles, in registers.  The same block as four m16n8k32 s8
//    MMAs on bits expanded to bytes in registers was measured 1.4-2.1x
//    slower at every mask density, so b1 it is (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kTile = 128;             // rows of a tile, and bits of a row
constexpr int kWarps = 8;              // warps a block, one triple each
constexpr int kThreads = kWarps * 32;
constexpr int kLaneRows = kTile / 32;  // lane l holds rows l + 32 r
constexpr unsigned kFull = 0xffffffffu;

// Set mask bits of a triple above which the popcount kernel takes its dense
// route.  chip_smoke.py's tile_density sweep (349,932 triples, A/B bit
// density 0.3, NVIDIA H100 80GB HBM3 at 700 W) put the sparse route's time
// level with the dense route's at 6,577, 6,614 and 6,515 set bits per
// triple in three runs (sparse 2.32-2.43 ms / dense 5.72-5.93 ms at 1,639
// bits, 6.88-7.12 / 5.76-5.98 ms at 8,193 bits; PERF.md).  Its 24 MB of
// stores sat in L2; the tile path's distinct tiles do not.  To measure the
// two routes again, set this to 0 (dense only) or 16384 (sparse only) and
// rerun that phase.
constexpr int kDenseThreshold = 6600;

struct Tile {
  uint4 row[kTile];  // 2 KiB
};

__device__ __forceinline__ unsigned word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

__device__ __forceinline__ int popc_and(const uint4& a, const uint4& b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

// The front end of both kernels.  The warp walks its triples; for a valid
// one each lane gets its mask rows `mrow` (rows lane + 32 r) and
// `body(t, mrow)` returns the triple's total (the same in every lane).
template <class Body>
__device__ __forceinline__ void for_each_triple(
    const int4* __restrict__ triples, const uint4* __restrict__ m_tiles,
    long long n, int* __restrict__ out, Body body) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  uint4 mrow[kLaneRows];
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < n; g += stride) {
    const int4 t = __ldg(triples + g);
    int count = 0;
    if (t.w > 0) {  // uniform over the warp
      const uint4* m = m_tiles + (long long)t.z * kTile;
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) mrow[r] = __ldg(m + lane + 32 * r);
      count = body(t, mrow);
    }
    if (lane == 0) out[g] = count;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// popcount mode
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
tile_popcount_kernel(const int4* __restrict__ triples,
                     const uint4* __restrict__ a_tiles,
                     const uint4* __restrict__ b_tiles,
                     const uint4* __restrict__ m_tiles, long long n,
                     int* __restrict__ out) {
  __shared__ Tile b_stage[kWarps];  // the dense route's B, a tile a warp
  const int lane = threadIdx.x & 31;
  Tile& scratch = b_stage[threadIdx.x >> 5];
  auto body = [&](const int4& t, const uint4 (&mrow)[kLaneRows]) {
    const uint4* a = a_tiles + (long long)t.x * kTile;
    const uint4* b = b_tiles + (long long)t.y * kTile;
    int bits = 0;
#pragma unroll
    for (int r = 0; r < kLaneRows; ++r)
      bits += __popc(mrow[r].x) + __popc(mrow[r].y) + __popc(mrow[r].z) +
              __popc(mrow[r].w);
    int count = 0;
    if (__reduce_add_sync(kFull, bits) > kDenseThreshold) {
      // dense route: B staged in the warp's buffer, read as broadcasts
      __syncwarp();  // no lane still reads the previous triple's B
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r)
        scratch.row[lane + 32 * r] = __ldg(b + lane + 32 * r);
      uint4 arow[kLaneRows];
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) arow[r] = __ldg(a + lane + 32 * r);
      __syncwarp();
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll 4
        for (int jj = 0; jj < 32; ++jj) {
          const uint4 bj = scratch.row[32 * w + jj];
#pragma unroll
          for (int r = 0; r < kLaneRows; ++r) {
            const int c = popc_and(arow[r], bj);
            count += ((word_of(mrow[r], w) >> jj) & 1u) ? c : 0;
          }
        }
      }
    } else {
      // sparse route: each lane visits only its own set bits
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        const uint4 m = mrow[r];
        if (m.x | m.y | m.z | m.w) {
          const uint4 ar = __ldg(a + lane + 32 * r);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            unsigned bitsw = word_of(m, w);
            while (bitsw) {
              const int j = 32 * w + __ffs(bitsw) - 1;
              bitsw &= bitsw - 1;
              count += popc_and(ar, __ldg(b + j));
            }
          }
        }
      }
    }
    return __reduce_add_sync(kFull, count);
  };
  for_each_triple(triples, m_tiles, n, out, body);
}

// ---------------------------------------------------------------------------
// mxu mode (tensor cores, b1 MMA)
// ---------------------------------------------------------------------------

// d = popc(A & B) over k = 128 for a 16x8 output block, C = 0.
__device__ __forceinline__ void mma_b1_and_popc(int (&d)[4], unsigned a0,
                                                unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0), "r"(0), "r"(0), "r"(0));
}

// Bit b (b < 4) set iff byte b of x is not zero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  const unsigned y = __vcmpne4(x, 0u) & 0x08040201u;
  return (y | (y >> 8) | (y >> 16) | (y >> 24)) & 0xFu;
}

// Bit c (c < 16) set iff columns 8c .. 8c + 7 of the row hold a set bit.
__device__ __forceinline__ unsigned live_columns(const uint4& m) {
  return nonzero_bytes(m.x) | (nonzero_bytes(m.y) << 4) |
         (nonzero_bytes(m.z) << 8) | (nonzero_bytes(m.w) << 12);
}

__global__ void __launch_bounds__(kThreads)
tile_mxu_kernel(const int4* __restrict__ triples,
                const uint4* __restrict__ a_tiles,
                const uint4* __restrict__ b_tiles,
                const uint4* __restrict__ m_tiles, long long n,
                int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;  // groupID of the MMA fragments
  const int tig = lane & 3;   // threadID_in_group
  auto body = [&](const int4& t, const uint4 (&mrow)[kLaneRows]) {
    const unsigned* a =
        reinterpret_cast<const unsigned*>(a_tiles + (long long)t.x * kTile);
    const unsigned* b =
        reinterpret_cast<const unsigned*>(b_tiles + (long long)t.y * kTile);
    // Row lane + 32 r lies in 16-row strip 2 r + lane / 16, so live[r]
    // holds strip 2 r in its low half and strip 2 r + 1 in its high half,
    // one bit per 8-column block.
    unsigned live[kLaneRows];
#pragma unroll
    for (int r = 0; r < kLaneRows; ++r)
      live[r] = __reduce_or_sync(kFull, live_columns(mrow[r])
                                            << (16 * (lane >> 4)));
    int count = 0;
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s) {
      unsigned blocks = (live[s >> 1] >> (16 * (s & 1))) & 0xFFFFu;
      if (!blocks) continue;  // uniform over the warp
      const int i0 = 16 * s + grp;
      const unsigned a0 = __ldg(a + 4 * i0 + tig);
      const unsigned a1 = __ldg(a + 4 * (i0 + 8) + tig);
      const int src = 16 * (s & 1) + grp;  // lane holding mask row i0
      do {
        const int bj = __ffs(blocks) - 1;
        blocks &= blocks - 1;
        int d[4];
        const unsigned b0 = __ldg(b + 4 * (8 * bj + grp) + tig);
        mma_b1_and_popc(d, a0, a1, b0);
        const unsigned w = word_of(mrow[s >> 1], bj >> 2);
        const int shift = 8 * (bj & 3) + 2 * tig;  // column 8 bj + 2 tig
        const unsigned m0 = __shfl_sync(kFull, w, src) >> shift;
        const unsigned m1 = __shfl_sync(kFull, w, src + 8) >> shift;
        count += ((m0 & 1u) ? d[0] : 0) + ((m0 & 2u) ? d[1] : 0) +
                 ((m1 & 1u) ? d[2] : 0) + ((m1 & 2u) ? d[3] : 0);
      } while (blocks);
    }
    return __reduce_add_sync(kFull, count);
  };
  for_each_triple(triples, m_tiles, n, out, body);
}

// One block of 8 warps for every 8 triples, but no more blocks than fit on
// the card at once: the warps loop over the rest.  This library has its own
// runtime, so the card is set from the operands' device, not read from it.
template <class Kernel, class... Args>
int launch(Kernel kernel, long long n, void* stream, int device,
           Args... args) {
  if (n <= 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = std::min<long long>(
      (n + kWarps - 1) / kWarps, (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points.  Each launches on `stream` of card `device` (the
// operands' card), does not synchronise,
// allocates nothing, and returns the CUDA error as an int (0 = launched).
// Pointers must be 16-byte aligned; g is the number of triples.
extern "C" int tc_tile_popcount(const void* triples, const void* a_tiles,
                                const void* b_tiles, const void* m_tiles,
                                long long g, void* out, void* stream,
                                int device) {
  return launch(tile_popcount_kernel, g, stream, device, (const int4*)triples,
                (const uint4*)a_tiles, (const uint4*)b_tiles,
                (const uint4*)m_tiles, g, (int*)out);
}

extern "C" int tc_tile_mxu(const void* triples, const void* a_tiles,
                           const void* b_tiles, const void* m_tiles,
                           long long g, void* out, void* stream,
                           int device) {
  return launch(tile_mxu_kernel, g, stream, device, (const int4*)triples,
                (const uint4*)a_tiles, (const uint4*)b_tiles,
                (const uint4*)m_tiles, g, (int*)out);
}

extern "C" int tc_tile_dense_threshold() { return kDenseThreshold; }

extern "C" const char* tc_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
