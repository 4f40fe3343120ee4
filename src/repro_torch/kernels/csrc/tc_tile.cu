// Bit-packed tile intersection for active tile triples (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/tc_tile/tc_tile.py, entry
// `tile_triple_counts`: `_kernel_popcount` (mode "popcount") and
// `_kernel_mxu` with `unpack_bits_tile` (mode "mxu").  Same function for
// both: a tile is 128 rows of 4 32-bit words (128x128 bits); for triple g =
// (a_slot, b_slot, m_slot, valid)
//
//     out[g] = valid ? sum_{i,j} M[i,j] * popcount(A[i,:] & B[j,:]) : 0
//
// with A = a_tiles[a_slot], B = b_tiles[b_slot], M = m_tiles[m_slot].
// Padding triples are (0,0,0,0) and slot 0 is a real tile, so `valid`
// decides.  Column c of a tile row is bit c % 32 of word c / 32.  A total is
// at most 128^3 = 2^21 and fits int32 (and fp32 exactly).
//
// What bounds them on an H100: operations.  A triple reads three 2 KiB
// tiles and does 128*128*4 word AND+popcount (popcount mode; __popc runs at
// 16 a clock per SM on compute capability 9.0, a quarter of the AND rate)
// or 2*128^3 multiply-adds (mxu mode, bf16 tensor cores), i.e. 32 and 1024
// operations per byte read.
//
// What the designs do about it.
//  popcount: one block per triple, thread i owns row i of A and of M (both
//    in registers, 4 words each); the B tile is staged in shared memory and
//    read as broadcasts (all threads read the same word).  Every (i, j) pair
//    is computed and masked, so the popc work is the full 128*128*4; no
//    atomics, one block reduction.
//  mxu ("mxu" names the TPU counterpart; here it is the tensor cores): one
//    block of 8 warps per triple.  Both tiles are unpacked to 0/1 bf16 in
//    shared memory, 64 k-columns at a time (47 KB of static shared memory
//    in all); warp w owns output rows [16w, 16w+16) and multiplies them
//    against all 8 column blocks with 16x16x16 wmma fragments into fp32
//    (8 accumulators, 64 registers a thread).  Each accumulator is stored
//    to a per-warp 16x16 shared buffer, where the mask bit of every element
//    is tested and the integer values summed.
//  Skipping unset mask bits, int8 MMA, wgmma/TMA and persistent blocks are
//  left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>

namespace {

constexpr int kTile = 128;
constexpr int kWords = 4;

// ---------------------------------------------------------------------------
// popcount mode
// ---------------------------------------------------------------------------
constexpr int kPopThreads = kTile;  // thread i owns row i

__global__ void __launch_bounds__(kPopThreads)
tile_popcount_kernel(const int4* __restrict__ triples,
                     const uint4* __restrict__ a_tiles,
                     const uint4* __restrict__ b_tiles,
                     const uint4* __restrict__ m_tiles,
                     int* __restrict__ out) {
  __shared__ uint4 b_s[kTile];
  __shared__ int warp_sum[kPopThreads / 32];
  const int g = blockIdx.x;
  const int4 t = triples[g];
  if (t.w == 0) {  // uniform over the block: no thread reaches a barrier
    if (threadIdx.x == 0) out[g] = 0;
    return;
  }
  const int i = threadIdx.x;
  const uint4 a = a_tiles[(long long)t.x * kTile + i];
  const uint4 m = m_tiles[(long long)t.z * kTile + i];
  b_s[i] = b_tiles[(long long)t.y * kTile + i];
  __syncthreads();

  const unsigned mrow[kWords] = {m.x, m.y, m.z, m.w};
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const unsigned bits = mrow[w];
#pragma unroll 8
    for (int jj = 0; jj < 32; ++jj) {
      const uint4 b = b_s[w * 32 + jj];
      const int c = __popc(a.x & b.x) + __popc(a.y & b.y) +
                    __popc(a.z & b.z) + __popc(a.w & b.w);
      count += ((bits >> jj) & 1u) ? c : 0;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kPopThreads / 32; ++w) s += warp_sum[w];
    out[g] = s;
  }
}

// ---------------------------------------------------------------------------
// mxu mode (tensor cores)
// ---------------------------------------------------------------------------
constexpr int kMxuWarps = 8;                // warp w: output rows [16w, 16w+16)
constexpr int kMxuThreads = kMxuWarps * 32;
constexpr int kChunk = 64;                  // k-columns unpacked at a time
constexpr int kChunkWords = kChunk / 32;
constexpr int kLd = kChunk + 8;             // bf16 row stride (multiple of 8)
constexpr int kColBlocks = kTile / 16;
constexpr unsigned kOneBf16 = 0x3F80u;      // bit pattern of bf16 1.0

static_assert(kMxuWarps * 16 == kTile, "one 16-row strip per warp");

__global__ void __launch_bounds__(kMxuThreads)
tile_mxu_kernel(const int4* __restrict__ triples,
                const unsigned* __restrict__ a_tiles,
                const unsigned* __restrict__ b_tiles,
                const unsigned* __restrict__ m_tiles,
                int* __restrict__ out) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 a_s[kTile * kLd];
  __shared__ __align__(32) __nv_bfloat16 b_s[kTile * kLd];
  __shared__ __align__(32) float epi[kMxuWarps][16 * 16];
  __shared__ unsigned m_s[kTile * kWords];
  __shared__ int warp_sum[kMxuWarps];

  const int g = blockIdx.x;
  const int4 t = triples[g];
  if (t.w == 0) {  // uniform over the block: no thread reaches a barrier
    if (threadIdx.x == 0) out[g] = 0;
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned* a = a_tiles + (long long)t.x * kTile * kWords;
  const unsigned* b = b_tiles + (long long)t.y * kTile * kWords;
  const unsigned* m = m_tiles + (long long)t.z * kTile * kWords;
  for (int e = threadIdx.x; e < kTile * kWords; e += kMxuThreads) m_s[e] = m[e];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kColBlocks];
#pragma unroll
  for (int n = 0; n < kColBlocks; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int c = 0; c < kTile / kChunk; ++c) {
    __syncthreads();  // the previous chunk's fragments are loaded
    // unpack: (tile, row, word-in-chunk) items, 32 bf16 each, written as
    // 16 pairs (little endian: the lower column is the low half)
    for (int item = threadIdx.x; item < 2 * kTile * kChunkWords;
         item += kMxuThreads) {
      const int which = item / (kTile * kChunkWords);  // 0: A, 1: B
      const int r = (item / kChunkWords) % kTile;
      const int wl = item % kChunkWords;
      const unsigned word = (which ? b : a)[r * kWords + c * kChunkWords + wl];
      unsigned* dst = reinterpret_cast<unsigned*>(
          (which ? b_s : a_s) + r * kLd + wl * 32);
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const unsigned lo = ((word >> (2 * p)) & 1u) * kOneBf16;
        const unsigned hi = ((word >> (2 * p + 1)) & 1u) * kOneBf16;
        dst[p] = lo | (hi << 16);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, a_s + warp * 16 * kLd + k, kLd);
#pragma unroll
      for (int n = 0; n < kColBlocks; ++n) {
        // B^T as a (k x j) matrix: element (k, j) = B[j][k] = b_s[j*kLd + k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(bf, b_s + n * 16 * kLd + k, kLd);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
  }

  // epilogue: each 16x16 accumulator through the warp's buffer, masked
  int count = 0;
  float* buf = epi[warp];
  const int i0 = warp * 16;
#pragma unroll
  for (int n = 0; n < kColBlocks; ++n) {
    wmma::store_matrix_sync(buf, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 256; e += 32) {
      const int i = i0 + (e >> 4);
      const int j = n * 16 + (e & 15);
      const unsigned bit = (m_s[i * kWords + (j >> 5)] >> (j & 31)) & 1u;
      count += bit ? __float2int_rn(buf[e]) : 0;
    }
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_sum[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kMxuWarps; ++w) s += warp_sum[w];
    out[g] = s;
  }
}

}  // namespace

// Plain C entry points.  Each launches one block per triple on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// as an int (0 = launched).  Pointers must be 16-byte aligned.
extern "C" int tc_tile_popcount(const void* triples, const void* a_tiles,
                                const void* b_tiles, const void* m_tiles,
                                long long g, void* out, void* stream) {
  if (g <= 0 || g > INT_MAX) return (int)cudaErrorInvalidValue;
  tile_popcount_kernel<<<(unsigned)g, kPopThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)triples, (const uint4*)a_tiles, (const uint4*)b_tiles,
      (const uint4*)m_tiles, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int tc_tile_mxu(const void* triples, const void* a_tiles,
                           const void* b_tiles, const void* m_tiles,
                           long long g, void* out, void* stream) {
  if (g <= 0 || g > INT_MAX) return (int)cudaErrorInvalidValue;
  tile_mxu_kernel<<<(unsigned)g, kMxuThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)triples, (const unsigned*)a_tiles, (const unsigned*)b_tiles,
      (const unsigned*)m_tiles, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* tc_tile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
