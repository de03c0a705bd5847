// The off-diagonal Schur product of the covisibility-pair encoding on
// Hopper: S from the bucket-sorted pair list, written in S's own layout.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA, as one
// batched (6x3)(3x6) product over the pairs and a segment_sum by bucket
// (psba_tpu/core/schur.py::schur_S). The port ran the same two steps as a
// cuBLAS bmm into a per-pair [N, 6, 6] tensor and an index_put_ bucket sum,
// which wrote and read gigabytes per call at Final-961's counts.
//
// For every bucket b = k * C + l (cameras k, l) with its pairs at
// [start[b], start[b + 1]) of the list (o1, o2), sorted by bucket:
//   S[6k + i, 6l + j] = - sum over its pairs of (Y[o1] W[o2]^T)[i, j]
// with Y, W [O, 6, 3]. Every entry of S [6C, 6C] is written, an empty
// bucket's as -0, so S needs no fill; padding (bucket C*C) lies past
// start[C*C] and is never read. The caller adds U on the diagonal blocks.
//
// What bounds it: each pair's two int64 indices are read once (16 bytes),
// each Y and W row at least once (2 x 72 bytes per observation), S written
// once (144 bytes per bucket): about 0.80 GB at Final-961's counts (25.9M
// pairs, 1.69M observations, 961 cameras), 0.24 ms at 3.35 TB/s, against
// 108 FMAs a pair (5.6 GFLOP, 0.08 ms at 67 TFLOP/s). Device memory binds.
//
// Design:
// - a warp takes a tile of four consecutive buckets, the grid all C*C
//   buckets in order, so the hardware scheduler balances the tiles and the
//   warps in flight at once work on neighbouring buckets of one or two
//   camera rows k. Most buckets are short (a ring at Final-961's counts:
//   nearly every bucket occupied, median 20 pairs, the diagonal ~1,760): on a
//   tile whose buckets hold at most kShort pairs each, each group of eight
//   lanes takes one bucket; otherwise the whole warp takes the four buckets
//   in turn. Either way a lane takes its bucket's pairs r, r + width, ... in
//   order (r its place in its group of `width` lanes) and keeps the 36 sums
//   in registers: nothing per pair goes to device memory;
// - the Y and W rows are random 72-byte gathers, only 8-byte aligned, so
//   each is nine float2 loads through the read-only path, issued with the
//   next pair's indices before the FMAs. The Y rows of camera k (about
//   130 KB) are shared by every bucket of row k, and a W row comes back for
//   each camera covisible with its point, which the bucket order visits a
//   few rows later, so most gathers hit the 50 MB L2;
// - a group combines its lanes by a fixed __shfl_xor_sync tree, after which
//   each of its lanes holds the bucket's sums and lane r writes the entries
//   e with e mod width = r. No atomics: which path a tile takes, the lane of
//   a pair and the tree depend only on the offsets, so every call gives the
//   same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;                 // lanes a bucket on a short tile
constexpr int kTile = 32 / kGroup;        // buckets a warp
constexpr long long kShort = 128;  // most pairs a bucket of a short tile

// acc += Y[a] W[c]^T
__device__ __forceinline__ void add_pair(const float* __restrict__ Y,
                                         const float* __restrict__ W,
                                         long long a, long long c,
                                         float acc[36]) {
  const float2* y2 = reinterpret_cast<const float2*>(Y) + 9 * a;
  const float2* w2 = reinterpret_cast<const float2*>(W) + 9 * c;
  float y[18], w[18];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float2 u = __ldg(y2 + q), v = __ldg(w2 + q);
    y[2 * q] = u.x;
    y[2 * q + 1] = u.y;
    w[2 * q] = v.x;
    w[2 * q + 1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float s = acc[6 * i + j];
      s = fmaf(y[3 * i], w[3 * j], s);
      s = fmaf(y[3 * i + 1], w[3 * j + 1], s);
      s = fmaf(y[3 * i + 2], w[3 * j + 2], s);
      acc[6 * i + j] = s;
    }
}

// The sums of the bucket [first, end) over `width` lanes (a power of two, a
// group of whole lanes of the warp), valid in each of them: lane r of the
// group sums pairs first + r, first + r + width, ... in order, then the
// group's fixed tree. Every lane of the warp must call it.
template <int width>
__device__ __forceinline__ void bucket_sums(
    const float* __restrict__ Y, const float* __restrict__ W,
    const long long* __restrict__ o1, const long long* __restrict__ o2,
    long long first, long long end, int r, float acc[36]) {
#pragma unroll
  for (int e = 0; e < 36; ++e) acc[e] = 0.0f;
  long long n = first + r, a = 0, c = 0;
  if (n < end) {
    a = __ldg(o1 + n);
    c = __ldg(o2 + n);
  }
  while (n < end) {
    const long long a0 = a, c0 = c, next = n + width;
    if (next < end) {
      a = __ldg(o1 + next);
      c = __ldg(o2 + next);
    }
    add_pair(Y, W, a0, c0, acc);
    n = next;
  }
  // lanes without a pair hold +0, which adds exactly
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
#pragma unroll
    for (int e = 0; e < 36; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
}

// Lane r of a group of `width` writes -acc[e] for e mod width = r into
// bucket b's block of S.
__device__ __forceinline__ void store(float* __restrict__ S, int C,
                                      long long b, int r, int width,
                                      const float acc[36]) {
  const long long ld = 6LL * C;
  const long long k = b / C, l = b - k * C;
  float* out = S + 6 * k * ld + 6 * l;
#pragma unroll
  for (int e = 0; e < 36; ++e)
    if ((e & (width - 1)) == r) out[(e / 6) * ld + e % 6] = -acc[e];
}

__global__ void __launch_bounds__(kThreads)
    schur_pairs_kernel(const float* __restrict__ Y,
                       const float* __restrict__ W,
                       const long long* __restrict__ o1,
                       const long long* __restrict__ o2,
                       const long long* __restrict__ start, int C,
                       long long n_buckets, float* __restrict__ S) {
  const int lane = threadIdx.x & 31;
  const long long b0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kTile;
  if (b0 >= n_buckets) return;            // the whole warp
  // lane q <= kTile holds start[b0 + q], at most start[n_buckets]
  const long long x =
      lane <= kTile ? __ldg(start + (b0 + lane < n_buckets ? b0 + lane
                                                           : n_buckets))
                    : 0;
  long long longest = 0;
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    const long long len = __shfl_sync(0xffffffffu, x, q + 1) -
                          __shfl_sync(0xffffffffu, x, q);
    longest = len > longest ? len : longest;
  }
  float acc[36];
  if (longest <= kShort) {                // the same for the whole warp
    const int g = lane / kGroup, r = lane % kGroup;
    bucket_sums<kGroup>(Y, W, o1, o2, __shfl_sync(0xffffffffu, x, g),
                        __shfl_sync(0xffffffffu, x, g + 1), r, acc);
    if (b0 + g < n_buckets) store(S, C, b0 + g, r, kGroup, acc);
  } else {
    for (int q = 0; q < kTile && b0 + q < n_buckets; ++q) {
      bucket_sums<32>(Y, W, o1, o2, __shfl_sync(0xffffffffu, x, q),
                      __shfl_sync(0xffffffffu, x, q + 1), lane, acc);
      store(S, C, b0 + q, lane, 32, acc);
    }
  }
}

}  // namespace

// Y, W [O, 6, 3] float32 (8-byte aligned); o1, o2 [N] int64 observation
// numbers sorted by bucket; start [C*C + 1] int64, the first pair of each
// bucket and, last, the end of the real pairs. Output: S [6C, 6C], every
// entry written. Returns cudaGetLastError().
extern "C" int psba_schur_pairs(const float* Y, const float* W,
                                const long long* o1, const long long* o2,
                                const long long* start, int C, float* S,
                                void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const long long n_buckets = (long long)C * C;
  const long long per_block = (long long)kWarps * kTile;
  const long long grid = (n_buckets + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  schur_pairs_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      Y, W, o1, o2, start, C, n_buckets, S);
  return (int)cudaGetLastError();
}
