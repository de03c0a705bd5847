// Dense-grid linearization of the bundle-adjustment cost on Hopper.
//
// Replaces: psba_tpu/ops/linearize_dense.py::linearize_dense_pallas
// (kernel _dense_kernel, and the XLA sums of its per-chunk packs).
//
// Computes, for every (camera c, point p) cell of the dense grid masked by
// valid[c, p]: the planar stacked factor ZWk[6c+i, p] = W[i, k] (W = A^T B),
// the point blocks V = B^T B and gradient gb = B^T ex summed over cameras,
// and, unless the caller passes no U, the camera blocks U = A^T A and
// ga = A^T ex summed over points. The outputs come back final: Vp [3, 3, Pp]
// with all nine entries and the identity in the padded lanes, gbp [3, Pp],
// U [C, 6, 6] with both triangles, ga [C, 6]. One call of
// psba_linearize_dense is two launches: the grid kernel, then the kernel
// that finishes the sums.
//
// What bounds it: the ZW planes are written once per call, 18 floats per
// cell (192 MB at 138 cameras x 19,328 padded points), against ~300 flops of
// cell model per cell, so the grid kernel is bound by device-memory writes
// once the card is full. Design:
// - one thread per point column; a block covers 128 points and a chunk of
//   kCamChunk cameras (grid = Pp/128 x ceil(C/kCamChunk)), so some 2,700
//   blocks fill the 132 SMs where one thread per point over all cameras
//   would leave nine tenths of them idle;
// - ZW stores are coalesced across the neighbouring points of a warp, and
//   the blocks that run together (neighbouring point tiles of one camera
//   chunk) fill neighbouring spans of the same ZW rows;
// - V and gb accumulate in registers over the block's cameras and are
//   written as one partial per camera chunk [n_cg, 9, Pp] (the Pallas
//   kernel's per-chunk V pack);
// - U and ga (27 values per camera) reduce over the warp with shuffles, over
//   the block's four warps in shared memory, and are written as one partial
//   per point block [Pp/128, C, 27];
// - with an occupancy table (tile_mask [C, Pp/128] int32, bit (c, t) = 1
//   iff camera c observes a point of tile t), a camera whose bit is 0 for
//   the block's tile skips its cell model, its table loads and its V / gb /
//   U / ga work, and writes its ZW cells as zeros (the outputs are not
//   zeroed beforehand; the Pallas kernel pre-zeroes its ZW rows for the
//   same reason); its U / ga partial is written as 0. The skip is exact:
//   every cell of such a pair is unseen and contributes exactly 0, so the
//   outputs equal the unmasked kernel's. It saves arithmetic and the 12
//   table bytes a cell, not the ZW writes that bound the kernel;
// - the finishing kernel sums the partials, each output in index order, and
//   writes the final layouts: one thread per (point, V / gb entry) over the
//   chunks, and for U / ga a block per 32 camera entries whose eight warps
//   each sum a contiguous eighth of the point tiles, then add the eighths
//   in order. A block of the grid kernel exits as soon as its stores are
//   issued (a last-block scheme would have to wait for them to drain
//   before it signals), and no float atomics are used: the result does not
//   depend on the order in which blocks run (two calls give the same bits),
//   which on a TPU the sequential grid gave for free.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 128;  // points per block; Pp is a multiple of it
constexpr int kCamChunk = 8;   // cameras per block
constexpr int kWarps = kThreads / 32;
constexpr int kUPack = 27;     // 21 upper-triangle U entries + 6 ga entries

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    linearize_dense_kernel(const float* __restrict__ kq,
                           const float* __restrict__ cams,
                           const float* __restrict__ pts,
                           const float* __restrict__ obs_du,
                           const float* __restrict__ obs_dv,
                           const float* __restrict__ valid,
                           const int* __restrict__ tile_mask, int C, int P,
                           int Pp, int clamp, float* __restrict__ zw0,
                           float* __restrict__ zw1, float* __restrict__ zw2,
                           float* __restrict__ vpart,
                           float* __restrict__ upart) {
  __shared__ float cam_s[kCamChunk][kCamRec];
  __shared__ float u_s[kWarps][kCamChunk][kUPack];
  __shared__ bool live_s[kCamChunk];  // the camera observes a point here
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x * kThreads + tid;  // < Pp by construction
  const int c0 = blockIdx.y * kCamChunk;
  const int nc = min(kCamChunk, C - c0);
  for (int i = tid; i < nc * kCamRec; i += kThreads) {
    const int g = i / kCamRec, k = i % kCamRec;
    const int c = c0 + g;
    cam_s[g][k] = k < 9 ? kq[c * 9 + k] : cams[c * 6 + (k - 9)];
  }
  if (tid < nc)
    live_s[tid] = tile_mask == nullptr ||
                  tile_mask[(size_t)(c0 + tid) * gridDim.x + blockIdx.x] != 0;
  __syncthreads();

  // padded point lanes (p >= P) see a zero point and a zero mask: every
  // output they write is exactly zero
  const bool in = p < P;
  const float x1 = in ? pts[3 * p + 0] : 0.0f;
  const float x2 = in ? pts[3 * p + 1] : 0.0f;
  const float x3 = in ? pts[3 * p + 2] : 0.0f;
  // V00 V01 V02 V11 V12 V22 gb0 gb1 gb2
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int g = 0; g < nc; ++g) {
    const int c = c0 + g;
    // uniform over the block: a skipped camera writes zero ZW cells only
    const bool live = live_s[g];
    float A[2][6] = {}, B[2][3] = {}, exu = 0.0f, exv = 0.0f;
    if (live) {
      const size_t cell = (size_t)c * P + p;
      const float vmask = in ? valid[cell] : 0.0f;
      const float ou = in ? obs_du[cell] : 0.0f;
      const float ov = in ? obs_dv[cell] : 0.0f;
      cell_linearize(cam_s[g], x1, x2, x3, ou, ov, vmask, clamp != 0, A, B,
                     exu, exv);
    }

#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* row =
          (k == 0 ? zw0 : k == 1 ? zw1 : zw2) + (size_t)(6 * c) * Pp + p;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        row[(size_t)i * Pp] = A[0][i] * B[0][k] + A[1][i] * B[1][k];
    }
    if (!live) continue;
    int r = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j)
        acc[r++] += B[0][i] * B[0][j] + B[1][i] * B[1][j];
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[6 + i] += B[0][i] * exu + B[1][i] * exv;

    if (upart != nullptr) {
      r = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) {
          const float t = warp_sum(A[0][i] * A[0][j] + A[1][i] * A[1][j]);
          if (lane == 0) u_s[warp][g][r] = t;
          ++r;
        }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float t = warp_sum(A[0][i] * exu + A[1][i] * exv);
        if (lane == 0) u_s[warp][g][21 + i] = t;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 9; ++r)
    vpart[((size_t)blockIdx.y * 9 + r) * Pp + p] = acc[r];

  if (upart != nullptr) {
    __syncthreads();
    for (int i = tid; i < nc * kUPack; i += kThreads) {
      const int g = i / kUPack, r = i % kUPack;
      float s = 0.0f;
      if (live_s[g]) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += u_s[w][g][r];
      }
      upart[((size_t)blockIdx.x * C + c0 + g) * kUPack + r] = s;
    }
  }
}

// Threads of the finishing kernel: each U / ga block has kFinishWarps warps
// over 32 camera entries.
constexpr int kFinishThreads = 256;
constexpr int kFinishWarps = kFinishThreads / 32;

// Blocks [0, n_ublocks) (none when U is null): block b takes the camera
// entries e = 32 b + lane of the [C * 27] U / ga pack; warp w sums the
// point tiles [w q, (w + 1) q) in order, and warp 0 adds the warps' sums in
// order and writes the entry to U (both triangles) or ga. They come first,
// so their longer chains start first. The blocks after them: thread i <
// 9 * Pp sums entry r = i / Pp of point p = i % Pp over the n_cg chunk
// partials in chunk order and writes it to its place(s) in Vp / gbp (the
// identity in the padded lanes p >= P).
__global__ void __launch_bounds__(kFinishThreads)
    linearize_dense_finish_kernel(const float* __restrict__ vpart,
                                  const float* __restrict__ upart, int C,
                                  int P, int Pp, int n_cg, int n_tiles,
                                  int n_ublocks, float* __restrict__ Vp,
                                  float* __restrict__ gbp,
                                  float* __restrict__ U,
                                  float* __restrict__ ga) {
  if ((int)blockIdx.x >= n_ublocks) {
    const int i = (blockIdx.x - n_ublocks) * kFinishThreads + threadIdx.x;
    if (i >= 9 * Pp) return;
    const int r = i / Pp, p = i - r * Pp;
    float s = 0.0f;
#pragma unroll 6
    for (int g = 0; g < n_cg; ++g) s += vpart[((size_t)g * 9 + r) * Pp + p];
    if (r >= 6) {
      gbp[(size_t)(r - 6) * Pp + p] = s;  // exactly 0 in the padded lanes
      return;
    }
    // r: V00 V01 V02 V11 V12 V22 -> (a, b)
    const int a = r < 3 ? 0 : r < 5 ? 1 : 2;
    const int b = r < 3 ? r : r < 5 ? r - 2 : 2;
    const bool pad = p >= P;
    const float v = pad ? (a == b ? 1.0f : 0.0f) : s;
    Vp[(size_t)(3 * a + b) * Pp + p] = v;
    if (a != b) Vp[(size_t)(3 * b + a) * Pp + p] = v;
    return;
  }
  __shared__ float part[kFinishWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const bool live = e < C * kUPack;
  const int q = (n_tiles + kFinishWarps - 1) / kFinishWarps;
  const int t0 = warp * q;
  const int t1 = min(n_tiles, t0 + q);
  float s = 0.0f;
  if (live) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) s += upart[(size_t)t * C * kUPack + e];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || !live) return;
  s = 0.0f;
#pragma unroll
  for (int w = 0; w < kFinishWarps; ++w) s += part[w][lane];
  const int c = e / kUPack, k = e - c * kUPack;
  if (k >= 21) {
    ga[(size_t)c * 6 + (k - 21)] = s;
    return;
  }
  // k: the row-major upper triangle of the 6x6 block -> (a, b), a <= b
  int a = 0, row = 6;
  for (int kk = k; kk >= row; kk -= row, --row) ++a;
  const int b = a + (k - (a * (13 - a)) / 2);
  U[(size_t)c * 36 + 6 * a + b] = s;
  if (a != b) U[(size_t)c * 36 + 6 * b + a] = s;
}

}  // namespace

extern "C" int psba_linearize_dense_ptile() { return kThreads; }
extern "C" int psba_linearize_dense_cam_chunk() { return kCamChunk; }

// kq [C, 9] (K | q0), cams [C, 6], pts [P, 3], obs_du/obs_dv/valid [C, P];
// tile_mask [C, Pp / kThreads] int32 or null (every pair visited);
// outputs zw0, zw1, zw2 [6C, Pp] each, Vp [3, 3, Pp], gbp [3, Pp] and,
// unless U is null, U [C, 6, 6] and ga [C, 6]. scratch: n_cg * 9 * Pp
// floats (n_cg = ceil(C / kCamChunk)), and with U (Pp / kThreads) * C * 27
// more. Two launches. Returns cudaGetLastError().
extern "C" int psba_linearize_dense(const float* kq, const float* cams,
                                    const float* pts, const float* obs_du,
                                    const float* obs_dv, const float* valid,
                                    const int* tile_mask, int C, int P,
                                    int Pp, int clamp, float* zw0,
                                    float* zw1, float* zw2,
                                    float* Vp, float* gbp, float* U, float* ga,
                                    float* scratch, void* stream) {
  if (C < 1 || P < 1 || Pp < P || Pp % kThreads != 0 ||
      (U == nullptr) != (ga == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = Pp / kThreads, n_cg = (C + kCamChunk - 1) / kCamChunk;
  float* upart = U == nullptr ? nullptr : scratch + (size_t)n_cg * 9 * Pp;
  const cudaStream_t s = (cudaStream_t)stream;
  linearize_dense_kernel<<<dim3(n_tiles, n_cg), kThreads, 0, s>>>(
      kq, cams, pts, obs_du, obs_dv, valid, tile_mask, C, P, Pp, clamp, zw0,
      zw1, zw2, scratch, upart);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_vblocks = (9 * Pp + kFinishThreads - 1) / kFinishThreads;
  const int n_ublocks = U == nullptr ? 0 : (C * kUPack + 31) / 32;
  linearize_dense_finish_kernel<<<n_vblocks + n_ublocks, kFinishThreads, 0,
                                  s>>>(scratch, upart, C, P, Pp, n_cg,
                                       n_tiles, n_ublocks, Vp, gbp, U, ga);
  return (int)cudaGetLastError();
}
