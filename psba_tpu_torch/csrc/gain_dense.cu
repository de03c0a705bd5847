// Trial-step gain of the LM acceptance test on the dense grid, on Hopper.
//
// Replaces: psba_tpu/ops/residual_dense.py::gain_dense_pallas (kernel
// _gain_kernel).
//
// Each (camera, point) cell is visited once: the cell model runs at the old
// and at the new parameters, and the kernel accumulates
//   gain   = sum (eo - en)(eo + en)      (factored: exact in real numbers,
//                                          and it keeps the difference of two
//                                          nearly equal sums usable in f32)
//   new_l2 = sum en^2
// No residual vector is stored.
//
// What bounds it: it reads the three [C, P] observation tables once (12 bytes
// per cell), but on the H100 the issue of two forward models per cell, at
// every cell of the grid, takes longer than those bytes. Design:
// - a unit of work is kCamChunk cameras x 128 points (one point a thread);
//   the grid is at most as many blocks as the card holds resident at once,
//   sized so that each block walks the same number of units (blockIdx.x,
//   blockIdx.x + gridDim.x, ... in order): no partial last wave;
// - a unit issues all 3 x kCamChunk table loads of its thread before any
//   arithmetic (the camera loop is unrolled at compile time), so each thread
//   keeps 24 loads in flight instead of 3;
// - the camera-only term s = sqrt(1 - |v|^2) is computed once per camera
//   record of the unit, by the same expression as cell_forward (the same
//   bits), not once per cell; the records sit in two shared buffers that
//   alternate between units, so one barrier per unit suffices;
// - with an occupancy table (tile_mask [C, n_tiles] int32, bit (c, t) = 1
//   iff camera c observes a point of tile t) a unit with no bit set is
//   skipped before its table loads and its barrier, and a camera whose bit
//   is 0 loads nothing and skips both forward models. A block reads the
//   bits of its next kBatch units into shared memory, one unit a thread,
//   then walks them, so no unit waits for its own bits. The unit walk
//   stays fixed, so every sum keeps its order: a skipped cell would have
//   added exactly 0, and the result has the unmasked kernel's bits;
// - each block reduces its sums with warp shuffles and writes one partial;
//   the last block to take an integer ticket sums the partials in a fixed
//   order and writes (gain, new_l2), then resets the ticket. One launch, no
//   float atomics: two calls give the same bits.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 128;      // points per unit, one per thread
constexpr int kCamChunk = 8;       // cameras per unit (unrolled)
constexpr int kWarps = kThreads / 32;
constexpr int kRec = kCamRec + 1;  // the camera record, then its s
// units whose live bits a block reads at once (at the dense cap, 32M cells,
// a block walks some 15 units on the H100)
constexpr int kBatch = 64;
static_assert(kBatch <= kThreads, "one unit's bits a thread");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums (a, b) over the block in a fixed order; the result is valid in
// thread 0. `red` must not be read by any thread when this is entered.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp][0] = a;
    red[warp][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[w][0];
      b += red[w][1];
    }
  }
}

// Bit g: camera c0 + g of unit u (a chunk of kCamChunk cameras by a tile of
// kThreads points) observes a point of the tile; every camera of the chunk
// without a table.
__device__ __forceinline__ unsigned unit_live(const int* __restrict__ mask,
                                              int u, int n_tiles, int C) {
  const int cg = u / n_tiles;
  const int c0 = cg * kCamChunk, t = u - cg * n_tiles;
  const int nc = min(kCamChunk, C - c0);
  unsigned live = 0u;
#pragma unroll
  for (int g = 0; g < kCamChunk; ++g)
    if (g < nc &&
        (mask == nullptr || mask[(size_t)(c0 + g) * n_tiles + t] != 0))
      live |= 1u << g;
  return live;
}

__global__ void __launch_bounds__(kThreads)
    gain_dense_kernel(const float* __restrict__ kq,
                      const float* __restrict__ cams_old,
                      const float* __restrict__ pts_old,
                      const float* __restrict__ cams_new,
                      const float* __restrict__ pts_new,
                      const float* __restrict__ obs_du,
                      const float* __restrict__ obs_dv,
                      const float* __restrict__ valid,
                      const int* __restrict__ tile_mask, int C, int P,
                      int clamp, int n_tiles, int n_units,
                      float* __restrict__ part,
                      unsigned* __restrict__ ticket, float* __restrict__ out) {
  // [buffer][old, new][camera of the chunk][record]
  __shared__ float rec_s[2][2][kCamChunk][kRec];
  __shared__ float red[kWarps][2];
  __shared__ unsigned live_s[kBatch];  // bits of the batch's units
  __shared__ bool last;
  const int tid = threadIdx.x;
  float gain = 0.0f, l2 = 0.0f;
  int buf = 0;
  for (int u = blockIdx.x, k = 0; u < n_units; u += gridDim.x, ++k) {
    if (k % kBatch == 0) {  // the bits of this unit and the next ones
      __syncthreads();      // (the last batch's bits are read)
      const int ui = u + tid * gridDim.x;
      if (tid < kBatch && ui < n_units)
        live_s[tid] = unit_live(tile_mask, ui, n_tiles, C);
      __syncthreads();
    }
    const int cg = u / n_tiles;
    const int c0 = cg * kCamChunk;
    const int t = u - cg * n_tiles;
    // bit g: camera c0 + g observes a point of the unit (uniform over the
    // block, so a unit skipped here skips its barrier on every thread)
    const unsigned cams_live = live_s[k % kBatch];
    if (cams_live == 0u) continue;
    const int p = t * kThreads + tid;
    const bool in = p < P;
    float vm[kCamChunk], ou[kCamChunk], ov[kCamChunk];
#pragma unroll
    for (int g = 0; g < kCamChunk; ++g) {
      const bool live = in && (cams_live >> g & 1u);
      const size_t cell = (size_t)(c0 + g) * P + p;
      vm[g] = live ? valid[cell] : 0.0f;
      ou[g] = live ? obs_du[cell] : 0.0f;
      ov[g] = live ? obs_dv[cell] : 0.0f;
    }
    const float xo1 = in ? pts_old[3 * p + 0] : 0.0f;
    const float xo2 = in ? pts_old[3 * p + 1] : 0.0f;
    const float xo3 = in ? pts_old[3 * p + 2] : 0.0f;
    const float xn1 = in ? pts_new[3 * p + 0] : 0.0f;
    const float xn2 = in ? pts_new[3 * p + 1] : 0.0f;
    const float xn3 = in ? pts_new[3 * p + 2] : 0.0f;
    if (tid < 2 * kCamChunk) {
      const int side = tid / kCamChunk, g = tid % kCamChunk;
      if (cams_live >> g & 1u) {
        float* r = rec_s[buf][side][g];
        const float* cam = (side ? cams_new : cams_old) + (c0 + g) * 6;
#pragma unroll
        for (int k = 0; k < 9; ++k) r[k] = kq[(c0 + g) * 9 + k];
#pragma unroll
        for (int k = 0; k < 6; ++k) r[9 + k] = cam[k];
        r[kCamRec] = camera_s(r, clamp != 0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kCamChunk; ++g) {
      if (cams_live >> g & 1u) {
        const float* ro = rec_s[buf][0][g];
        const float* rn = rec_s[buf][1][g];
        float eou, eov, enu, env;
        cell_residual_s(ro, ro[kCamRec], xo1, xo2, xo3, ou[g], ov[g], vm[g],
                        eou, eov);
        cell_residual_s(rn, rn[kCamRec], xn1, xn2, xn3, ou[g], ov[g], vm[g],
                        enu, env);
        gain += (eou - enu) * (eou + enu) + (eov - env) * (eov + env);
        l2 += enu * enu + env * env;
      }
    }
    buf ^= 1;
  }

  block_sum2(gain, l2, red);
  if (tid == 0) {
    part[2 * blockIdx.x + 0] = gain;
    part[2 * blockIdx.x + 1] = l2;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written and visible (the writers'
  // fences precede their tickets)
  __threadfence();
  float sg = 0.0f, sl = 0.0f;
#pragma unroll 8
  for (int b = tid; b < gridDim.x; b += kThreads) {
    sg += __ldcg(part + 2 * b + 0);
    sl += __ldcg(part + 2 * b + 1);
  }
  block_sum2(sg, sl, red);
  if (tid == 0) {
    out[0] = sg;
    out[1] = sl;
    *ticket = 0u;
  }
}

}  // namespace

extern "C" int psba_gain_dense_ptile() { return kThreads; }
extern "C" int psba_gain_dense_cam_chunk() { return kCamChunk; }

// Blocks of the kernel the current device holds resident at once: the
// largest grid psba_gain_dense launches. 0 on an error.
extern "C" int psba_gain_dense_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gain_dense_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// kq [C, 9], cams_* [C, 6], pts_* [P, 3], obs_du/obs_dv/valid [C, P];
// tile_mask [C, ceil(P / kThreads)] int32 or null (every unit visited);
// max_blocks = psba_gain_dense_resident_blocks(); ws: int32 [1 + 2 *
// max_blocks], zero in its first entry (the ticket, which the kernel leaves
// at zero), block partials after it; out [2] = (gain, new_l2). Returns
// cudaGetLastError().
extern "C" int psba_gain_dense(const float* kq, const float* cams_old,
                               const float* pts_old, const float* cams_new,
                               const float* pts_new, const float* obs_du,
                               const float* obs_dv, const float* valid,
                               const int* tile_mask, int C, int P, int clamp,
                               int max_blocks, int* ws, float* out,
                               void* stream) {
  if (C < 1 || P < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (P + kThreads - 1) / kThreads;
  const int n_units = n_tiles * ((C + kCamChunk - 1) / kCamChunk);
  // as many blocks as fit at once, each walking the same number of units
  const int per_block = (n_units + max_blocks - 1) / max_blocks;
  const int grid = (n_units + per_block - 1) / per_block;
  gain_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      kq, cams_old, pts_old, cams_new, pts_new, obs_du, obs_dv, valid,
      tile_mask, C, P, clamp, n_tiles, n_units,
      reinterpret_cast<float*>(ws + 1), reinterpret_cast<unsigned*>(ws), out);
  return (int)cudaGetLastError();
}
