// Dense-grid linearization of the bundle-adjustment cost on Hopper.
//
// Replaces: psba_tpu/ops/linearize_dense.py::linearize_dense_pallas
// (kernel _dense_kernel) with want_u=True.
//
// Computes, for every (camera c, point p) cell of the dense grid masked by
// valid[c, p]: the planar stacked factor ZWk[6c+i, p] = W[i, k] (W = A^T B),
// the point blocks V = B^T B and gradient gb = B^T ex summed over cameras,
// and the camera blocks U = A^T A, ga = A^T ex summed over points.
//
// What bounds it: the ZW planes are written once per call, 18 floats per
// cell (192 MB at 138 cameras x 19,328 padded points), against ~300 flops of
// cell model per cell, so the kernel is bound by device-memory writes once
// the card is full. Design:
// - one thread per point column; a block covers 128 points and a chunk of
//   kCamChunk cameras (grid = Pp/128 x ceil(C/kCamChunk)), so some 2,700
//   blocks fill the 132 SMs where one thread per point over all cameras
//   would leave nine tenths of them idle;
// - ZW stores are coalesced across the neighbouring points of a warp;
// - V and gb accumulate in registers over the block's cameras and are
//   written as one partial per camera chunk [n_cg, 9, Pp], summed outside
//   (the Pallas kernel's per-chunk V pack);
// - U and ga (27 values per camera) reduce over the warp with shuffles, over
//   the block's four warps in shared memory, and are written as one partial
//   per point block [Pp/128, C, 27], summed outside. No atomics: the result
//   does not depend on the order in which blocks run, which on a TPU the
//   sequential grid gave for free.
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
                           const float* __restrict__ valid, int C, int P,
                           int Pp, int clamp, float* __restrict__ zw,
                           float* __restrict__ vpart,
                           float* __restrict__ upart) {
  __shared__ float cam_s[kCamChunk][kCamRec];
  __shared__ float u_s[kWarps][kCamChunk][kUPack];
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
  __syncthreads();

  // padded point lanes (p >= P) see a zero point and a zero mask: every
  // output they write is exactly zero
  const bool in = p < P;
  const float x1 = in ? pts[3 * p + 0] : 0.0f;
  const float x2 = in ? pts[3 * p + 1] : 0.0f;
  const float x3 = in ? pts[3 * p + 2] : 0.0f;
  // V00 V01 V02 V11 V12 V22 gb0 gb1 gb2
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const size_t plane = (size_t)6 * C * Pp;

  for (int g = 0; g < nc; ++g) {
    const int c = c0 + g;
    const size_t cell = (size_t)c * P + p;
    const float vmask = in ? valid[cell] : 0.0f;
    const float ou = in ? obs_du[cell] : 0.0f;
    const float ov = in ? obs_dv[cell] : 0.0f;
    float A[2][6], B[2][3], exu, exv;
    cell_linearize(cam_s[g], x1, x2, x3, ou, ov, vmask, clamp != 0, A, B, exu,
                   exv);

#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* row = zw + k * plane + (size_t)(6 * c) * Pp + p;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        row[(size_t)i * Pp] = A[0][i] * B[0][k] + A[1][i] * B[1][k];
    }
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
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += u_s[w][g][r];
      upart[((size_t)blockIdx.x * C + c0 + g) * kUPack + r] = s;
    }
  }
}

}  // namespace

extern "C" int psba_linearize_dense_ptile() { return kThreads; }
extern "C" int psba_linearize_dense_cam_chunk() { return kCamChunk; }

// kq [C, 9] (K | q0), cams [C, 6], pts [P, 3], obs_du/obs_dv/valid [C, P];
// outputs zw [3, 6C, Pp], vpart [ceil(C/kCamChunk), 9, Pp] and, unless
// upart is null, upart [Pp/kThreads, C, 27]. Returns cudaGetLastError().
extern "C" int psba_linearize_dense(const float* kq, const float* cams,
                                    const float* pts, const float* obs_du,
                                    const float* obs_dv, const float* valid,
                                    int C, int P, int Pp, int clamp, float* zw,
                                    float* vpart, float* upart, void* stream) {
  if (C < 1 || P < 1 || Pp < P || Pp % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Pp / kThreads, (C + kCamChunk - 1) / kCamChunk);
  linearize_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      kq, cams, pts, obs_du, obs_dv, valid, C, P, Pp, clamp, zw, vpart, upart);
  return (int)cudaGetLastError();
}
