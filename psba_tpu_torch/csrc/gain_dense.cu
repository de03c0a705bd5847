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
// per cell) against about twice the cell model's forward flops, so it is
// bound by device-memory reads once the card is full. Same grid as
// linearize_dense.cu (128 points x kCamChunk cameras per block); each block
// reduces its sums with warp shuffles and writes one partial [n_blocks, 2],
// summed outside, with no atomics.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCamChunk = 8;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    gain_dense_kernel(const float* __restrict__ kq,
                      const float* __restrict__ cams_old,
                      const float* __restrict__ pts_old,
                      const float* __restrict__ cams_new,
                      const float* __restrict__ pts_new,
                      const float* __restrict__ obs_du,
                      const float* __restrict__ obs_dv,
                      const float* __restrict__ valid, int C, int P, int clamp,
                      float* __restrict__ part) {
  __shared__ float co_s[kCamChunk][kCamRec];
  __shared__ float cn_s[kCamChunk][kCamRec];
  __shared__ float red[kWarps][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x * kThreads + tid;
  const int c0 = blockIdx.y * kCamChunk;
  const int nc = min(kCamChunk, C - c0);
  for (int i = tid; i < nc * kCamRec; i += kThreads) {
    const int g = i / kCamRec, k = i % kCamRec;
    const int c = c0 + g;
    co_s[g][k] = k < 9 ? kq[c * 9 + k] : cams_old[c * 6 + (k - 9)];
    cn_s[g][k] = k < 9 ? kq[c * 9 + k] : cams_new[c * 6 + (k - 9)];
  }
  __syncthreads();

  const bool in = p < P;
  const float xo1 = in ? pts_old[3 * p + 0] : 0.0f;
  const float xo2 = in ? pts_old[3 * p + 1] : 0.0f;
  const float xo3 = in ? pts_old[3 * p + 2] : 0.0f;
  const float xn1 = in ? pts_new[3 * p + 0] : 0.0f;
  const float xn2 = in ? pts_new[3 * p + 1] : 0.0f;
  const float xn3 = in ? pts_new[3 * p + 2] : 0.0f;
  float gain = 0.0f, l2 = 0.0f;
  for (int g = 0; g < nc; ++g) {
    const size_t cell = (size_t)(c0 + g) * P + p;
    const float vmask = in ? valid[cell] : 0.0f;
    const float ou = in ? obs_du[cell] : 0.0f;
    const float ov = in ? obs_dv[cell] : 0.0f;
    float eou, eov, enu, env;
    cell_residual(co_s[g], xo1, xo2, xo3, ou, ov, vmask, clamp != 0, eou, eov);
    cell_residual(cn_s[g], xn1, xn2, xn3, ou, ov, vmask, clamp != 0, enu, env);
    gain += (eou - enu) * (eou + enu) + (eov - env) * (eov + env);
    l2 += enu * enu + env * env;
  }
  gain = warp_sum(gain);
  l2 = warp_sum(l2);
  if (lane == 0) {
    red[warp][0] = gain;
    red[warp][1] = l2;
  }
  __syncthreads();
  if (tid == 0) {
    float sg = 0.0f, sl = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sg += red[w][0];
      sl += red[w][1];
    }
    const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    part[2 * b + 0] = sg;
    part[2 * b + 1] = sl;
  }
}

}  // namespace

extern "C" int psba_gain_dense_ptile() { return kThreads; }
extern "C" int psba_gain_dense_cam_chunk() { return kCamChunk; }

// kq [C, 9], cams_* [C, 6], pts_* [P, 3], obs_du/obs_dv/valid [C, P];
// part [ceil(C/kCamChunk) * ceil(P/kThreads), 2]. Returns cudaGetLastError().
extern "C" int psba_gain_dense(const float* kq, const float* cams_old,
                               const float* pts_old, const float* cams_new,
                               const float* pts_new, const float* obs_du,
                               const float* obs_dv, const float* valid, int C,
                               int P, int clamp, float* part, void* stream) {
  if (C < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads,
                  (C + kCamChunk - 1) / kCamChunk);
  gain_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      kq, cams_old, pts_old, cams_new, pts_new, obs_du, obs_dv, valid, C, P,
      clamp, part);
  return (int)cudaGetLastError();
}
