// Trial-step residual and its sum of squares over the observation stream,
// on Hopper.
//
// Replaces: psba_tpu/ops/linearize_pallas.py::residual_l2_pallas (kernel
// _residual_kernel).
//
// Per observation o (camera c = cam_idx[o], point p = pt_idx[o]): the
// residual ex[o] = obs[o] - proj(camera c, point p), written unmasked, and
//   l2 = sum over o of valid[o] * |ex[o]|^2      (valid = 1 when absent).
// Same forward model as the other kernels (cell_model.cuh, vmask 1: no
// depth guard, as the Pallas kernel).
//
// What bounds it: per observation it reads the measurement (8 bytes), two
// int32 indices (8), the gathered point (12) and writes ex (8): 36 bytes
// against about 90 flops, 2.5 flops a byte, far under the card's float32
// ridge of 20, so device memory binds. The camera rows (15 floats) are few
// and stay in L1 / L2.
//
// Design: one thread per observation, kPerThread observations a thread at a
// stride of the block width (neighbouring threads on neighbouring
// observations, so obs / index reads and ex writes coalesce). A bounds
// check on O replaces the Pallas kernel's duplicate-column padding. The l2
// sum, which the Pallas kernel carried across its sequential grid in SMEM,
// has no counterpart on a card whose blocks run in no order: each thread
// sums its terms, the warp reduces with shuffles, the block adds its warps
// in a fixed order in shared memory and writes one partial; the wrapper sums
// the partials. No atomics: the result does not depend on block order.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    residual_l2_kernel(const float* __restrict__ kq,
                       const float* __restrict__ cams,
                       const float* __restrict__ pts,
                       const float* __restrict__ obs,
                       const int* __restrict__ cam_idx,
                       const int* __restrict__ pt_idx,
                       const float* __restrict__ valid, int O, int clamp,
                       float* __restrict__ ex, float* __restrict__ part) {
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * kPerBlock;
  float l2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t o = base + (size_t)k * kThreads + tid;
    if (o < (size_t)O) {
      const int c = cam_idx[o];
      const int p = pt_idx[o];
      float cam[kCamRec];
#pragma unroll
      for (int i = 0; i < 9; ++i) cam[i] = kq[9 * c + i];
#pragma unroll
      for (int i = 0; i < 6; ++i) cam[9 + i] = cams[6 * c + i];
      const float2 ob = reinterpret_cast<const float2*>(obs)[o];
      float exu, exv;
      cell_residual(cam, pts[3 * p + 0], pts[3 * p + 1], pts[3 * p + 2], ob.x,
                    ob.y, 1.0f, clamp != 0, exu, exv);
      reinterpret_cast<float2*>(ex)[o] = make_float2(exu, exv);
      const float m = valid != nullptr ? valid[o] : 1.0f;
      l2 += (exu * exu + exv * exv) * m;
    }
  }
  l2 = warp_sum(l2);
  if (lane == 0) red[warp] = l2;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    part[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" int psba_residual_l2_per_block() { return kPerBlock; }

// kq [C, 9] (K | q0), cams [C, 6], pts [P, 3], obs [O, 2], cam_idx / pt_idx
// [O] int32, valid [O] or null. Outputs: ex [O, 2], part [ceil(O /
// kPerBlock)], one partial sum of valid * |ex|^2 per block. Returns
// cudaGetLastError().
extern "C" int psba_residual_l2(const float* kq, const float* cams,
                                const float* pts, const float* obs,
                                const int* cam_idx, const int* pt_idx,
                                const float* valid, int O, int clamp,
                                float* ex, float* part, void* stream) {
  if (O < 1) return (int)cudaErrorInvalidValue;
  const int n_blocks = (O + kPerBlock - 1) / kPerBlock;
  residual_l2_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      kq, cams, pts, obs, cam_idx, pt_idx, valid, O, clamp, ex, part);
  return (int)cudaGetLastError();
}
