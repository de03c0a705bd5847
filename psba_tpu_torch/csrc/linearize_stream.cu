// Observation-stream linearization of the bundle-adjustment cost on Hopper.
//
// Replaces: psba_tpu/ops/linearize_pallas.py::linearize_pallas (kernel
// _linearize_kernel).
//
// Per observation o (camera c, point p): the residual ex = obs - proj, always
// written, unmasked; A (2x6) and B (2x3) with want_jac; W = A^T B with
// want_w; the point pack B^T B | B^T ex with want_point (summed by point
// outside). Always: the camera blocks U = A^T A (21 upper entries) and
// ga = A^T ex summed over each camera's observations, and the masked sum of
// squared residuals. `valid` (optional) masks A, B and every pack; ex stays
// unmasked, as in the Pallas kernel.
//
// What bounds it: with the TR flags, about 430 flops per observation (300 of
// cell model and Jacobian, 130 of camera pack) against 24 bytes that must
// move (the measurement, two int32 index streams, the ex write): 18 flops a
// byte, just under the card's float32 ridge of 20 (67 TFLOP/s over 3.35
// TB/s), so device memory binds, with the arithmetic within 10% of it. The
// point gather (12 bytes, scattered, mostly from L2) comes on top.
//
// Design: the camera reduction decides how close the TR phase gets to the
// optimum in float32 (TR takes ga as its Cauchy direction), so it has no
// float atomics and no long serial sum. The observations are walked in a
// camera-sorted permutation built once on the host (ProblemArrays.stream):
// each block takes a run of at most kChunk observations of one camera, each
// thread sums its kChunk / kThreads observations (4 terms), the warp reduces
// the 28 values (21 of U, 6 of ga, 1 of l2) with shuffles, the block's
// eight warps add in a fixed order in shared memory, and the block writes
// its 28 partials to part[c, slot]. The wrapper sums over the (at most
// max_chunks) slots of each camera. The result does not depend on block
// order. Per-observation outputs are scattered back to the original index o.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // observations per block (one camera)
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 28;     // 21 upper-triangle U, 6 ga, 1 l2

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// chunks [n_chunks, 4] int32: (camera, first index into perm, count, slot)
__global__ void __launch_bounds__(kThreads)
    linearize_stream_kernel(const float* __restrict__ kq,
                            const float* __restrict__ cams,
                            const float* __restrict__ pts,
                            const float* __restrict__ obs,
                            const float* __restrict__ valid,
                            const int* __restrict__ perm,
                            const int* __restrict__ pt_of,
                            const int* __restrict__ chunks, int max_chunks,
                            int clamp, float* __restrict__ ex,
                            float* __restrict__ jac_a,
                            float* __restrict__ jac_b,
                            float* __restrict__ w_out,
                            float* __restrict__ ptpack,
                            float* __restrict__ part) {
  __shared__ float cam_s[kCamRec];
  __shared__ float red[kWarps][kPack];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = chunks[4 * blockIdx.x + 0];
  const int first = chunks[4 * blockIdx.x + 1];
  const int count = chunks[4 * blockIdx.x + 2];
  const int slot = chunks[4 * blockIdx.x + 3];
  if (tid < kCamRec)
    cam_s[tid] = tid < 9 ? kq[c * 9 + tid] : cams[c * 6 + (tid - 9)];
  __syncthreads();

  float acc[kPack];
#pragma unroll
  for (int r = 0; r < kPack; ++r) acc[r] = 0.0f;

  for (int i = tid; i < count; i += kThreads) {
    const int o = perm[first + i];
    const int p = pt_of[first + i];
    const float x1 = pts[3 * p + 0], x2 = pts[3 * p + 1], x3 = pts[3 * p + 2];
    const float obu = obs[2 * (size_t)o], obv = obs[2 * (size_t)o + 1];
    float A[2][6], B[2][3], exu, exv;
    // vmask 1: the residual is unmasked (no depth guard), as in the Pallas
    // kernel; the mask applies to A, B and the packs below
    cell_linearize(cam_s, x1, x2, x3, obu, obv, 1.0f, clamp != 0, A, B, exu,
                   exv);
    reinterpret_cast<float2*>(ex)[o] = make_float2(exu, exv);
    const float m = valid != nullptr ? valid[o] : 1.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < 6; ++k) A[r][k] *= m;
#pragma unroll
      for (int k = 0; k < 3; ++k) B[r][k] *= m;
    }
    const float mexu = exu * m, mexv = exv * m;
    if (jac_a != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int k = 0; k < 6; ++k)
          jac_a[(size_t)o * 12 + r * 6 + k] = A[r][k];
#pragma unroll
        for (int k = 0; k < 3; ++k) jac_b[(size_t)o * 6 + r * 3 + k] = B[r][k];
      }
    }
    if (w_out != nullptr) {
#pragma unroll
      for (int i6 = 0; i6 < 6; ++i6)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          w_out[(size_t)o * 18 + i6 * 3 + j] =
              A[0][i6] * B[0][j] + A[1][i6] * B[1][j];
    }
    if (ptpack != nullptr) {
#pragma unroll
      for (int i3 = 0; i3 < 3; ++i3) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          ptpack[(size_t)o * 12 + i3 * 3 + j] =
              B[0][i3] * B[0][j] + B[1][i3] * B[1][j];
        ptpack[(size_t)o * 12 + 9 + i3] = B[0][i3] * mexu + B[1][i3] * mexv;
      }
    }
    int r = 0;
#pragma unroll
    for (int i6 = 0; i6 < 6; ++i6)
#pragma unroll
      for (int j = i6; j < 6; ++j)
        acc[r++] += A[0][i6] * A[0][j] + A[1][i6] * A[1][j];
#pragma unroll
    for (int i6 = 0; i6 < 6; ++i6)
      acc[21 + i6] += A[0][i6] * mexu + A[1][i6] * mexv;
    acc[27] += mexu * exu + mexv * exv;
  }

#pragma unroll
  for (int r = 0; r < kPack; ++r) {
    const float t = warp_sum(acc[r]);
    if (lane == 0) red[warp][r] = t;
  }
  __syncthreads();
  if (tid < kPack) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    part[((size_t)c * max_chunks + slot) * kPack + tid] = s;
  }
}

}  // namespace

extern "C" int psba_linearize_stream_chunk() { return kChunk; }
extern "C" int psba_linearize_stream_pack() { return kPack; }

// kq [C, 9] (K | q0), cams [C, 6], pts [P, 3], obs [O, 2], valid [O] or
// null, perm / pt_of [O] int32 (camera-sorted observation order and its
// points), chunks [n_chunks, 4] int32. Outputs: ex [O, 2]; jac_a [O, 12] and
// jac_b [O, 6], w_out [O, 18], ptpack [O, 12] unless null; part
// [C, max_chunks, 28], zero-filled by the caller (slots without a block stay
// 0). Returns cudaGetLastError().
extern "C" int psba_linearize_stream(const float* kq, const float* cams,
                                     const float* pts, const float* obs,
                                     const float* valid, const int* perm,
                                     const int* pt_of, const int* chunks,
                                     int n_chunks, int max_chunks, int clamp,
                                     float* ex, float* jac_a, float* jac_b,
                                     float* w_out, float* ptpack, float* part,
                                     void* stream) {
  if (n_chunks < 1 || max_chunks < 1 ||
      (jac_a == nullptr) != (jac_b == nullptr))
    return (int)cudaErrorInvalidValue;
  linearize_stream_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      kq, cams, pts, obs, valid, perm, pt_of, chunks, max_chunks, clamp, ex,
      jac_a, jac_b, w_out, ptpack, part);
  return (int)cudaGetLastError();
}
