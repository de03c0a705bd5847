// Observation-stream linearization of the bundle-adjustment cost on Hopper.
//
// Replaces: psba_tpu/ops/linearize_pallas.py::linearize_pallas (kernel
// _linearize_kernel).
//
// Per observation o (camera c, point p): the residual ex = obs - proj,
// unmasked; A (2x6) and B (2x3) with want_jac; W = A^T B with want_w; and,
// with want_point, V = B^T B and gb = B^T ex summed over each point's
// observations. Always: the camera blocks U = A^T A (21 upper entries) and
// ga = A^T ex summed over each camera's observations, and the masked sum of
// squared residuals. `valid` (optional) masks A, B, W and every sum; ex
// stays unmasked, as in the Pallas kernel.
//
// What bounds it: bytes. With the TR flags (U, ga, l2, ex) about 430 flops
// per observation against 24 bytes that must move: 18 flops a byte, just
// under the card's float32 ridge of 20. With the pair path's flags the
// per-observation outputs dominate: ex and W are 80 bytes an observation
// (A and B another 72), V and gb 48 bytes a point.
//
// Design: two passes, each in an order in which its sums need no atomics.
// - Camera pass (linearize_stream_kernel): the observations in a
//   camera-sorted permutation built once on the host (ProblemArrays.stream).
//   Each block takes a run of at most kChunk observations of one camera,
//   each thread sums its kChunk / kThreads observations, the warp reduces
//   the 28 values (21 of U, 6 of ga, 1 of l2) with shuffles, the block's
//   eight warps add in a fixed order in shared memory, and the block writes
//   its 28 partials to part[c, slot]; the wrapper sums the slots. This pass
//   writes ex (scattered, 8 bytes) only when the point pass does not run.
// - Point pass (linearize_stream_points_kernel), when W, A / B or the point
//   sums are asked for: the observations in their own, point-sorted order.
//   A block takes a run of at most kRun consecutive observations cut at
//   point boundaries (a point with more than kRun observations is cut into
//   pieces of its own), one observation a thread. Each per-observation
//   output is staged in shared memory and written as one contiguous span
//   with 16-byte stores, so every sector is written whole. V and gb are
//   summed per point in shared memory by the thread of that point, in
//   observation order, and each point's 12 values are written once, again
//   as one span per block; a cut point's pieces write partials that the
//   wrapper adds in piece order. So V and gb, like U and ga, do not depend
//   on block order.
// Both passes evaluate the cell model (cell_model.cuh); the repeat costs
// about 430 flops an observation, small against the bytes it saves.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // camera pass: observations per block
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 28;     // 21 upper-triangle U, 6 ga, 1 l2
constexpr int kRun = kThreads;  // point pass: observations per block
constexpr int kPt = 12;         // per point: V (9), gb (3)
constexpr int kStage = kRun * 18 + 4;  // widest per-observation output, W

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
    const float2 ob = reinterpret_cast<const float2*>(obs)[o];
    float A[2][6], B[2][3], exu, exv;
    // vmask 1: the residual is unmasked (no depth guard), as in the Pallas
    // kernel; the mask applies to the sums below
    cell_linearize(cam_s, x1, x2, x3, ob.x, ob.y, 1.0f, clamp != 0, A, B, exu,
                   exv);
    if (ex != nullptr)
      reinterpret_cast<float2*>(ex)[o] = make_float2(exu, exv);
    const float m = valid != nullptr ? valid[o] : 1.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) A[r][k] *= m;
    const float mexu = exu * m, mexv = exv * m;
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

// Write sbuf[s0 .. s0 + n) to dst[0 .. n), where s0 = (dst / 4) % 4 so that
// equal indices share their alignment: whole float4s in the middle, single
// floats at the two ends. dst - s0 is 16-byte aligned.
__device__ __forceinline__ void span_out(float* __restrict__ dst,
                                         const float* __restrict__ sbuf,
                                         int s0, int n) {
  float* base = dst - s0;
  const int end = s0 + n;
  for (int i4 = threadIdx.x; 4 * i4 < end; i4 += kThreads) {
    const int i = 4 * i4;
    if (i >= s0 && i + 4 <= end) {
      reinterpret_cast<float4*>(base)[i4] =
          reinterpret_cast<const float4*>(sbuf)[i4];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i + q >= s0 && i + q < end) base[i + q] = sbuf[i + q];
    }
  }
}

// Stage the K values v[] of observation t (when it exists), then write the
// block's span of out (row obs0 on, K floats a row).
template <int K>
__device__ __forceinline__ void stage_out(float* __restrict__ out, int obs0,
                                          int count, bool mine,
                                          const float (&v)[K],
                                          float* __restrict__ sbuf) {
  const int s0 = (int)(((size_t)obs0 * K) & 3);
  if (mine) {
#pragma unroll
    for (int j = 0; j < K; ++j) sbuf[s0 + threadIdx.x * K + j] = v[j];
  }
  __syncthreads();
  span_out(out + (size_t)obs0 * K, sbuf, s0, count * K);
  __syncthreads();
}

// runs [n_runs, 5] int32: (first observation, count, first point, points,
// piece). piece < 0: the run holds the whole of points first .. first +
// points - 1 (some may have no observation) and writes their 12 sums to
// ptpack; piece >= 0: the run is a piece of one point cut into several and
// writes its partial sums to pieces[piece].
__global__ void __launch_bounds__(kThreads)
    linearize_stream_points_kernel(
        const float* __restrict__ kq, const float* __restrict__ cams,
        const float* __restrict__ pts, const float* __restrict__ obs,
        const float* __restrict__ valid, const int* __restrict__ cam32,
        const int* __restrict__ pt32, const int* __restrict__ runs, int clamp,
        float* __restrict__ ex, float* __restrict__ jac_a,
        float* __restrict__ jac_b, float* __restrict__ w_out,
        float* __restrict__ ptpack, float* __restrict__ pieces) {
  __shared__ float4 sbuf4[(kStage + 3) / 4];
  __shared__ float pk[kRun][kPt + 1];
  __shared__ int pidx[kRun];
  __shared__ int seg_lo[kRun], seg_hi[kRun];
  float* sbuf = reinterpret_cast<float*>(sbuf4);
  const int tid = threadIdx.x;
  const int obs0 = runs[5 * blockIdx.x + 0];
  const int count = runs[5 * blockIdx.x + 1];
  const int pt0 = runs[5 * blockIdx.x + 2];
  const int npt = runs[5 * blockIdx.x + 3];
  const int piece = runs[5 * blockIdx.x + 4];
  const bool mine = tid < count;

  float A[2][6], B[2][3], e[2] = {0.0f, 0.0f}, mexu = 0.0f, mexv = 0.0f;
  if (mine) {
    const int o = obs0 + tid;
    const int c = cam32[o], p = pt32[o];
    pidx[tid] = p;
    float cam[kCamRec];
#pragma unroll
    for (int q = 0; q < 9; ++q) cam[q] = __ldg(kq + c * 9 + q);
#pragma unroll
    for (int q = 0; q < 6; ++q) cam[9 + q] = __ldg(cams + c * 6 + q);
    const float2 ob = reinterpret_cast<const float2*>(obs)[o];
    cell_linearize(cam, pts[3 * p], pts[3 * p + 1], pts[3 * p + 2], ob.x,
                   ob.y, 1.0f, clamp != 0, A, B, e[0], e[1]);
    const float m = valid != nullptr ? valid[o] : 1.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < 6; ++k) A[r][k] *= m;
#pragma unroll
      for (int k = 0; k < 3; ++k) B[r][k] *= m;
    }
    mexu = e[0] * m;
    mexv = e[1] * m;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < 6; ++k) A[r][k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) B[r][k] = 0.0f;
    }
  }

  stage_out<2>(ex, obs0, count, mine, e, sbuf);
  if (w_out != nullptr) {
    float w[18];
#pragma unroll
    for (int i6 = 0; i6 < 6; ++i6)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        w[i6 * 3 + j] = A[0][i6] * B[0][j] + A[1][i6] * B[1][j];
    stage_out<18>(w_out, obs0, count, mine, w, sbuf);
  }
  if (jac_a != nullptr) {
    float a[12], bb[6];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < 6; ++k) a[r * 6 + k] = A[r][k];
#pragma unroll
      for (int k = 0; k < 3; ++k) bb[r * 3 + k] = B[r][k];
    }
    stage_out<12>(jac_a, obs0, count, mine, a, sbuf);
    stage_out<6>(jac_b, obs0, count, mine, bb, sbuf);
  }
  if (ptpack == nullptr) return;

  // per-observation point pack: B^T B (9) | B^T ex (3)
  if (mine) {
#pragma unroll
    for (int i3 = 0; i3 < 3; ++i3) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        pk[tid][i3 * 3 + j] = B[0][i3] * B[0][j] + B[1][i3] * B[1][j];
      pk[tid][9 + i3] = B[0][i3] * mexu + B[1][i3] * mexv;
    }
  }
  if (piece >= 0) {  // one point's piece: a partial sum in order
    __syncthreads();
    if (tid < kPt) {
      float s = 0.0f;
      for (int i = 0; i < count; ++i) s += pk[i][tid];
      pieces[piece * kPt + tid] = s;
    }
    return;
  }
  // each point's observations in this run: [seg_lo, seg_hi), empty for a
  // point with none
  if (tid < npt) seg_lo[tid] = seg_hi[tid] = 0;
  __syncthreads();
  if (mine) {
    const int p = pidx[tid];
    if (tid == 0 || pidx[tid - 1] != p) seg_lo[p - pt0] = tid;
    if (tid == count - 1 || pidx[tid + 1] != p) seg_hi[p - pt0] = tid + 1;
  }
  __syncthreads();
  if (tid < npt) {
    float s[kPt];
#pragma unroll
    for (int j = 0; j < kPt; ++j) s[j] = 0.0f;
    for (int i = seg_lo[tid]; i < seg_hi[tid]; ++i) {
#pragma unroll
      for (int j = 0; j < kPt; ++j) s[j] += pk[i][j];
    }
#pragma unroll
    for (int j = 0; j < kPt; ++j) sbuf[tid * kPt + j] = s[j];
  }
  __syncthreads();
  span_out(ptpack + (size_t)pt0 * kPt, sbuf, 0, npt * kPt);
}

}  // namespace

extern "C" int psba_linearize_stream_chunk() { return kChunk; }
extern "C" int psba_linearize_stream_pack() { return kPack; }
extern "C" int psba_linearize_stream_run() { return kRun; }

// kq [C, 9] (K | q0), cams [C, 6], pts [P, 3], obs [O, 2], valid [O] or
// null. Camera pass: perm / pt_of [O] int32 (camera-sorted observation order
// and its points), chunks [n_chunks, 4] int32, part [C, max_chunks, 28]
// zero-filled by the caller (slots without a block stay 0). Point pass, run
// when any of jac_a, w_out, ptpack is given: cam32 / pt32 [O] int32, runs
// [n_runs, 5] int32; outputs jac_a [O, 12] and jac_b [O, 6] (both or
// neither), w_out [O, 18], ptpack [P, 12] and pieces [n_pieces, 12] unless
// null. ex [O, 2] is written by the point pass when it runs, else by the
// camera pass. Returns cudaGetLastError().
extern "C" int psba_linearize_stream(
    const float* kq, const float* cams, const float* pts, const float* obs,
    const float* valid, const int* perm, const int* pt_of, const int* chunks,
    int n_chunks, int max_chunks, const int* cam32, const int* pt32,
    const int* runs, int n_runs, int clamp, float* ex, float* jac_a,
    float* jac_b, float* w_out, float* ptpack, float* pieces, float* part,
    void* stream) {
  const bool points = jac_a != nullptr || w_out != nullptr ||
                      ptpack != nullptr;
  if (n_chunks < 1 || max_chunks < 1 ||
      (jac_a == nullptr) != (jac_b == nullptr) ||
      (points && (n_runs < 1 || runs == nullptr || cam32 == nullptr ||
                  pt32 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  linearize_stream_kernel<<<n_chunks, kThreads, 0, s>>>(
      kq, cams, pts, obs, valid, perm, pt_of, chunks, max_chunks, clamp,
      points ? nullptr : ex, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !points) return (int)e;
  linearize_stream_points_kernel<<<n_runs, kThreads, 0, s>>>(
      kq, cams, pts, obs, valid, cam32, pt32, runs, clamp, ex, jac_a, jac_b,
      w_out, ptpack, pieces);
  return (int)cudaGetLastError();
}
