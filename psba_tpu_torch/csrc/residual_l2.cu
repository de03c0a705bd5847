// Trial-step residual, its sum of squares and, optionally, the trial gain
// over the observation stream, on Hopper.
//
// Replaces: psba_tpu/ops/linearize_pallas.py::residual_l2_pallas (kernel
// _residual_kernel), and the XLA-fused error_l2_diff(ex_old, ex) that the
// reference's pair path computes beside it (psba_tpu/solvers/lm.py,
// tr.py).
//
// Per observation o (camera c = cam_idx[o], point p = pt_idx[o]): the
// residual ex[o] = obs[o] - proj(camera c, point p), written unmasked, and
//   l2   = sum over o of valid[o] * |ex[o]|^2      (valid = 1 when absent)
//   gain = sum over o of valid[o] * sum_r (eo - en)(eo + en)   (ex_old given;
//          eo = ex_old[o], en = ex[o], the factored form of error_l2_diff)
// Same forward model as the other kernels (cell_model.cuh, vmask 1: no
// depth guard, as the Pallas kernel).
//
// What bounds it: per observation it reads the measurement (8 bytes), two
// int32 indices (8), the point (12, shared by the ~9 observations of a point,
// which arrive sorted by point), ex_old (8 with the gain) and writes ex (8):
// 36-44 bytes against about 90 flops, far under the card's float32 ridge of
// 20 flops a byte, so device memory binds.
//
// Design:
// - camera work once per camera: each block first builds the camera records
//   K | q0 | v | t | s (s = sqrt(1 - |v|^2) by camera_s, the same bits as the
//   per-observation expression) for all C cameras in shared memory, 20 floats
//   apart so that a quarter-warp's 16-byte loads of eight cameras spread over
//   all 32 banks; the observation loop then reads a record as four 16-byte
//   shared loads instead of 15 divergent global gathers. Above the cameras a
//   block's shared memory holds, each observation gathers its camera from
//   global memory and computes s itself (the same arithmetic);
// - a persistent grid of the resident blocks (two of 512 threads per SM),
//   sized so that each walks the same number of units of kBatch x kThreads
//   observations; a thread issues all of a unit's loads (kBatch
//   observations, neighbouring threads on neighbouring observations) before
//   any arithmetic, and the first unit's loads are in flight while the
//   block builds its camera table;
// - no atomics on floats: each block sums (l2, gain) in a fixed order and
//   writes one partial; the last block to take an integer ticket sums the
//   partials in block order, writes (l2, gain) and resets the ticket. One
//   launch, and two calls give the same bits.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

// two blocks of 512 threads per SM (at most 64 registers a thread): the
// table of Final-961's cameras takes 77 KB of a block's shared memory
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kBatch = 2;               // observations a thread loads at once
constexpr int kUnit = kThreads * kBatch;
constexpr int kWarps = kThreads / 32;
constexpr int kRecStride = 20;          // floats per camera record in SMEM

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

// Camera record of camera c: K (5), q0 (4), v (3), t (3), then s.
__device__ __forceinline__ void camera_record(const float* __restrict__ kq,
                                              const float* __restrict__ cams,
                                              int c, bool clamp, float r[16]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = kq[9 * c + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) r[9 + i] = cams[6 * c + i];
  r[kCamRec] = camera_s(r, clamp);
}

// One unit's loads for this thread's kBatch observations.
struct Batch {
  int c[kBatch];
  float2 ob[kBatch], eo[kBatch];
  float x[kBatch][3], m[kBatch];
};

__device__ __forceinline__ void load_batch(
    int u, const float* __restrict__ pts, const float2* __restrict__ obs,
    const int* __restrict__ cam_idx, const int* __restrict__ pt_idx,
    const float* __restrict__ valid, const float2* __restrict__ ex_old, int O,
    Batch& b) {
  int p[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int o = u * kUnit + k * kThreads + threadIdx.x;
    const bool live = o < O;
    b.c[k] = live ? cam_idx[o] : 0;
    p[k] = live ? pt_idx[o] : 0;
    b.ob[k] = live ? obs[o] : make_float2(0.0f, 0.0f);
    b.eo[k] = live && ex_old != nullptr ? ex_old[o] : make_float2(0.0f, 0.0f);
    b.m[k] = !live ? 0.0f : valid != nullptr ? valid[o] : 1.0f;
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) b.x[k][i] = pts[3 * p[k] + i];
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    residual_l2_kernel(const float* __restrict__ kq,
                       const float* __restrict__ cams,
                       const float* __restrict__ pts,
                       const float* __restrict__ obs,
                       const int* __restrict__ cam_idx,
                       const int* __restrict__ pt_idx,
                       const float* __restrict__ valid,
                       const float* __restrict__ ex_old, int C, int O,
                       int clamp, int n_units, float* __restrict__ ex,
                       float* __restrict__ part, unsigned* __restrict__ ticket,
                       float* __restrict__ out) {
  extern __shared__ float4 table[];     // [C][kRecStride / 4] when kTable
  __shared__ float red[kWarps][2];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const float2* obs2 = reinterpret_cast<const float2*>(obs);
  const float2* eo2 = reinterpret_cast<const float2*>(ex_old);
  float2* ex2 = reinterpret_cast<float2*>(ex);

  // the grid never exceeds n_units: every block has a first unit
  int u = blockIdx.x;
  Batch b;
  load_batch(u, pts, obs2, cam_idx, pt_idx, valid, eo2, O, b);
  if (kTable) {
    for (int c = tid; c < C; c += kThreads) {
      float r[16];
      camera_record(kq, cams, c, clamp != 0, r);
      float4* dst = table + c * (kRecStride / 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                             r[4 * q + 3]);
    }
    __syncthreads();
  }

  float l2 = 0.0f, gain = 0.0f;
  while (true) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int o = u * kUnit + k * kThreads + tid;
      if (o < O) {
        float cam[16];
        if (kTable) {
          const float4* src = table + b.c[k] * (kRecStride / 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = src[q];
            cam[4 * q] = v.x;
            cam[4 * q + 1] = v.y;
            cam[4 * q + 2] = v.z;
            cam[4 * q + 3] = v.w;
          }
        } else {
          camera_record(kq, cams, b.c[k], clamp != 0, cam);
        }
        float exu, exv;
        cell_residual_s(cam, cam[kCamRec], b.x[k][0], b.x[k][1], b.x[k][2],
                        b.ob[k].x, b.ob[k].y, 1.0f, exu, exv);
        ex2[o] = make_float2(exu, exv);
        l2 += (exu * exu + exv * exv) * b.m[k];
        if (ex_old != nullptr) {
          const float eu = b.eo[k].x, ev = b.eo[k].y;
          gain += ((eu - exu) * (eu + exu) + (ev - exv) * (ev + exv)) *
                  b.m[k];
        }
      }
    }
    u += gridDim.x;
    if (u >= n_units) break;
    load_batch(u, pts, obs2, cam_idx, pt_idx, valid, eo2, O, b);
  }

  block_sum2(l2, gain, red);
  if (tid == 0) {
    part[2 * blockIdx.x + 0] = l2;
    part[2 * blockIdx.x + 1] = gain;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written and visible (the writers'
  // fences precede their tickets)
  __threadfence();
  float sl = 0.0f, sg = 0.0f;
  for (int i = tid; i < gridDim.x; i += kThreads) {
    sl += __ldcg(part + 2 * i + 0);
    sg += __ldcg(part + 2 * i + 1);
  }
  block_sum2(sl, sg, red);
  if (tid == 0) {
    out[0] = sl;
    out[1] = sg;
    *ticket = 0u;
  }
}

size_t table_bytes(int C) { return (size_t)C * kRecStride * sizeof(float); }

}  // namespace

// Cameras whose records fit one block's shared memory (the kernel builds its
// table up to this C, and gathers from global memory above it); raises the
// kernel's dynamic shared memory limit to match. -1 on an error.
extern "C" int psba_residual_l2_table_cameras() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, residual_l2_kernel<true>) != cudaSuccess)
    return -1;
  const int avail = optin - (int)attr.sharedSizeBytes;
  if (avail < (int)table_bytes(1) ||
      cudaFuncSetAttribute(residual_l2_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           avail) != cudaSuccess)
    return -1;
  return avail / (int)table_bytes(1);
}

// Blocks the current device holds resident at once: the largest grid
// psba_residual_l2 launches for C cameras (table = C <=
// psba_residual_l2_table_cameras()). 0 on an error.
extern "C" int psba_residual_l2_resident_blocks(int C, int table) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const cudaError_t e =
      table ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, residual_l2_kernel<true>, kThreads, table_bytes(C))
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, residual_l2_kernel<false>, kThreads, 0);
  return e == cudaSuccess ? sms * per_sm : 0;
}

// kq [C, 9] (K | q0), cams [C, 6], pts [P, 3], obs [O, 2], cam_idx / pt_idx
// [O] int32, valid [O] or null, ex_old [O, 2] or null; table and max_blocks
// as the two functions above give them for C; ws: int32 [1 + 2 *
// max_blocks], zero in its first entry (the ticket, which the kernel leaves
// at zero), block partials after it. Outputs: ex [O, 2], out [2] = (l2,
// gain), gain 0 without ex_old. Returns cudaGetLastError().
extern "C" int psba_residual_l2(const float* kq, const float* cams,
                                const float* pts, const float* obs,
                                const int* cam_idx, const int* pt_idx,
                                const float* valid, const float* ex_old, int C,
                                int O, int clamp, int table, int max_blocks,
                                int* ws, float* ex, float* out, void* stream) {
  if (C < 1 || O < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const int n_units = (O + kUnit - 1) / kUnit;
  // as many blocks as fit at once, each walking the same number of units
  const int per_block = (n_units + max_blocks - 1) / max_blocks;
  const int grid = (n_units + per_block - 1) / per_block;
  const cudaStream_t s = (cudaStream_t)stream;
  float* part = reinterpret_cast<float*>(ws + 1);
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  if (table)
    residual_l2_kernel<true><<<grid, kThreads, table_bytes(C), s>>>(
        kq, cams, pts, obs, cam_idx, pt_idx, valid, ex_old, C, O, clamp,
        n_units, ex, part, ticket, out);
  else
    residual_l2_kernel<false><<<grid, kThreads, 0, s>>>(
        kq, cams, pts, obs, cam_idx, pt_idx, valid, ex_old, C, O, clamp,
        n_units, ex, part, ticket, out);
  return (int)cudaGetLastError();
}
