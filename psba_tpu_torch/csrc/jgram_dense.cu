// Gram matrix of Jacobian products on the dense grid, on Hopper.
//
// Replaces: psba_tpu/ops/residual_dense.py::jgram_dense_pallas (kernel
// _jgram_kernel).
//
// For n direction vectors x_a = (dirs_c[a] [C, 6] camera parts, dirs_p[a]
// [3, Pd] planar point parts, Pd >= P) it computes the upper triangle of
// G[a, b] = <J x_a, J x_b>, J the coefficient-free Jacobian at (cams, pts):
// every observed (camera, point) cell evaluates A and B once (cell_model.cuh),
// forms (J x_a)_r = sum_i A[r][i] dc[a][i] + sum_k B[r][k] dp[a][k] for its
// two residual rows, and adds the products of those per-row terms. It stays
// a sum of products of per-row terms: the block form x^T [[U, W], [W^T, V]] x
// cancels in float32 when |J x| is small. Unseen cells (valid = 0) have A and
// B exactly 0, and point lanes p >= P are not visited, so neither contributes.
//
// What bounds it: it reads 4 bytes of the validity table per cell against
// about 300 flops of cell model and Jacobian per observed cell and 34 n +
// 4 n(n+1)/2 more, so it is bound by operations (float32, outside the tensor
// cores). Same grid as gain_dense.cu (128 points x kCamChunk cameras per
// block); each block reduces its n(n+1)/2 sums with warp shuffles and a fixed
// order over its warps, and writes one partial row [n_blocks, npair], summed
// outside. No atomics.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCamChunk = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    jgram_dense_kernel(const float* __restrict__ kq,
                       const float* __restrict__ cams,
                       const float* __restrict__ pts,
                       const float* __restrict__ valid,
                       const float* __restrict__ dirs_c,
                       const float* __restrict__ dirs_p, int C, int P, int Pd,
                       int clamp, float* __restrict__ part) {
  constexpr int kPairs = N * (N + 1) / 2;
  __shared__ float cam_s[kCamChunk][kCamRec];
  __shared__ float dc_s[kCamChunk][N * 6];
  __shared__ float red[kWarps][kPairs];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x * kThreads + tid;
  const int c0 = blockIdx.y * kCamChunk;
  const int nc = min(kCamChunk, C - c0);
  for (int i = tid; i < nc * kCamRec; i += kThreads) {
    const int g = i / kCamRec, k = i % kCamRec;
    const int c = c0 + g;
    cam_s[g][k] = k < 9 ? kq[c * 9 + k] : cams[c * 6 + (k - 9)];
  }
  // dirs_c [N, C, 6] -> dc_s[g][a * 6 + i]
  for (int i = tid; i < nc * N * 6; i += kThreads) {
    const int g = i / (N * 6), r = i % (N * 6);
    const int a = r / 6, k = r % 6;
    dc_s[g][r] = dirs_c[((size_t)a * C + c0 + g) * 6 + k];
  }
  __syncthreads();

  const bool in = p < P;
  const float x1 = in ? pts[3 * p + 0] : 0.0f;
  const float x2 = in ? pts[3 * p + 1] : 0.0f;
  const float x3 = in ? pts[3 * p + 2] : 0.0f;
  float dp[N][3];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dp[a][k] = in ? dirs_p[((size_t)a * 3 + k) * Pd + p] : 0.0f;

  float acc[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) acc[q] = 0.0f;
  for (int g = 0; g < nc; ++g) {
    const float vmask = in ? valid[(size_t)(c0 + g) * P + p] : 0.0f;
    float A[2][6], B[2][3], exu, exv;
    cell_linearize(cam_s[g], x1, x2, x3, 0.0f, 0.0f, vmask, clamp != 0, A, B,
                   exu, exv);
    float jx[N][2];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float s = A[r][0] * dc_s[g][a * 6 + 0];
#pragma unroll
        for (int i = 1; i < 6; ++i) s += A[r][i] * dc_s[g][a * 6 + i];
#pragma unroll
        for (int k = 0; k < 3; ++k) s += B[r][k] * dp[a][k];
        jx[a][r] = s;
      }
    int q = 0;
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = a; b < N; ++b)
        acc[q++] += jx[a][0] * jx[b][0] + jx[a][1] * jx[b][1];
  }
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float t = warp_sum(acc[q]);
    if (lane == 0) red[warp][q] = t;
  }
  __syncthreads();
  if (tid < kPairs) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kPairs + tid] = s;
  }
}

template <int N>
int launch(dim3 grid, cudaStream_t stream, const float* kq, const float* cams,
           const float* pts, const float* valid, const float* dirs_c,
           const float* dirs_p, int C, int P, int Pd, int clamp, float* part) {
  jgram_dense_kernel<N><<<grid, kThreads, 0, stream>>>(
      kq, cams, pts, valid, dirs_c, dirs_p, C, P, Pd, clamp, part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psba_jgram_dense_ptile() { return kThreads; }
extern "C" int psba_jgram_dense_cam_chunk() { return kCamChunk; }
extern "C" int psba_jgram_dense_max_n() { return kMaxN; }

// kq [C, 9], cams [C, 6], pts [P, 3], valid [C, P], dirs_c [n, C, 6], dirs_p
// [n, 3, Pd] with Pd >= P; part [ceil(C/kCamChunk) * ceil(P/kThreads),
// n(n+1)/2], upper triangle row-major. Returns cudaGetLastError().
extern "C" int psba_jgram_dense(const float* kq, const float* cams,
                                const float* pts, const float* valid,
                                const float* dirs_c, const float* dirs_p,
                                int n, int C, int P, int Pd, int clamp,
                                float* part, void* stream) {
  if (C < 1 || P < 1 || Pd < P) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads,
                  (C + kCamChunk - 1) / kCamChunk);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1:
      return launch<1>(grid, s, kq, cams, pts, valid, dirs_c, dirs_p, C, P,
                       Pd, clamp, part);
    case 2:
      return launch<2>(grid, s, kq, cams, pts, valid, dirs_c, dirs_p, C, P,
                       Pd, clamp, part);
    case 3:
      return launch<3>(grid, s, kq, cams, pts, valid, dirs_c, dirs_p, C, P,
                       Pd, clamp, part);
    case 4:
      return launch<4>(grid, s, kq, cams, pts, valid, dirs_c, dirs_p, C, P,
                       Pd, clamp, part);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
