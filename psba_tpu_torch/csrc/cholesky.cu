// Cholesky factor and solve of the reduced camera system S x = b on Hopper,
// in one launch.
//
// Replaces: psba_tpu/ops/cholesky_pallas.py::spd_solve_pallas (kernel
// _chol_kernel).
//
// What bounds it: n = 6C is small (126 at 21 cameras, 828 at 138), so at
// small n the chain of dependent column steps sets the time (the reference
// kernel is latency-bound for the same reason); at n = 828 a clock64
// breakdown puts 57% of the cycles in the trailing update and 16% in the row
// solves, both limited by shared-memory reads on the one SM the block runs
// on. Design:
// - one block of up to 512 threads, so every step synchronises with
//   __syncthreads() and nothing returns to the host;
// - the working copy of S lives in device memory (4 MB at n = 1024, held in
//   the 50 MB L2) and is factored by panels of kNB = 32 columns held in
//   shared memory: one warp factors the 32 x 32 diagonal block in registers
//   (shuffles, no barrier), every thread below it solves its row against
//   that block in registers, then one rank-32 update of the trailing lower
//   triangle follows. In that update a lane owns two columns and keeps
//   their 32 panel values in registers; a warp walks a chunk of rows four
//   at a time, so four L2 round trips overlap, and reads each row's panel
//   values as float4 broadcasts shared by its 64 columns;
// - the forward and backward solves go by the same 32-column blocks: one
//   warp solves the 32 x 32 diagonal block in registers with shuffles, then
//   all threads update the remaining right-hand side, two barriers a block.
// ok is cleared by any pivot that is <= 0 or not finite, as in the
// reference; the caller zeroes x when ok is 0.
// The trailing update (about n^3/6 FMAs) on one SM is what caps this
// version at large n; spreading it over the SMs is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int kNB = 32;       // panel width = warp width
constexpr int kLd = kNB + 4;  // padded panel row, 16-byte aligned for float4
constexpr int kRows = 64;     // rows per unit of the trailing update
constexpr int kMaxN = 1024;
constexpr int kThreads = 512; // 128 registers a thread: the row and
                              // panel arrays stay out of local memory

__global__ void __launch_bounds__(kThreads)
    spd_solve_kernel(const float* __restrict__ S, const float* __restrict__ b,
                     int n, float* __restrict__ A, float* __restrict__ x,
                     int* __restrict__ ok_out) {
  extern __shared__ float4 sh4[];
  float* P = reinterpret_cast<float*>(sh4);  // [n][kLd] panel rows j0..n-1
  float* LT = P + (size_t)n * kLd;  // [kNB][kLd] diagonal block, transposed
  float* r = LT + kNB * kLd;        // [n] right-hand side, then solution
  float* dinv = r + n;              // [n] 1 / L_jj
  __shared__ int ok_s;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const unsigned full = 0xffffffffu;

  if (tid == 0) ok_s = 1;
  for (int i = tid; i < n * n; i += nt) A[i] = S[i];
  for (int i = tid; i < n; i += nt) r[i] = b[i];
  __syncthreads();

  // ---- factor: L in the lower triangle of A (diagonal included)
  for (int j0 = 0; j0 < n; j0 += kNB) {
    const int w = min(kNB, n - j0);
    const int m = n - j0;
#pragma unroll 8
    for (int i = tid; i < m * w; i += nt) {
      const int rr = i / w, k = i % w;
      P[rr * kLd + k] = A[(size_t)(j0 + rr) * n + j0 + k];
    }
    __syncthreads();
    // diagonal block, one warp, in registers: lane rr holds row rr, column
    // k of the other rows comes by shuffle; right-looking, each column
    // scaled as it is eliminated. 1/sqrt(d) is rsqrt plus one Newton step.
    // The block is also stored transposed (LT) for the row solves below.
    if (warp == 0) {
      const int rr = lane;
      float row[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        row[k] = (rr < w && k <= rr) ? P[rr * kLd + k] : 0.0f;
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        if (k < w) {
          const float d = __shfl_sync(full, row[k], k);
          float inv = rsqrtf(d);
          inv = inv * (1.5f - 0.5f * d * inv * inv);
          if (lane == 0) {
            if (!(d > 0.0f) || !isfinite(d)) ok_s = 0;
            dinv[j0 + k] = inv;
          }
          if (rr >= k) row[k] *= inv;
#pragma unroll
          for (int c = k + 1; c < kNB; ++c) {
            const float v = __shfl_sync(full, row[k], c);
            if (rr >= c) row[c] -= row[k] * v;
          }
        }
      }
      if (rr < w) {
#pragma unroll
        for (int k = 0; k < kNB; ++k) {
          if (k <= rr) {
            P[rr * kLd + k] = row[k];
            LT[k * kLd + rr] = row[k];
            A[(size_t)(j0 + rr) * n + j0 + k] = row[k];
          }
        }
      }
    }
    __syncthreads();
    // rows below the diagonal block (only when the panel is full): a thread
    // per row solves L21 L11^T = A21 in registers, right-looking, reading
    // columns of L11 as float4 broadcasts from LT
    for (int rr = w + tid; rr < m; rr += nt) {
      float4* Pr4 = reinterpret_cast<float4*>(P + rr * kLd);
      float a[kNB];
#pragma unroll
      for (int q = 0; q < kNB / 4; ++q) {
        const float4 v = Pr4[q];
        a[4 * q + 0] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        a[k] *= dinv[j0 + k];
        const float4* Lk4 = reinterpret_cast<const float4*>(LT + k * kLd);
#pragma unroll
        for (int q = (k + 1) / 4; q < kNB / 4; ++q) {
          const float4 l = Lk4[q];
          if (4 * q + 0 > k) a[4 * q + 0] -= a[k] * l.x;
          if (4 * q + 1 > k) a[4 * q + 1] -= a[k] * l.y;
          if (4 * q + 2 > k) a[4 * q + 2] -= a[k] * l.z;
          if (4 * q + 3 > k) a[4 * q + 3] -= a[k] * l.w;
        }
      }
      float* Ar = A + (size_t)(j0 + rr) * n + j0;
#pragma unroll
      for (int q = 0; q < kNB / 4; ++q)
        Pr4[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
#pragma unroll
      for (int k = 0; k < kNB; ++k) Ar[k] = a[k];
    }
    __syncthreads();
    // trailing update of the lower triangle: A[i][c] -= L[i, panel] .
    // L[c, panel]. Only a full panel (w == kNB) has a trailing part. Units
    // of work are (64-column block cb, chunk of kRows rows from the block's
    // first column down), dealt to the warps in turn; a lane owns columns
    // c and c + 32 of its block.
    const int t0 = j0 + w;
    const int m2 = n - t0;
    const int ncb = (m2 + 63) / 64;
    int n_units = 0;
    for (int cb = 0; cb < ncb; ++cb) n_units += (m2 - 64 * cb + kRows - 1) / kRows;
    for (int u = warp; u < n_units; u += nwarps) {
      int cb = 0, left = u;
      for (;; ++cb) {
        const int units_cb = (m2 - 64 * cb + kRows - 1) / kRows;
        if (left < units_cb) break;
        left -= units_cb;
      }
      const int ca = t0 + 64 * cb + lane, cz = ca + 32;
      float pa[kNB], pz[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        pa[k] = ca < n ? P[(ca - j0) * kLd + k] : 0.0f;
        pz[k] = cz < n ? P[(cz - j0) * kLd + k] : 0.0f;
      }
      const int r0 = t0 + 64 * cb + left * kRows;
      const int r1 = min(n, r0 + kRows);
      // four rows at a time, their loads issued together: the update waits
      // on L2 latency, not on arithmetic
      for (int i = r0; i < r1; i += 4) {
        float va[4], vz[4], aa[4], az[4];
        const float4* Pi4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ii = min(i + q, r1 - 1);
          const bool row = i + q < r1;
          va[q] = row && ca < n && ca <= i + q ? A[(size_t)ii * n + ca] : 0.0f;
          vz[q] = row && cz < n && cz <= i + q ? A[(size_t)ii * n + cz] : 0.0f;
          Pi4[q] = reinterpret_cast<const float4*>(P + (ii - j0) * kLd);
          aa[q] = 0.0f;
          az[q] = 0.0f;
        }
#pragma unroll
        for (int k4 = 0; k4 < kNB / 4; ++k4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = Pi4[q][k4];
            aa[q] += v.x * pa[4 * k4 + 0] + v.y * pa[4 * k4 + 1] +
                     v.z * pa[4 * k4 + 2] + v.w * pa[4 * k4 + 3];
            az[q] += v.x * pz[4 * k4 + 0] + v.y * pz[4 * k4 + 1] +
                     v.z * pz[4 * k4 + 2] + v.w * pz[4 * k4 + 3];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i + q < r1 && ca < n && ca <= i + q)
            A[(size_t)(i + q) * n + ca] = va[q] - aa[q];
          if (i + q < r1 && cz < n && cz <= i + q)
            A[(size_t)(i + q) * n + cz] = vz[q] - az[q];
        }
      }
    }
    __syncthreads();
  }

  // ---- forward solve L y = b
  for (int j0 = 0; j0 < n; j0 += kNB) {
    const int w = min(kNB, n - j0);
    if (warp == 0) {
      const int row = j0 + lane;
      float Lrow[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        Lrow[k] = (lane < w && k < lane) ? A[(size_t)row * n + j0 + k] : 0.0f;
      float rv = lane < w ? r[row] : 0.0f;
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        const float xk =
            __shfl_sync(full, rv, k) * (k < w ? dinv[j0 + k] : 0.0f);
        if (lane == k)
          rv = xk;
        else if (lane > k)
          rv -= Lrow[k] * xk;
      }
      if (lane < w) r[row] = rv;
    }
    __syncthreads();
    for (int i = j0 + w + tid; i < n; i += nt) {
      const float* Li = A + (size_t)i * n + j0;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        if (k < w) acc += Li[k] * r[j0 + k];
      r[i] -= acc;
    }
    __syncthreads();
  }

  // ---- backward solve L^T x = y
  for (int j0 = ((n - 1) / kNB) * kNB; j0 >= 0; j0 -= kNB) {
    const int w = min(kNB, n - j0);
    if (warp == 0) {
      float Lcol[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        Lcol[k] = (lane < w && k > lane && k < w)
                      ? A[(size_t)(j0 + k) * n + j0 + lane]
                      : 0.0f;
      float rv = lane < w ? r[j0 + lane] : 0.0f;
#pragma unroll
      for (int k = kNB - 1; k >= 0; --k) {
        const float xk =
            __shfl_sync(full, rv, k) * (k < w ? dinv[j0 + k] : 0.0f);
        if (lane == k)
          rv = xk;
        else if (lane < k)
          rv -= Lcol[k] * xk;
      }
      if (lane < w) r[j0 + lane] = rv;
    }
    __syncthreads();
    for (int i = tid; i < j0; i += nt) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        if (k < w) acc += A[(size_t)(j0 + k) * n + i] * r[j0 + k];
      r[i] -= acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) x[i] = r[i];
  if (tid == 0) *ok_out = ok_s;
}

}  // namespace

extern "C" int psba_spd_solve_max_n() { return kMaxN; }

// S [n, n] row-major SPD, b [n]; work [n, n] scratch; x [n]; ok [1].
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int psba_spd_solve(const float* S, const float* b, int n,
                              float* work, float* x, int* ok, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)n * kLd + 2 * (size_t)n + kNB * kLd) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = min(kThreads, ((n + 31) / 32) * 32);
  spd_solve_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(S, b, n, work, x,
                                                               ok);
  return (int)cudaGetLastError();
}
