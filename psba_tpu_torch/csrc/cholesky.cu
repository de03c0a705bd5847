// Cholesky factor and solve of the reduced camera system S x = b on Hopper,
// in one launch of one thread-block cluster.
//
// Replaces: psba_tpu/ops/cholesky_pallas.py::spd_solve_pallas (kernel
// _chol_kernel).
//
// What bounds it: n = 6C is small (126 at 21 cameras, 828 at 138, at most
// 1024), so the work (n^3/3 = 1.9e8 flop at n = 828) is microseconds of the
// card's float32 rate. What sets the time is the chain of n / 32 dependent
// panels: in each, the one-warp factor of the 32 x 32 diagonal block (32
// dependent pivots, each a shuffle, an rsqrt and a shuffle), the solve of
// the rows below it, two cluster barriers, and the L2 latency of the loads
// on that chain. A single block spent most of its time in the trailing
// update, limited by one SM's shared-memory reads; here that update is
// spread over the CTAs of a cluster and the panel chain is what is left.
//
// Design:
// - S is padded with the identity to N = 32 * ceil(n / 32), as the reference
//   pads it, so every panel is 32 columns wide and nothing is masked. The
//   working copy lives in device memory (4 MB at N = 1024, held in L2),
//   panel-major: panel j is N rows of 32 floats, so the rows of a panel that
//   a step needs are one contiguous span. Factored diagonal blocks go to a
//   side array D, so no CTA overwrites a block another CTA is reading.
// - Step k: every CTA stages the factored panel k (rows 32 k..N-1) in its
//   shared memory with cp.async, all 16-byte copies in flight at once. CTA
//   0 applies it to the diagonal block of panel k + 1 and at once factors
//   that block with one warp (lane r holds row r and its own diagonal
//   entry, so a pivot waits on one shuffle, an rsqrt and a Newton step),
//   while a second warp carries the forward solve of block k; the other
//   CTAs meanwhile apply panel k to the rest of the trailing matrix, dealt
//   to them in equal runs of 128-row units. In a unit a thread owns 4
//   columns and keeps their 32 panel values in registers, takes 4 rows
//   with their loads in flight together, and reads each staged row as
//   float4 (the lanes of a quarter-warp share columns, so those loads
//   broadcast, and read rows 36 floats apart, so no bank conflicts). A
//   cluster barrier; every CTA takes L11 from CTA 0 and solves its share of
//   the rows below it, L21 L11^T = A21, a row a thread in registers. A
//   second cluster barrier ends the step. So the chain of a step is the
//   staging, one 32-row update, the 32 pivots, one row solve and two
//   barriers.
// - Cross-CTA data goes through device memory (L2), read with ld.cg or
//   cp.async.cg after the cluster barrier's release / acquire.
// - After the factor, CTA 0 runs the backward solve panel by panel (each
//   panel staged with cp.async, a column sum over the rows below the
//   diagonal block, one warp for the block) and writes x and ok itself: x_i
//   is zeroed where ok is false or x_i is not finite, and ok is cleared by
//   any pivot that is <= 0 or not finite, as in the reference. One launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;       // panel width = warp width
constexpr int kLd = kNB + 4;  // staged row stride: float4 rows, no conflicts
constexpr int kMaxN = 1024;
constexpr int kThreads = 256;
constexpr int kChunk = 128;  // rows of a panel in one unit of the update
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float* panel(float* W, int N, int j) {
  return W + (size_t)j * N * kNB;
}

// Issue the copies of rows of 32 floats from device memory into shared
// rows of kLd, 16 bytes each, all in flight at once (all threads).
__device__ void stage_issue(float* dst, const float* src, int rows) {
  for (int q = threadIdx.x; q < rows * 8; q += blockDim.x) {
    const unsigned sa = (unsigned)__cvta_generic_to_shared(
        dst + (q >> 3) * kLd + 4 * (q & 7));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa),
                 "l"(src + 4 * q)
                 : "memory");
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// Stage panel j from row 32 j on: its factored diagonal block from D, the
// rows below it from W.
__device__ void stage_panel(float* P, float* W, const float* D, int N, int j) {
  stage_issue(P, D + (size_t)j * kNB * kNB, kNB);
  stage_issue(P + kNB * kLd, panel(W, N, j) + (size_t)kNB * (j + 1) * kNB,
              N - kNB * (j + 1));
  stage_wait();
}

// Copy rows r0..r1-1 of panel j of S (n x n, padded to N with the
// identity) into W; eight loads in flight per thread.
__device__ void copy_rows(const float* __restrict__ S, int n, int N,
                          float* __restrict__ W, int j, int r0, int r1) {
  const int c0 = kNB * j, total = (r1 - r0) * kNB, nt = blockDim.x;
  float* Wj = panel(W, N, j) + (size_t)r0 * kNB;
  for (int i0 = threadIdx.x; i0 < total; i0 += 8 * nt) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * nt;
      const int i = r0 + idx / kNB, c = c0 + idx % kNB;
      v[u] = idx >= total             ? 0.0f
             : (i < n && c < n)       ? S[(size_t)i * n + c]
             : (i == c ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * nt;
      if (idx < total) Wj[idx] = v[u];
    }
  }
}

// One warp: factor the 32 x 32 diagonal block of panel j in registers
// (lane rr holds row rr; column k of the other rows comes by shuffle) into
// LT (transposed) and dl (1 / L_kk) for the CTA's own row solves; with
// `own`, also L11 to D (not over the block in W, which another CTA may
// still be reading) and 1 / L_kk to dinv, clearing status on a pivot that
// is <= 0 or not finite.
__device__ void factor_diag(const float* __restrict__ W, int N, int j,
                            bool own, float* __restrict__ D,
                            float* __restrict__ dinv, int* __restrict__ status,
                            float* __restrict__ LT, float* __restrict__ dl) {
  const unsigned full = 0xffffffffu;
  const int rr = threadIdx.x & 31, c0 = kNB * j;
  const float* Wr = W + (size_t)j * N * kNB + (size_t)(c0 + rr) * kNB;
  float* Dr = D + (size_t)j * kNB * kNB + rr * kNB;
  float row[kNB];
#pragma unroll
  for (int k = 0; k < kNB; ++k) row[k] = k <= rr ? __ldcg(Wr + k) : 0.0f;
  // this lane's diagonal entry, updated by its own values alone, so the
  // next pivot waits on one shuffle, not on a shuffle of the column too
  float dg = __ldcg(Wr + rr);
  float myd = 0.0f, myinv = 0.0f;  // this lane's pivot and its 1 / L_rr
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    const float d = __shfl_sync(full, dg, k);
    float inv = rsqrtf(d);
    inv = inv * (1.5f - 0.5f * d * inv * inv);
    if (rr == k) {
      myd = d;
      myinv = inv;
    }
    if (rr >= k) row[k] *= inv;
    if (rr > k) dg -= row[k] * row[k];
#pragma unroll
    for (int c = k + 1; c < kNB; ++c) {
      const float v = __shfl_sync(full, row[k], c);
      if (rr >= c) row[c] -= row[k] * v;
    }
  }
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    if (own) Dr[k] = row[k];
    LT[k * kNB + rr] = row[k];
  }
  dl[rr] = myinv;
  if (own) {
    dinv[c0 + rr] = myinv;
    if (__any_sync(full, !(myd > 0.0f) || !isfinite(myd)) && rr == 0)
      *status = 0;
  }
  __syncwarp();
}

// Threads t = 0..nthr-1: rows r0..r1-1 (below the diagonal block) of panel
// j solve L21 L11^T = A21, a row per thread and two rows at a time (their
// loads in flight together), right-looking in registers, reading columns
// of L11 as float4 broadcasts from LT.
__device__ void solve_rows(float* __restrict__ W, int N, int j, int r0,
                           int r1, const float* __restrict__ LT,
                           const float* __restrict__ dl, int t, int nthr) {
  float* Wj = panel(W, N, j);
  for (int i = r0 + t; i < r1; i += 2 * nthr) {
    const bool two = i + nthr < r1;
    float4* W1 = reinterpret_cast<float4*>(Wj + (size_t)i * kNB);
    float4* W2 =
        reinterpret_cast<float4*>(Wj + (size_t)(two ? i + nthr : i) * kNB);
    float a[2][kNB];
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      const float4 v = __ldcg(W1 + q), w = __ldcg(W2 + q);
      a[0][4 * q + 0] = v.x;
      a[0][4 * q + 1] = v.y;
      a[0][4 * q + 2] = v.z;
      a[0][4 * q + 3] = v.w;
      a[1][4 * q + 0] = w.x;
      a[1][4 * q + 1] = w.y;
      a[1][4 * q + 2] = w.z;
      a[1][4 * q + 3] = w.w;
    }
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      a[0][k] *= dl[k];
      a[1][k] *= dl[k];
      const float4* Lk4 = reinterpret_cast<const float4*>(LT + k * kNB);
#pragma unroll
      for (int q = (k + 1) / 4; q < kNB / 4; ++q) {
        const float4 l = Lk4[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (4 * q + 0 > k) a[h][4 * q + 0] -= a[h][k] * l.x;
          if (4 * q + 1 > k) a[h][4 * q + 1] -= a[h][k] * l.y;
          if (4 * q + 2 > k) a[h][4 * q + 2] -= a[h][k] * l.z;
          if (4 * q + 3 > k) a[h][4 * q + 3] -= a[h][k] * l.w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      W1[q] = make_float4(a[0][4 * q], a[0][4 * q + 1], a[0][4 * q + 2],
                          a[0][4 * q + 3]);
      if (two)
        W2[q] = make_float4(a[1][4 * q], a[1][4 * q + 1], a[1][4 * q + 2],
                            a[1][4 * q + 3]);
    }
  }
}

// Threads t = 0..nthr-1 (nthr a multiple of 64): rows r0..r1-1 of panel j
// minus L[row][panel k] . L[panel j's rows][panel k], with panel k's rows
// from `base` on staged in P. Thread t owns columns 4 cg..4 cg + 3,
// cg = (t / 8) % 8, and rows r0 + rl + m nthr / 8, rl = t % 8 + 8 (t / 64),
// four at a time so their loads overlap: the 8 lanes of a quarter-warp
// share cg (their panel values load as one broadcast) and read 8 rows kLd
// apart (no bank conflict). A diagonal block is updated whole; its upper
// part is never read.
__device__ void update_rows(float* __restrict__ W, int N, int j, int r0,
                            int r1, const float* __restrict__ P, int base,
                            int t, int nthr) {
  const int cgp = (t >> 3) & 7, rl = (t & 7) + 8 * (t >> 6);
  const int nrl = nthr >> 3;
  float* Wj = panel(W, N, j) + 4 * cgp;
  float bq[4][kNB];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4* src =
        reinterpret_cast<const float4*>(P + (kNB * j + 4 * cgp + q - base) * kLd);
#pragma unroll
    for (int t4 = 0; t4 < kNB / 4; ++t4) {
      const float4 v = src[t4];
      bq[q][4 * t4] = v.x;
      bq[q][4 * t4 + 1] = v.y;
      bq[q][4 * t4 + 2] = v.z;
      bq[q][4 * t4 + 3] = v.w;
    }
  }
  for (int i0 = r0 + rl; i0 < r1; i0 += 4 * nrl) {
    float4 a[4];
    int ii[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ii[u] = min(i0 + nrl * u, r1 - 1);
      a[u] = __ldcg(reinterpret_cast<const float4*>(Wj + (size_t)ii[u] * kNB));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4* pr =
          reinterpret_cast<const float4*>(P + (ii[u] - base) * kLd);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t4 = 0; t4 < kNB / 4; ++t4) {
        const float4 v = pr[t4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[q] += v.x * bq[q][4 * t4] + v.y * bq[q][4 * t4 + 1] +
                  v.z * bq[q][4 * t4 + 2] + v.w * bq[q][4 * t4 + 3];
      }
      a[u].x -= s[0];
      a[u].y -= s[1];
      a[u].z -= s[2];
      a[u].w -= s[3];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + nrl * u < r1)
        *reinterpret_cast<float4*>(Wj + (size_t)ii[u] * kNB) = a[u];
  }
}

// This CTA's share of rows lo..N-1 when they are split over cs CTAs.
__device__ __forceinline__ int2 share(int lo, int N, int rank, int cs) {
  const int per = (N - lo + cs - 1) / cs;
  const int r0 = lo + rank * per;
  return make_int2(r0, min(N, r0 + per));
}

// Forward solve of block k (CTA 0; threads t = 0..nthr-1, which meet at
// `sync`): y_k = L_kk^-1 r_k from the staged panel k (rows 32 k.. at P),
// then r_i -= L_ik y_k below it.
template <typename Sync>
__device__ void forward_block(int N, int k, const float* __restrict__ P,
                              const float* __restrict__ dinv,
                              float* __restrict__ r, int t, int nthr,
                              Sync sync) {
  const unsigned full = 0xffffffffu;
  const int lane = t & 31, c0 = kNB * k;
  if (t < 32) {
    float Lrow[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) Lrow[c] = c < lane ? P[lane * kLd + c] : 0.0f;
    const float dk = __ldcg(dinv + c0 + lane);
    float rv = r[c0 + lane];
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      const float xc = __shfl_sync(full, rv, c) * __shfl_sync(full, dk, c);
      if (lane == c)
        rv = xc;
      else if (lane > c)
        rv -= Lrow[c] * xc;
    }
    r[c0 + lane] = rv;
  }
  sync();
  const float4* y4 = reinterpret_cast<const float4*>(r + c0);
  for (int i = c0 + kNB + t; i < N; i += nthr) {
    const float4* Li4 = reinterpret_cast<const float4*>(P + (i - c0) * kLd);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      const float4 l = Li4[q], y = y4[q];
      acc += l.x * y.x + l.y * y.y + l.z * y.z + l.w * y.w;
    }
    r[i] -= acc;
  }
}

// The update of the trailing matrix by staged panel k, less the diagonal
// block of panel k + 1 (CTA 0 updates and factors that block first), in
// units of kChunk rows: panel k + 1 from row 32 (k + 2), then each panel
// j > k + 1 from row 32 j, in that order. CTA 0 takes no unit when cs > 1;
// CTAs 1..cs-1 take equal contiguous runs (consecutive units mostly share a
// panel, so their panel values stay in registers). Threads t = 0..nthr-1
// of CTA `rank` apply the panel to that CTA's run.
__device__ void update_units(float* __restrict__ W, int N, int k,
                             const float* __restrict__ P, int base, int rank,
                             int cs, int t, int nthr) {
  const int np = N / kNB;
  auto first = [&](int j) { return kNB * (j == k + 1 ? k + 2 : j); };
  int units = 0;
  for (int j = k + 1; j < np; ++j)
    units += (N - first(j) + kChunk - 1) / kChunk;
  int u0 = 0, u1 = units;
  if (cs > 1) {
    if (rank == 0) return;
    const int per = (units + cs - 2) / (cs - 1);
    u0 = (rank - 1) * per;
    u1 = min(units, u0 + per);
  }
  int u = 0;
  for (int j = k + 1; j < np && u < u1; ++j) {
    const int m = (N - first(j) + kChunk - 1) / kChunk;
    const int lo = max(u0 - u, 0), hi = min(u1 - u, m);
    if (lo < hi)
      update_rows(W, N, j, first(j) + kChunk * lo,
                  min(N, first(j) + kChunk * hi), P, base, t, nthr);
    u += m;
  }
}

__global__ void __launch_bounds__(kThreads)
    spd_solve_kernel(const float* __restrict__ S, const float* __restrict__ b,
                     int n, int N, float* __restrict__ W,
                     float* __restrict__ D, float* __restrict__ dinv,
                     int* __restrict__ status,
                     float* __restrict__ x, unsigned char* __restrict__ ok_out) {
  extern __shared__ float4 sh4[];
  float* P = reinterpret_cast<float*>(sh4);  // [N][kLd] staged panel rows
  float* LT = P + (size_t)N * kLd;           // [32][32] L11 transposed
  float* r = LT + kNB * kNB;                 // [N] rhs, then solution
  float* dl = r + N;                         // [32] 1 / L_kk of a panel
  float* red = dl + kNB;                     // [32][33] column sums
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = N / kNB;
  auto all_sync = [] { __syncthreads(); };
  auto warp_sync = [] { __syncwarp(); };

  {  // copy S in: the rows of all panels, in order, split evenly
    const int2 sh = share(0, np * N - kNB * np * (np - 1) / 2, rank, cs);
    for (int j = 0, u = 0; j < np; u += N - kNB * j, ++j) {
      const int lo = max(sh.x - u, 0), hi = min(sh.y - u, N - kNB * j);
      if (lo < hi) copy_rows(S, n, N, W, j, kNB * j + lo, kNB * j + hi);
    }
  }
  if (rank == 0) {
    if (tid == 0) *status = 1;
    for (int i = tid; i < N; i += kThreads) r[i] = i < n ? b[i] : 0.0f;
  }
  cluster.sync();
  if (rank == 0 && warp == 0)
    factor_diag(W, N, 0, true, D, dinv, status, LT, dl);
  cluster.sync();
  if (rank != 0) {
    for (int i = tid; i < kNB * kNB; i += kThreads)
      LT[(i & 31) * kNB + (i >> 5)] = __ldcg(D + i);
    if (tid < kNB) dl[tid] = __ldcg(dinv + tid);
  }
  __syncthreads();
  {
    const int2 sh = share(kNB, N, rank, cs);
    solve_rows(W, N, 0, sh.x, sh.y, LT, dl, tid, kThreads);
  }
  cluster.sync();

  for (int k = 0; k + 1 < np; ++k) {
    const int base = kNB * k;
    stage_panel(P, W, D, N, k);
    if (rank == 0) {
      // the next diagonal block first; then warp 0 factors it while warp 1
      // carries the forward solve and warps 2-7 take the units (cs = 1)
      update_rows(W, N, k + 1, kNB * (k + 1), kNB * (k + 2), P, base, tid,
                  kThreads);
      __syncthreads();
      if (warp == 0) {
        factor_diag(W, N, k + 1, true, D, dinv, status, LT, dl);
      } else if (warp == 1) {
        forward_block(N, k, P, dinv, r, lane, 32, warp_sync);
      } else {
        update_units(W, N, k, P, base, rank, cs, tid - 64, kThreads - 64);
      }
    } else {
      update_units(W, N, k, P, base, rank, cs, tid, kThreads);
    }
    cluster.sync();
    if (rank != 0) {  // L11 of the next panel from CTA 0
      const int c0 = kNB * (k + 1);
      for (int i = tid; i < kNB * kNB; i += kThreads)
        LT[(i & 31) * kNB + (i >> 5)] = __ldcg(D + (size_t)c0 * kNB + i);
      if (tid < kNB) dl[tid] = __ldcg(dinv + c0 + tid);
      __syncthreads();
    }
    const int2 sh = share(kNB * (k + 2), N, rank, cs);
    solve_rows(W, N, k + 1, sh.x, sh.y, LT, dl, tid, kThreads);
    cluster.sync();
  }
  if (rank != 0) return;

  // ---- CTA 0: the last forward block, then the backward solve
  const unsigned full = 0xffffffffu;
  stage_panel(P, W, D, N, np - 1);
  forward_block(N, np - 1, P, dinv, r, tid, kThreads, all_sync);
  __syncthreads();
  for (int j = np - 1; j >= 0; --j) {
    const int c0 = kNB * j;
    stage_panel(P, W, D, N, j);
    // red[rl][c] = sum over rows i = c0 + 32 + rl + 32 m of L[i][c] x_i
    {
      const int cgp = tid & 7, rl = tid >> 3;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = c0 + kNB + rl; i < N; i += kThreads / 8) {
        const float4 l = reinterpret_cast<const float4*>(P + (i - c0) * kLd)[cgp];
        const float xi = r[i];
        s[0] += l.x * xi;
        s[1] += l.y * xi;
        s[2] += l.z * xi;
        s[3] += l.w * xi;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) red[rl * (kNB + 1) + 4 * cgp + q] = s[q];
    }
    __syncthreads();
    if (tid < 32) {
      float t = 0.0f;
      for (int q = 0; q < kThreads / 8; ++q) t += red[q * (kNB + 1) + lane];
      float Lcol[kNB];
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        Lcol[c] = c > lane ? P[c * kLd + lane] : 0.0f;
      const float dk = __ldcg(dinv + c0 + lane);
      float rv = r[c0 + lane] - t;
#pragma unroll
      for (int c = kNB - 1; c >= 0; --c) {
        const float xc = __shfl_sync(full, rv, c) * __shfl_sync(full, dk, c);
        if (lane == c)
          rv = xc;
        else if (lane < c)
          rv -= Lcol[c] * xc;
      }
      r[c0 + lane] = rv;
    }
    __syncthreads();
  }
  const bool ok = __ldcg(status) != 0;
  for (int i = tid; i < n; i += kThreads)
    x[i] = ok && isfinite(r[i]) ? r[i] : 0.0f;
  if (tid == 0) *ok_out = ok ? 1 : 0;
}

size_t smem_bytes(int N) {
  return ((size_t)N * kLd + kNB * kNB + (size_t)N + kNB + kNB * (kNB + 1)) *
         sizeof(float);
}

cudaError_t launch(const float* S, const float* b, int n, int cluster,
                   float* work, int* status, float* x, unsigned char* ok,
                   cudaStream_t stream) {
  const int N = (n + kNB - 1) / kNB * kNB;
  static bool ready = false;  // attributes set for the largest shape once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxN));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(spd_solve_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(N);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, spd_solve_kernel, S, b, n, N, work,
                         work + (size_t)N * N, work + (size_t)N * (N + kNB),
                         status, x, ok);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" int psba_spd_solve_max_n() { return kMaxN; }

// The largest cluster (CTAs) the device can schedule for this kernel at
// N = kMaxN, at most kMaxCluster; 0 on error.
extern "C" int psba_spd_solve_max_cluster() {
  const size_t smem = smem_bytes(kMaxN);
  if (cudaFuncSetAttribute(spd_solve_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncSetAttribute(spd_solve_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  for (int cs = kMaxCluster; cs >= 1; cs /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, spd_solve_kernel,
                                       &cfg) == cudaSuccess &&
        clusters > 0)
      return cs;
  }
  cudaGetLastError();
  return 0;
}

// S [n, n] row-major SPD, b [n]; work [N * N + 33 N] scratch with N = 32
// ceil(n / 32); status [1] int32 scratch; x [n]; ok [1] uint8 (1 when every
// pivot was > 0 and finite). cluster: CTAs of the one cluster launched,
// 1 <= cluster <= psba_spd_solve_max_cluster(). Returns cudaGetLastError()
// (or the error of the attribute opt-in).
extern "C" int psba_spd_solve(const float* S, const float* b, int n,
                              int cluster, float* work, int* status, float* x,
                              unsigned char* ok, void* stream) {
  if (n < 1 || n > kMaxN || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return (int)launch(S, b, n, cluster, work, status, x, ok,
                     (cudaStream_t)stream);
}
