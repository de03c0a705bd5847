// Gram matrix of Jacobian products on the dense grid, on Hopper.
//
// Replaces: psba_tpu/ops/residual_dense.py::jgram_dense_pallas (kernel
// _jgram_kernel).
//
// For n <= 4 direction vectors x_a (camera parts dc_a [C, 6] = (omega_a,
// tau_a), the rotation and translation parts; point parts dp_a, entry (k, p)
// at dp_a[k * sk_a + p * sp_a]: planar [3, Pd] rows, [P, 3] rows, or either
// one's transpose) it
// computes G[a, b] = <J x_a, J x_b>, J the coefficient-free Jacobian at
// (cams, pts), summed over the observed (camera, point) cells. It stays a
// sum of products of per-row terms: the block form x^T [[U, W], [W^T, V]] x
// cancels in float32 when |J x| is small.
//
// Per cell the Jacobian rows are never formed. With p_c = R X + t the point
// in the camera frame (R the composed rotation), M = dp_c/dv its derivative
// along the local rotation, and du, dv the two rows of dproj/dp_c, J x_a =
// (du . y_a, dv . y_a) with the camera-frame vector
//   y_a = M omega_a + tau_a + R dp_a.
// The mask multiplies 1/p3 once per cell. Unseen cells (valid = 0) have the
// mask 0, point lanes p >= P are not visited, and a warp whose 32 cells are
// all unseen skips the cell (exact: each would add 0). With an occupancy
// table (tile_mask [C, n_tiles] int32, bit (c, t) = 1 iff camera c observes
// a point of tile t) a block passes over the tiles whose kCamChunk bits are
// all 0 before it loads anything of them, and a camera whose bit is 0 loads
// no validity entry and skips its cells. A block reads the bits of its next
// kBatch tiles into shared memory (the first batch beside its camera
// records) and then walks them. Every warp it skips the unmasked kernel
// skips too, so the sums keep their order and their bits.
//
// What bounds it: it reads 4 bytes of the validity table per cell against
// 93 + 44 n + 2 n (n + 1) float32 operations per observed cell (an FMA
// counted as two; chip_smoke.py counts them), so it is bound by operations,
// outside the tensor cores. Beside the cells' arithmetic it pays a fixed
// cost that an empty grid shows (chip_smoke.py times one): the table's
// reads, each block's camera records and the sum across blocks. Design:
// - camera-only work once per block: R, R(q0), s, 1/s, 2s, 2v, fu * ar and
//   the direction parts of its kCamChunk cameras go to shared memory before
//   the cell loop (the first unit's table loads already in flight);
// - a persistent grid of the resident blocks (kMinBlocks per SM); block b
//   keeps camera chunk b % n_chunks and walks an equal share of its
//   128-point tiles, each thread one point with all kCamChunk validity
//   loads issued first;
// - no atomics on floats: each block sums its n(n+1)/2 products in a fixed
//   order and writes one partial row; the last block to take an integer
//   ticket sums the rows in block order, writes the symmetric G [n, n] with
//   both triangles and resets the ticket. One launch; two calls give the
//   same bits.
#include <cuda_runtime.h>

#include "cell_model.cuh"

namespace {

constexpr int kThreads = 128;   // points per tile, one per thread
// seven blocks per SM (at most 73 registers a thread, none spilled at n = 4)
constexpr int kMinBlocks = 7;
constexpr int kCamChunk = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 4;
// tiles whose live bits a block reads at once (at the dense cap, 32M
// cells, a block walks some 36 tiles on the H100)
constexpr int kBatch = 64;
static_assert(kBatch <= kThreads, "one tile's bits a thread");
constexpr int kMaxPairs = kMaxN * (kMaxN + 1) / 2;

// camera record in shared memory, then omega_a | tau_a per direction
enum {
  kFu = 0, kSk, kFuAr, kS2, kInvS,
  kV = 5,        // v (3)
  kV2 = 8,       // 2 v (3)
  kT = 11,       // t (3)
  kR0 = 14,      // R(q0), row-major (9)
  kR = 23,       // composed R(q_local(v) (x) q0), row-major (9)
  kCamFields = 32,
};

struct Dirs {
  const float* c[kMaxN];   // [C, 6] each
  const float* p[kMaxN];   // entry (k, p) at p[a][k * sk[a] + p * sp[a]]
  int sk[kMaxN], sp[kMaxN];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The rotation matrix of quaternion (w, x, y, z), the polynomial the
// quaternion sandwich of cell_model.cuh evaluates.
__device__ __forceinline__ void quat_matrix(float w, float x, float y, float z,
                                            float* R) {
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - z * w);
  R[2] = 2.0f * (x * z + y * w);
  R[3] = 2.0f * (x * y + z * w);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - x * w);
  R[6] = 2.0f * (x * z - y * w);
  R[7] = 2.0f * (y * z + x * w);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

template <int N>
__device__ __forceinline__ void camera_record(const float* __restrict__ kq,
                                              const float* __restrict__ cams,
                                              const Dirs& dirs, int c,
                                              bool clamp, float* r) {
  float cam[kCamRec];
#pragma unroll
  for (int i = 0; i < 9; ++i) cam[i] = kq[9 * c + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) cam[9 + i] = cams[6 * c + i];
  float dc[N][6];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 6; ++i) dc[j][i] = dirs.c[j][6 * c + i];
  const float fu = cam[0], ar = cam[3], sk = cam[4];
  const float a = cam[5], b = cam[6], cc = cam[7], d = cam[8];
  const float v1 = cam[9], v2 = cam[10], v3 = cam[11];
  const float s = camera_s(cam, clamp);
  r[kFu] = fu;
  r[kSk] = sk;
  r[kFuAr] = fu * ar;
  r[kS2] = 2.0f * s;
  // finite for every real camera (|v| < 1)
  r[kInvS] = 1.0f / s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[kV + i] = cam[9 + i];
    r[kV2 + i] = 2.0f * cam[9 + i];
    r[kT + i] = cam[12 + i];
  }
  quat_matrix(a, b, cc, d, r + kR0);
  // q = q_local(v) (x) q0, as cell_linearize composes it
  quat_matrix(s * a - (v1 * b + v2 * cc + v3 * d),
              s * b + a * v1 + (v2 * d - v3 * cc),
              s * cc + a * v2 + (v3 * b - v1 * d),
              s * d + a * v3 + (v1 * cc - v2 * b), r + kR);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 6; ++i) r[kCamFields + 6 * j + i] = dc[j][i];
}

// One tile's loads for this thread's point p.
template <int N>
struct Tile {
  float vm[kCamChunk], x[3], dp[N][3];
};

// Bit g: camera c0 + g (g < nc) observes a point of tile t; all nc bits
// without a table.
__device__ __forceinline__ unsigned live_cams(const int* __restrict__ mask,
                                              int t, int c0, int nc,
                                              int n_tiles) {
  unsigned live = 0u;
#pragma unroll
  for (int g = 0; g < kCamChunk; ++g)
    if (g < nc &&
        (mask == nullptr || mask[(size_t)(c0 + g) * n_tiles + t] != 0))
      live |= 1u << g;
  return live;
}

template <int N>
__device__ __forceinline__ void load_tile(int t, int c0, unsigned live, int P,
                                          const float* __restrict__ pts,
                                          const float* __restrict__ valid,
                                          const Dirs& dirs, Tile<N>& tl) {
  const int p = t * kThreads + threadIdx.x;
  const bool in = p < P;
#pragma unroll
  for (int g = 0; g < kCamChunk; ++g)
    tl.vm[g] = in && (live >> g & 1u) ? valid[(size_t)(c0 + g) * P + p]
                                      : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) tl.x[k] = in ? pts[3 * p + k] : 0.0f;
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tl.dp[a][k] = in ? dirs.p[a][(size_t)k * dirs.sk[a] +
                                   (size_t)p * dirs.sp[a]]
                       : 0.0f;
}

// Adds one cell's products to acc[kPairs] (upper triangle, row-major).
template <int N>
__device__ __forceinline__ void cell_gram(const float* r, const Tile<N>& tl,
                                          float vm, float* acc) {
  const float x1 = tl.x[0], x2 = tl.x[1], x3 = tl.x[2];
  const float* R0 = r + kR0;
  const float* R = r + kR;
  const float v1 = r[kV], v2 = r[kV + 1], v3 = r[kV + 2];
  // X0 = R(q0) X, w = v x X0, p_c = R X + t
  const float X01 = R0[0] * x1 + R0[1] * x2 + R0[2] * x3;
  const float X02 = R0[3] * x1 + R0[4] * x2 + R0[5] * x3;
  const float X03 = R0[6] * x1 + R0[7] * x2 + R0[8] * x3;
  const float w1 = v2 * X03 - v3 * X02;
  const float w2 = v3 * X01 - v1 * X03;
  const float w3 = v1 * X02 - v2 * X01;
  const float p1 = R[0] * x1 + R[1] * x2 + R[2] * x3 + r[kT];
  const float p2 = R[3] * x1 + R[4] * x2 + R[5] * x3 + r[kT + 1];
  float p3 = R[6] * x1 + R[7] * x2 + R[8] * x3 + r[kT + 2];
  // the guard precedes the division
  p3 = vm > 0.0f ? p3 : 1.0f;
  const float iz = 1.0f / p3;
  // dp_c/dv (cell_linearize's M)
  const float inv_s = r[kInvS], s2_ = r[kS2];
  const float g1 = -2.0f * (inv_s * w1 + X01);
  const float g2 = -2.0f * (inv_s * w2 + X02);
  const float g3 = -2.0f * (inv_s * w3 + X03);
  const float cdot = r[kV2] * X01 + r[kV2 + 1] * X02 + r[kV2 + 2] * X03;
  const float M[3][3] = {
      {g1 * v1 + cdot, g1 * v2 + s2_ * X03 + 2.0f * w3,
       g1 * v3 - s2_ * X02 - 2.0f * w2},
      {g2 * v1 - s2_ * X03 - 2.0f * w3, g2 * v2 + cdot,
       g2 * v3 + s2_ * X01 + 2.0f * w1},
      {g3 * v1 + s2_ * X02 + 2.0f * w2, g3 * v2 - s2_ * X01 - 2.0f * w1,
       g3 * v3 + cdot},
  };
  // du . y = fu iz (y1 - p1 iz y3) + sk iz (y2 - p2 iz y3),
  // dv . y = fu ar iz (y2 - p2 iz y3); the mask rides on iz
  const float izm = iz * vm;
  const float a1 = p1 * iz, a2 = p2 * iz;
  const float fz = r[kFu] * izm, sz = r[kSk] * izm, rz = r[kFuAr] * izm;
  float jx[N][2];
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const float* om = r + kCamFields + 6 * a;
    const float* ta = om + 3;
    const float* dp = tl.dp[a];
    float y[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      y[m] = ta[m] + M[m][0] * om[0] + M[m][1] * om[1] + M[m][2] * om[2] +
             R[3 * m] * dp[0] + R[3 * m + 1] * dp[1] + R[3 * m + 2] * dp[2];
    const float t1 = y[0] - a1 * y[2];
    const float t2 = y[1] - a2 * y[2];
    jx[a][0] = fz * t1 + sz * t2;
    jx[a][1] = rz * t2;
  }
  int q = 0;
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = a; b < N; ++b)
      acc[q++] += jx[a][0] * jx[b][0] + jx[a][1] * jx[b][1];
}

// Sums v[kPairs] over the block in a fixed order; thread q < kPairs gets
// the sum of entry q. `red` must not be read by any thread when entered.
template <int kPairs>
__device__ __forceinline__ float block_sum(const float* v,
                                           float (*red)[kMaxPairs]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float t = warp_sum(v[q]);
    if (lane == 0) red[warp][q] = t;
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < kPairs) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
  }
  return s;
}

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    jgram_dense_kernel(const float* __restrict__ kq,
                       const float* __restrict__ cams,
                       const float* __restrict__ pts,
                       const float* __restrict__ valid,
                       const int* __restrict__ tile_mask, Dirs dirs, int C,
                       int P, int clamp, int n_chunks, int per_chunk,
                       int n_tiles, float* __restrict__ part,
                       unsigned* __restrict__ ticket, float* __restrict__ G) {
  constexpr int kPairs = N * (N + 1) / 2;
  constexpr int kRec = kCamFields + 6 * N;
  __shared__ float rec[kCamChunk][kRec];
  __shared__ float red[kWarps][kMaxPairs];
  __shared__ unsigned live_s[kBatch];  // bits of the batch's tiles
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % n_chunks;
  const int c0 = chunk * kCamChunk;
  const int nc = min(kCamChunk, C - c0);
  // read after the first batch's barrier
  if (tid < nc) camera_record<N>(kq, cams, dirs, c0 + tid, clamp != 0,
                                 rec[tid]);

  float acc[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) acc[q] = 0.0f;
  for (int t = blockIdx.x / n_chunks, i = 0; t < n_tiles;
       t += per_chunk, ++i) {
    if (i % kBatch == 0) {  // the bits of this tile and the next ones
      __syncthreads();      // (the last batch's bits are read)
      const int ti = t + tid * per_chunk;
      if (tid < kBatch && ti < n_tiles)
        live_s[tid] = live_cams(tile_mask, ti, c0, nc, n_tiles);
      __syncthreads();
    }
    // a tile without a live camera is passed over before any load; live is
    // uniform over the block, the vote over the warp
    const unsigned live = live_s[i % kBatch];
    if (live == 0u) continue;
    Tile<N> tl;
    load_tile<N>(t, c0, live, P, pts, valid, dirs, tl);
#pragma unroll
    for (int g = 0; g < kCamChunk; ++g) {
      if ((live >> g & 1u) && __any_sync(0xffffffffu, tl.vm[g] > 0.0f))
        cell_gram<N>(rec[g], tl, tl.vm[g], acc);
    }
  }

  float s = block_sum<kPairs>(acc, red);
  if (tid < kPairs) {
    part[(size_t)blockIdx.x * kPairs + tid] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every partial row is written and visible (each
  // writer's fence precedes the block's ticket)
  __threadfence();
#pragma unroll
  for (int q = 0; q < kPairs; ++q) acc[q] = 0.0f;
  for (int i = tid; i < gridDim.x; i += kThreads)
#pragma unroll
    for (int q = 0; q < kPairs; ++q)
      acc[q] += __ldcg(part + (size_t)i * kPairs + q);
  s = block_sum<kPairs>(acc, red);
  if (tid < kPairs) {
    int a = 0, q = tid;
    while (q >= N - a) q -= N - a++;
    const int b = a + q;
    G[a * N + b] = s;
    G[b * N + a] = s;
  }
  if (tid == 0) *ticket = 0u;
}

template <int N>
int resident(int sms) {
  int per_sm = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, jgram_dense_kernel<N>, kThreads, 0) == cudaSuccess
             ? sms * per_sm
             : 0;
}

template <int N>
int launch(int grid, cudaStream_t stream, const float* kq, const float* cams,
           const float* pts, const float* valid, const int* tile_mask,
           const Dirs& dirs, int C, int P, int clamp, int n_chunks,
           int per_chunk, int n_tiles, int* ws, float* G) {
  jgram_dense_kernel<N><<<grid, kThreads, 0, stream>>>(
      kq, cams, pts, valid, tile_mask, dirs, C, P, clamp, n_chunks, per_chunk,
      n_tiles, reinterpret_cast<float*>(ws + 1),
      reinterpret_cast<unsigned*>(ws), G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psba_jgram_dense_cam_chunk() { return kCamChunk; }
extern "C" int psba_jgram_dense_max_n() { return kMaxN; }

// Blocks of the n-direction kernel the current device holds resident at
// once. 0 on an error.
extern "C" int psba_jgram_dense_resident_blocks(int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  switch (n) {
    case 1: return resident<1>(sms);
    case 2: return resident<2>(sms);
    case 3: return resident<3>(sms);
    case 4: return resident<4>(sms);
    default: return 0;
  }
}

// kq [C, 9], cams [C, 6], pts [P, 3], valid [C, P]; tile_mask
// [C, ceil(P / kThreads)] int32 or null (every tile visited); direction
// a < n <= 4:
// camera part dc[a] [C, 6], point part dp[a] with entry (k, p) at
// dp[a][k * sk[a] + p * sp[a]] (planar [3, Pd]: sk = Pd, sp = 1; row-major
// [P, 3]: sk = 1, sp = 3; any strides of a view);
// max_blocks = psba_jgram_dense_resident_blocks(n);
// ws: int32 [ws_len] >= 1 + max(max_blocks, ceil(C / kCamChunk)) * n(n+1)/2,
// zero in its first entry (the ticket, which the kernel leaves at zero),
// partial rows after it. Output G [n, n], symmetric. Returns
// cudaGetLastError().
extern "C" int psba_jgram_dense(const float* kq, const float* cams,
                                const float* pts, const float* valid,
                                const int* tile_mask, const float* dc0,
                                const float* dc1,
                                const float* dc2, const float* dc3,
                                const float* dp0, const float* dp1,
                                const float* dp2, const float* dp3, int sk0,
                                int sk1, int sk2, int sk3, int sp0, int sp1,
                                int sp2, int sp3, int n, int C, int P,
                                int clamp,
                                int max_blocks, int* ws, int ws_len, float* G,
                                void* stream) {
  if (C < 1 || P < 1 || n < 1 || n > kMaxN || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Dirs dirs = {{dc0, dc1, dc2, dc3},
                     {dp0, dp1, dp2, dp3},
                     {sk0, sk1, sk2, sk3},
                     {sp0, sp1, sp2, sp3}};
  const int n_chunks = (C + kCamChunk - 1) / kCamChunk;
  const int n_tiles = (P + kThreads - 1) / kThreads;
  // each camera chunk gets the same number of blocks, as many as fit at
  // once (at least one), each walking the same number of its tiles
  int per_chunk = max(1, min(max_blocks / n_chunks, n_tiles));
  const int tiles_each = (n_tiles + per_chunk - 1) / per_chunk;
  per_chunk = (n_tiles + tiles_each - 1) / tiles_each;
  const int grid = n_chunks * per_chunk;
  if (1 + (long long)grid * (n * (n + 1) / 2) > ws_len)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1:
      return launch<1>(grid, s, kq, cams, pts, valid, tile_mask, dirs, C,
                       P, clamp, n_chunks, per_chunk, n_tiles, ws, G);
    case 2:
      return launch<2>(grid, s, kq, cams, pts, valid, tile_mask, dirs, C,
                       P, clamp, n_chunks, per_chunk, n_tiles, ws, G);
    case 3:
      return launch<3>(grid, s, kq, cams, pts, valid, tile_mask, dirs, C,
                       P, clamp, n_chunks, per_chunk, n_tiles, ws, G);
    default:
      return launch<4>(grid, s, kq, cams, pts, valid, tile_mask, dirs, C,
                       P, clamp, n_chunks, per_chunk, n_tiles, ws, G);
  }
}
