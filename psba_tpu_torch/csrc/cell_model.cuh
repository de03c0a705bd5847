// Forward model and analytic Jacobian of one (camera, point) cell, shared by
// the port's kernels (the dense grid and the observation stream).
//
// Same arithmetic as _cell_model in psba_tpu/ops/linearize_dense.py (and
// _cell_residual in psba_tpu/ops/residual_dense.py): the point X is rotated
// by the fixed q0, then by the local rotation (s, v), translated and
// projected with K = [fu, u0, v0, ar, sk]. A is the 2x6 camera Jacobian
// (rotation columns, then translation), B the 2x3 point Jacobian, both of
// the prediction. Cells without an observation (vmask = 0) have their depth
// replaced by 1 before 1/p3, so masked garbage never becomes inf * 0 = nan.
#pragma once

// Camera record in shared memory: K (5), q0 (4), v (3), t (3).
constexpr int kCamRec = 15;

struct CellForward {
  float s, X01, X02, X03, w1, w2, w3, p1, p2, p3, iz;
};

// s = sqrt(1 - |v|^2), the scalar part of the local rotation: it depends on
// the camera alone, so a kernel may compute it once per camera record.
__device__ __forceinline__ float camera_s(const float* cam, bool clamp) {
  const float v1 = cam[9], v2 = cam[10], v3 = cam[11];
  float s2 = 1.0f - v1 * v1 - v2 * v2 - v3 * v3;
  if (clamp) s2 = fmaxf(s2, 0.0f);
  return sqrtf(s2);
}

// cell_forward with the camera's s = camera_s(cam, clamp) given.
__device__ __forceinline__ CellForward cell_forward_s(const float* cam,
                                                      float s, float x1,
                                                      float x2, float x3,
                                                      float vmask) {
  const float a = cam[5], b = cam[6], cc = cam[7], d = cam[8];
  const float v1 = cam[9], v2 = cam[10], v3 = cam[11];
  const float t1 = cam[12], t2 = cam[13], t3 = cam[14];
  CellForward f;
  f.s = s;
  // X0 = R(q0) X
  const float t01 = 2.0f * (cc * x3 - d * x2);
  const float t02 = 2.0f * (d * x1 - b * x3);
  const float t03 = 2.0f * (b * x2 - cc * x1);
  f.X01 = x1 + a * t01 + (cc * t03 - d * t02);
  f.X02 = x2 + a * t02 + (d * t01 - b * t03);
  f.X03 = x3 + a * t03 + (b * t02 - cc * t01);
  f.w1 = v2 * f.X03 - v3 * f.X02;
  f.w2 = v3 * f.X01 - v1 * f.X03;
  f.w3 = v1 * f.X02 - v2 * f.X01;
  f.p1 = f.X01 + 2.0f * (f.s * f.w1 + v2 * f.w3 - v3 * f.w2) + t1;
  f.p2 = f.X02 + 2.0f * (f.s * f.w2 + v3 * f.w1 - v1 * f.w3) + t2;
  float p3 = f.X03 + 2.0f * (f.s * f.w3 + v1 * f.w2 - v2 * f.w1) + t3;
  // the guard precedes the division
  f.p3 = vmask > 0.0f ? p3 : 1.0f;
  f.iz = 1.0f / f.p3;
  return f;
}

__device__ __forceinline__ CellForward cell_forward(const float* cam, float x1,
                                                    float x2, float x3,
                                                    float vmask, bool clamp) {
  return cell_forward_s(cam, camera_s(cam, clamp), x1, x2, x3, vmask);
}

// Masked residual obs - prediction of one cell, the camera's s given.
__device__ __forceinline__ void cell_residual_s(const float* cam, float s,
                                                float x1, float x2, float x3,
                                                float obsu, float obsv,
                                                float vmask, float& exu,
                                                float& exv) {
  const float fu = cam[0], u0 = cam[1], v0 = cam[2], ar = cam[3], sk = cam[4];
  const CellForward f = cell_forward_s(cam, s, x1, x2, x3, vmask);
  const float pu = (fu * f.p1 + sk * f.p2 + u0 * f.p3) * f.iz;
  const float pv = (fu * ar * f.p2 + v0 * f.p3) * f.iz;
  exu = (obsu - pu) * vmask;
  exv = (obsv - pv) * vmask;
}

// Masked residual obs - prediction of one cell.
__device__ __forceinline__ void cell_residual(const float* cam, float x1,
                                              float x2, float x3, float obsu,
                                              float obsv, float vmask,
                                              bool clamp, float& exu,
                                              float& exv) {
  cell_residual_s(cam, camera_s(cam, clamp), x1, x2, x3, obsu, obsv, vmask,
                  exu, exv);
}

// Residual plus the masked Jacobian rows A[r][0..5], B[r][0..2], r = u, v.
__device__ __forceinline__ void cell_linearize(const float* cam, float x1,
                                               float x2, float x3, float obsu,
                                               float obsv, float vmask,
                                               bool clamp, float A[2][6],
                                               float B[2][3], float& exu,
                                               float& exv) {
  const float fu = cam[0], u0 = cam[1], v0 = cam[2], ar = cam[3], sk = cam[4];
  const float a = cam[5], b = cam[6], cc = cam[7], d = cam[8];
  const float v1 = cam[9], v2 = cam[10], v3 = cam[11];
  const CellForward f = cell_forward(cam, x1, x2, x3, vmask, clamp);
  const float iz = f.iz;
  const float pu = (fu * f.p1 + sk * f.p2 + u0 * f.p3) * iz;
  const float pv = (fu * ar * f.p2 + v0 * f.p3) * iz;
  exu = (obsu - pu) * vmask;
  exv = (obsv - pv) * vmask;

  // dproj/dp_c rows
  const float du[3] = {fu * iz, sk * iz, -(fu * f.p1 + sk * f.p2) * iz * iz};
  const float dv[3] = {0.0f, fu * ar * iz, -(fu * ar * f.p2) * iz * iz};

  // dp_c/dv; inv_s = 1/s is finite for every real camera (|v| < 1), and
  // padded cameras do not exist on this card (the grid stops at C)
  const float inv_s = 1.0f / f.s;
  const float g1 = -2.0f * (inv_s * f.w1 + f.X01);
  const float g2 = -2.0f * (inv_s * f.w2 + f.X02);
  const float g3 = -2.0f * (inv_s * f.w3 + f.X03);
  const float cdot = 2.0f * (v1 * f.X01 + v2 * f.X02 + v3 * f.X03);
  const float s2_ = 2.0f * f.s;
  const float M[3][3] = {
      {g1 * v1 + cdot, g1 * v2 + s2_ * f.X03 + 2.0f * f.w3,
       g1 * v3 - s2_ * f.X02 - 2.0f * f.w2},
      {g2 * v1 - s2_ * f.X03 - 2.0f * f.w3, g2 * v2 + cdot,
       g2 * v3 + s2_ * f.X01 + 2.0f * f.w1},
      {g3 * v1 + s2_ * f.X02 + 2.0f * f.w2, g3 * v2 - s2_ * f.X01 - 2.0f * f.w1,
       g3 * v3 + cdot},
  };

  // composed rotation R(q), q = q_local(v) (x) q0
  const float qw = f.s * a - (v1 * b + v2 * cc + v3 * d);
  const float qx = f.s * b + a * v1 + (v2 * d - v3 * cc);
  const float qy = f.s * cc + a * v2 + (v3 * b - v1 * d);
  const float qz = f.s * d + a * v3 + (v1 * cc - v2 * b);
  const float R[3][3] = {
      {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qz * qw),
       2.0f * (qx * qz + qy * qw)},
      {2.0f * (qx * qy + qz * qw), 1.0f - 2.0f * (qx * qx + qz * qz),
       2.0f * (qy * qz - qx * qw)},
      {2.0f * (qx * qz - qy * qw), 2.0f * (qy * qz + qx * qw),
       1.0f - 2.0f * (qx * qx + qy * qy)},
  };

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* pr = r == 0 ? du : dv;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      A[r][k] = (pr[0] * M[0][k] + pr[1] * M[1][k] + pr[2] * M[2][k]) * vmask;
      A[r][3 + k] = pr[k] * vmask;
      B[r][k] = (pr[0] * R[0][k] + pr[1] * R[1][k] + pr[2] * R[2][k]) * vmask;
    }
  }
}
