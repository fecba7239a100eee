// Per-thread pieces of the cluster closest-hit / any-hit kernels (K1 /
// K2, intersect.cu): the CUDA C++ translation of
// arendur_tpu/shapes/pallas_intersect.py (_slab_hit, _accept,
// _sphere_best) over the mxu_intersect.py determinant products.
// __host__ __device__, so that a host build (intersect_host.cpp) runs
// the same per-thread loop on the CPU.
#pragma once

#include <math.h>
#include <string.h>

#include "cbounce.cuh"

#ifdef __CUDACC__
#define IHD __host__ __device__ __forceinline__
#else
#define IHD inline
struct float4 {
  float x, y, z, w;
};
#endif

namespace isect {

constexpr float G3 = (float)(3.0 * 0x1p-24 / (1.0 - 3.0 * 0x1p-24));
constexpr float SLAB_WIDEN = (float)(1.0 + 2.0 * (3.0 * 0x1p-24 /
                                                  (1.0 - 3.0 * 0x1p-24)));
constexpr int CHUNK = 64;     // triangles per staged chunk
constexpr int GROUP = 4;      // triangles per float4
constexpr int SPH_COLS = 24;  // sphere.kernel_table row

struct Ray {
  float F[16];  // [o(3), d(3), vec(o (x) d)(9), 1]
  float teps;   // 1e-5 * (1 + max|o|)
};

IHD void ray_setup(const float* o, const float* d, Ray* r) {
  for (int a = 0; a < 3; ++a) {
    r->F[a] = o[a];
    r->F[3 + a] = d[a];
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) r->F[6 + 3 * a + b] = o[a] * d[b];
  r->F[15] = 1.0f;
  float m = fmaxf(fmaxf(fabsf(o[0]), fabsf(o[1])), fabsf(o[2]));
  r->teps = 1e-5f * (1.0f + m);
}

// ray segment o + t d may meet the box within (0, bound); box = min
// xyz, max xyz; conservative (1 + 2 gamma3) widening
IHD bool slab_hit(const float* o, const float* d, const float* box,
                  float bound) {
  float tn = -INFINITY, tf = INFINITY;
  for (int ax = 0; ax < 3; ++ax) {
    float oa = o[ax];
    float da = d[ax];
    float inv = fabsf(da) < 1e-30f ? (da < 0.0f ? -1e30f : 1e30f)
                                   : 1.0f / da;
    float t0 = (box[ax] - oa) * inv;
    float t1 = (box[3 + ax] - oa) * inv;
    float lo = fminf(t0, t1);
    float hi = fmaxf(t0, t1);
    tn = ax == 0 ? lo : fmaxf(tn, lo);
    tf = ax == 0 ? hi : fminf(tf, hi);
  }
  tf = tf * SLAB_WIDEN;
  return (tn <= tf) && (tf > 0.0f) && (tn < bound);
}

// the ray's test against a cbox row (min xyz, max xyz, pad)
IHD bool slab_hit(const Ray& r, const float* box, float bound) {
  return slab_hit(r.F, r.F + 3, box, bound);
}

// One row of an instanced mesh's instance table (scene.py
// instance_table): the rows 0-3 of w2o's x, y and z columns (12
// floats: the linear part, then the translation), the instance's padded
// world box (min xyz, max xyz), two zeros.
constexpr int ITAB_COLS = 20;
constexpr int ITAB_BOX = 12;

// one product / sum rounded once, never contracted into a multiply-add
IHD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

IHD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// A world ray (o, d) in an instance's frame, m its table row: x m[k] +
// y m[3 + k] + z m[6 + k], then + m[9 + k] for the origin, in
// scene.affine's order and rounding, so the local ray equals the plain
// version's to the bit.
IHD void to_instance(const float* m, const float* o, const float* d,
                     float* ol, float* dl) {
  for (int k = 0; k < 3; ++k) {
    ol[k] = add_rn(add_rn(add_rn(mul_rn(o[0], m[k]), mul_rn(o[1], m[3 + k])),
                          mul_rn(o[2], m[6 + k])),
                   m[9 + k]);
    dl[k] = add_rn(add_rn(mul_rn(d[0], m[k]), mul_rn(d[1], m[3 + k])),
                   mul_rn(d[2], m[6 + k]));
  }
}

// Epsilon accept from the four determinants (pallas_intersect._accept).
// The reciprocal and t are taken only for a pair that passes the sign
// and barycentric tests, which reject most pairs; where they are taken
// the arithmetic is _accept's, so t is the same to the bit.
IHD bool accept(float det, float tdet, float udet, float vdet, float teps,
                float bound, float* t_out) {
  float s = det >= 0.0f ? 1.0f : -1.0f;
  float a = det * s;
  float us = udet * s;
  float vs = vdet * s;
  float ta = a * 1e-6f;
  if (!(a > 1e-12f) || !((us >= -ta) && (vs >= -ta) && (us + vs <= a + ta)))
    return false;
  float t = (tdet * s) * (1.0f / a);
  *t_out = t;
  return (t > teps) && (t < bound);
}

IHD float4 ld4(const float* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const float4*>(p);
#else
  float4 v;
  memcpy(&v, p, sizeof(v));
  return v;
#endif
}

// The four determinants of GROUP consecutive triangles against R rays:
// dq[q][j][r] for quantity q (det, tdet, udet, vdet), triangle j, ray r.
// w points at feature 0, quantity 0 of the group's first triangle;
// quantity q of feature f lies at w + f * fstride + q * qstride, the
// four triangles' weights in one float4.  Each determinant is one fmaf
// chain over f = 0..15 from 0, so one 16-byte load feeds 4R FMAs.
template <int R>
IHD void dets4(const Ray (&ray)[R], const float* w, int fstride, int qstride,
               float (&dq)[4][GROUP][R]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) dq[q][j][r] = 0.0f;
  // feature f + 1's weights load while feature f's FMAs run
  float4 v[4], next[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = ld4(w + q * qstride);
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    if (f + 1 < 16)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        next[q] = ld4(w + (f + 1) * fstride + q * qstride);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = ray[r].F[f];
        dq[q][0][r] = fmaf(x, v[q].x, dq[q][0][r]);
        dq[q][1][r] = fmaf(x, v[q].y, dq[q][1][r]);
        dq[q][2][r] = fmaf(x, v[q].z, dq[q][2][r]);
        dq[q][3][r] = fmaf(x, v[q].w, dq[q][3][r]);
      }
    }
    if (f + 1 < 16)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = next[q];
  }
}

// The accept of one group for each ray that wants the cluster, its
// triangles in ascending slot order (slot0 the first's): the closest
// hit keeps a triangle only when strictly closer than its best (the
// lowest slot wins a tie, a sphere hit found first wins a tie with a
// triangle); the any hit marks the ray blocked.
template <bool ANY, int R>
IHD void accept4(const float (&dq)[4][GROUP][R], const Ray (&ray)[R],
                 const bool (&want)[R], const float (&tm)[R], int slot0,
                 float (&best)[R], int (&bslot)[R], bool (&blocked)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!want[r]) continue;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      float t;
      if (ANY) {
        if (accept(dq[0][j][r], dq[1][j][r], dq[2][j][r], dq[3][j][r],
                   ray[r].teps, tm[r], &t))
          blocked[r] = true;
      } else if (accept(dq[0][j][r], dq[1][j][r], dq[2][j][r], dq[3][j][r],
                        ray[r].teps, best[r], &t)) {
        best[r] = t;
        bslot[r] = slot0 + j;
      }
    }
  }
}

// The sphere branch for one live ray (_sphere_best): the ns rows of the
// sphere table sph, rows first, first + 1, ... of the scene's table, in
// ascending order; the world ray goes to each sphere's frame with
// row-layout products (the point multiplied by 1 / w, not divided), then
// the bounce shade's local test (cbounce_body.cuh intersect_local_sphere,
// the phi clip skipped where full_phi); a hit with t < best (strict: the
// lowest index wins a tie) sets best and the code -(2+s).
IHD void sphere_pass(const Ray& r, float tm, const float* sph, int ns,
                     bool full_phi, float* best, int* bslot, int first = 0) {
  cmath::V3 ow = cmath::v3(r.F[0], r.F[1], r.F[2]);
  cmath::V3 dw = cmath::v3(r.F[3], r.F[4], r.F[5]);
  for (int s = 0; s < ns; ++s) {
    const float* m = sph + SPH_COLS * s;
    cmath::V3 ol = cmath::tp16(m, ow);
    cmath::V3 dl = cmath::tv16(m, dw);
    cmath::V3 p;
    float t;
    bool hit = cbounce::intersect_local_sphere(ol, dl, tm, m[16], m[17],
                                               m[18], m[19], full_phi, &p,
                                               &t);
    if (hit && t < *best) {
      *best = t;
      *bslot = -(2 + first + s);
    }
  }
}

}  // namespace isect
