// Per-ray pieces of the cluster closest-hit / any-hit kernels: the
// CUDA C++ translation of arendur_tpu/shapes/pallas_intersect.py
// (_slab_hit, _accept) over the mxu_intersect.py determinant products.
// __host__ __device__ so a CPU build can exercise the same code.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define IHD __host__ __device__ __forceinline__
#else
#define IHD inline
#endif

namespace isect {

constexpr float G3 = (float)(3.0 * 0x1p-24 / (1.0 - 3.0 * 0x1p-24));
constexpr float SLAB_WIDEN = (float)(1.0 + 2.0 * (3.0 * 0x1p-24 /
                                                  (1.0 - 3.0 * 0x1p-24)));

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

// ray segment may meet the box within (0, bound); box = cbox row
// (min xyz, max xyz, pad), conservative (1 + 2 gamma3) widening
IHD bool slab_hit(const Ray& r, const float* box, float bound) {
  float tn = -INFINITY, tf = INFINITY;
  for (int ax = 0; ax < 3; ++ax) {
    float oa = r.F[ax];
    float da = r.F[3 + ax];
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

// Epsilon accept from the four determinants (pallas_intersect._accept).
IHD bool accept(float det, float tdet, float udet, float vdet, float teps,
                float bound, float* t_out) {
  float s = det >= 0.0f ? 1.0f : -1.0f;
  float a = det * s;
  bool ok = a > 1e-12f;
  float us = udet * s;
  float vs = vdet * s;
  float ta = a * 1e-6f;
  bool okb = (us >= -ta) && (vs >= -ta) && (us + vs <= a + ta);
  float inv = 1.0f / (ok ? a : 1.0f);
  float t = (tdet * s) * inv;
  *t_out = t;
  return ok && okb && (t > teps) && (t < bound);
}

// 16-term dot of the ray features with one weight column; wq points at
// feature 0 of the column, consecutive features `fstride` floats apart
IHD float dot16(const Ray& r, const float* wq, int fstride) {
  float acc = 0.0f;
  for (int f = 0; f < 16; ++f) acc = fmaf(r.F[f], wq[f * fstride], acc);
  return acc;
}

}  // namespace isect
