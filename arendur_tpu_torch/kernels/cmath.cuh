// Per-lane shading math for the bounce-shade kernels: the CUDA C++
// translation of arendur_tpu_torch/render/cmath.py (itself the port of
// arendur_tpu/render/cmath.py).  Each function follows the Python
// version's operation order; the library is compiled with -fmad=false
// so no multiply-add is contracted, and the lane results match the
// plain PyTorch version on the card to the last bit wherever the math
// library calls (sinf, expf, logf, powf, rsqrtf) agree.
//
// The functions a gradient flows through live in cmath_body.cuh, which
// is written over a scalar type F and a table-row type Row and is
// compiled twice: here on float (namespace cmath, the forward kernel)
// and in cmath_ad.cuh on the taped scalar of ad.cuh (namespace
// cmath_ad, the backward kernel).  The sampling routines below run on
// float only: the estimator detaches every sampled direction (DESIGN
// §5), so the backward calls them on values.
//
// Every function is __host__ __device__ so the same source can be
// exercised on a CPU build as well.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif
// the larger body functions (see cmath_body.cuh); the backward
// instantiation redefines it
#define HDB HD

#ifndef __CUDACC__
// host build: the device intrinsic as PyTorch's CPU rsqrt computes it
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif

namespace cdefs {

constexpr double PI_D = 3.14159265358979323846;
constexpr float PI = (float)PI_D;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float FMAX = 1e12f;
// render/cmath.py TR_COMPAT_NO_SQRT (the reference's missing sqrt in
// Trowbridge slope sampling is not reproduced)
constexpr bool TR_COMPAT_NO_SQRT = false;

// bxdf/types.py
constexpr int REFLECTION = 0x01;
constexpr int TRANSMISSION = 0x02;
constexpr int DIFFUSE = 0x04;
constexpr int GLOSSY = 0x08;
constexpr int SPECULAR = 0x10;
constexpr int ALL = REFLECTION | TRANSMISSION | DIFFUSE | GLOSSY | SPECULAR;
constexpr int ALL_NON_SPECULAR = ALL & ~SPECULAR;
constexpr int T_NONE = 0, T_LAMBERT_R = 1, T_LAMBERT_T = 2,
              T_OREN_NAYAR = 3, T_FRESNEL_SPEC = 4, T_TS_R = 5,
              T_TS_T = 6, T_ASHIKHMIN = 7, T_SPECULAR_R = 8,
              T_SPECULAR_T = 9;
constexpr int D_BECKMANN = 0, D_TROWBRIDGE = 1;

HD int kind_of_type(int t) {
  switch (t) {
    case T_LAMBERT_R: return REFLECTION | DIFFUSE;
    case T_LAMBERT_T: return TRANSMISSION | DIFFUSE;
    case T_OREN_NAYAR: return REFLECTION | DIFFUSE;
    case T_FRESNEL_SPEC: return REFLECTION | TRANSMISSION | SPECULAR;
    case T_TS_R: return REFLECTION | GLOSSY;
    case T_TS_T: return TRANSMISSION | GLOSSY;
    case T_ASHIKHMIN: return REFLECTION | GLOSSY;
    case T_SPECULAR_R: return REFLECTION | SPECULAR;
    case T_SPECULAR_T: return TRANSMISSION | SPECULAR;
    default: return 0;
  }
}

}  // namespace cdefs

namespace cmath {

using namespace cdefs;
typedef float F;
typedef const float* Row;

HD float val(float x) { return x; }
HD float rawf(Row r, int c) { return r[c]; }

// NaN-propagating min/max/clamp (torch.clamp / torch.maximum semantics)
HD bool isnan_(float x) { return x != x; }
HD float mx(float x, float c) { return isnan_(x) ? x : fmaxf(x, c); }
HD float mn(float x, float c) { return isnan_(x) ? x : fminf(x, c); }
HD float clampf_(float x, float lo, float hi) {
  return isnan_(x) ? x : fminf(fmaxf(x, lo), hi);
}
HD float mxx(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
HD float mnn(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
HD bool fin(float x) { return isfinite(x); }
HD float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

#include "cmath_body.cuh"


// ---------------------------------------------------------------------------
// float only: sampling (detached) and predicates
// ---------------------------------------------------------------------------

HD float atan2_poly(float y, float x) {
  float ax = fabsf(x);
  float ay = fabsf(y);
  float hi = mxx(ax, ay);
  float lo = mnn(ax, ay);
  float z = lo / (hi < 1e-30f ? 1e-30f : hi);
  float z2 = z * z;
  float p = 0.0208351f;
  p = -0.0851330f + p * z2;
  p = 0.1801410f + p * z2;
  p = -0.3302995f + p * z2;
  p = 0.9998660f + p * z2;
  float a = p * z;
  a = ay > ax ? (float)(0.5 * PI_D) - a : a;
  a = x < 0.0f ? PI - a : a;
  return y < 0.0f ? -a : a;
}

HD V3 refract(V3 wo, V3 n, float eta, bool* ok) {
  float ct = vdot(wo, n);
  float sin2 = mx(1.0f - ct * ct, 0.0f);
  float sin2_t = eta * eta * sin2;
  *ok = sin2_t < 1.0f;
  float cos_t = sqrtf(mx(1.0f - sin2_t, 1e-12f));
  V3 wt = vadd(vscale(wo, -eta), vscale(n, eta * ct - cos_t));
  return *ok ? wt : vzero();
}

// warps (sampling/warps.py)
HD void sample_concentric_disk(float u0, float u1, float* px_, float* py_) {
  float ux = 2.0f * u0 - 1.0f;
  float uy = 2.0f * u1 - 1.0f;
  bool at_origin = (ux == 0.0f) && (uy == 0.0f);
  bool x_bigger = fabsf(ux) > fabsf(uy);
  float safe_ux = ux == 0.0f ? 1.0f : ux;
  float safe_uy = uy == 0.0f ? 1.0f : uy;
  float r = x_bigger ? ux : uy;
  float theta = x_bigger
                    ? (float)(PI_D / 4.0) * (uy / safe_ux)
                    : (float)(PI_D / 2.0) - (float)(PI_D / 4.0) * (ux / safe_uy);
  float px = r * cosf(theta);
  float py = r * sinf(theta);
  *px_ = at_origin ? 0.0f : px;
  *py_ = at_origin ? 0.0f : py;
}
HD V3 sample_cosw_hemisphere(float u0, float u1) {
  float dx, dy;
  sample_concentric_disk(u0, u1, &dx, &dy);
  float z = sqrtf(fabsf(1.0f - dx * dx - dy * dy));
  return v3(dx, dy, z);
}
HD V3 sample_uniform_triangle(float u0, float u1) {
  float sqrtux = sqrtf(u0);
  float x = 1.0f - sqrtux;
  float y = sqrtux * u1;
  return v3(x, y, 1.0f - x - y);
}
HD float erf_(float x) {
  float sign = sgn(x);
  x = fabsf(x);
  const float a1 = 0.254829592f, a2 = -0.28449673f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  float t = 1.0f / (1.0f + p * x);
  float y = 1.0f - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t *
                       expf(-x * x);
  return sign * y;
}
HD float erf_inv(float x) {
  x = clampf_(x, -0.99999f, 0.99999f);
  float w = -logf((1.0f - x) * (1.0f + x));
  float w_lo = w - 2.5f;
  float p_lo = 2.81022636e-08f;
  const float clo[8] = {3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                        0.00021858087f,  -0.00125372503f, -0.00417768164f,
                        0.246640727f,    1.50140941f};
  for (int i = 0; i < 8; ++i) p_lo = clo[i] + p_lo * w_lo;
  float w_hi = sqrtf(mx(w, 1e-6f)) - 3.0f;
  float p_hi = -0.000200214257f;
  const float chi[8] = {0.000100950558f, 0.00134934322f, -0.00367342844f,
                        0.00573950773f,  -0.0076224613f, 0.00943887047f,
                        1.00167406f,     2.83297682f};
  for (int i = 0; i < 8; ++i) p_hi = chi[i] + p_hi * w_hi;
  return (w < 5.0f ? p_lo : p_hi) * x;
}
HD float acos_pos(float x) {
  x = clampf_(x, 0.0f, 1.0f);
  float p = -0.0187293f;
  p = 0.0742610f + p * x;
  p = -0.2121144f + p * x;
  p = 1.5707288f + p * x;
  return p * sqrtf(1.0f - x);
}

HD V3 sample_wh_beckmann(V3 wo, float ux, float uy, float ax, float ay) {
  V3 wo_st = vnormalize(v3(ax * wo.x, ay * wo.y, wo.z));
  float cos_t = fabsf(cos_theta(wo_st));
  float r_n = sqrtf(mx(-logf(mx(ux, 1e-20f)), 0.0f));
  float phi_n = (float)(2.0 * PI_D) * uy;
  float sx_n = r_n * cosf(phi_n);
  float sy_n = r_n * sinf(phi_n);
  float cos_ts = clampf_(cos_t, 1e-6f, 0.9999f);
  float sin_t = sqrtf(mx(1.0f - cos_ts * cos_ts, 0.0f));
  float tan_t = sin_t / cos_ts;
  float cot_t = cos_ts / mx(sin_t, 1e-12f);
  float uxs = mx(ux, 1e-6f);
  float theta = acos_pos(cos_ts);
  float fit = 1.0f + theta * (-0.876f + theta * (0.4265f - 0.0594f * theta));
  const float sqrt_pi_inv = (float)(1.0 / 1.7724538509055159);
  float c0 = erf_(cot_t);
  float b = c0 - (1.0f + c0) * powf(mx(1.0f - uxs, 1e-10f), fit);
  float norm = 1.0f / (1.0f + c0 + sqrt_pi_inv * tan_t * expf(-cot_t * cot_t));
  float a_ = -1.0f, b_ = b, c_ = c0;
  for (int it = 0; it < 9; ++it) {
    float b2 = ((b_ < a_) || (b_ > c_)) ? 0.5f * (a_ + c_) : b_;
    float inv = erf_inv(b2);
    float value = norm * (1.0f + b2 + sqrt_pi_inv * tan_t * expf(-inv * inv)) - uxs;
    float deriv = norm * (1.0f - inv * tan_t);
    float c_new = value > 0.0f ? b2 : c_;
    float a_new = value > 0.0f ? a_ : b2;
    float b_new = b2 - value / (deriv == 0.0f ? 1.0f : deriv);
    bool done = fabsf(value) < 1e-5f;
    a_ = done ? a_ : a_new;
    b_ = done ? b2 : b_new;
    c_ = done ? c_ : c_new;
  }
  float sx_g = erf_inv(b_);
  float sy_g = erf_inv(2.0f * mx(uy, 1e-6f) - 1.0f);
  bool near_ = cos_t > 0.9999f;
  float sx = near_ ? sx_n : sx_g;
  float sy = near_ ? sy_n : sy_g;
  float cphi = cos_phi(wo_st);
  float sphi = sin_phi(wo_st);
  float sx2 = cphi * sx - sphi * sy;
  float sy2 = sphi * sx + cphi * sy;
  sx = sx2 * ax;
  sy = sy2 * ay;
  V3 wh = vnormalize(v3(-sx, -sy, 1.0f));
  return vscale(wh, sgn(wo.z));
}

HD V3 sample_wh_trowbridge_oneside(V3 wo, float ux, float uy, float ax,
                                   float ay) {
  V3 wo_st = vnormalize(v3(ax * wo.x, ay * wo.y, wo.z));
  float cos_t = fabsf(cos_theta(wo_st));
  float r_n = sqrtf(ux / mx(1.0f - ux, 1e-20f));
  float phi_n = (float)(2.0 * PI_D) * uy;
  float sx_n = r_n * cosf(phi_n);
  float sy_n = r_n * sinf(phi_n);
  float cos_ts = clampf_(cos_t, 1e-6f, 0.9999f);
  float sin_t = sqrtf(mx(1.0f - cos_ts * cos_ts, 0.0f));
  float tan_t = sin_t / cos_ts;
  float cot_t = cos_ts / mx(sin_t, 1e-12f);
  float g1 = 2.0f / (1.0f + sqrtf(1.0f + 1.0f / (cot_t * cot_t)));
  float a = 2.0f * uy / g1 - 1.0f;
  float denom = a * a - 1.0f;
  float tmp = mn(1.0f / (denom == 0.0f ? 1e-20f : denom), 1e10f);
  float d = sqrtf(mx(tan_t * tan_t * tmp * tmp - (a * a - tan_t * tan_t) * tmp, 0.0f));
  float sx1 = tan_t * tmp - d;
  float sx2 = tan_t * tmp + d;
  float sx_g = ((a < 0.0f) || (sx2 > cot_t)) ? sx1 : sx2;
  float s = uy > 0.5f ? 1.0f : -1.0f;
  float uy2 = uy > 0.5f ? 2.0f * (uy - 0.5f) : 2.0f * (0.5f - uy);
  float z = (uy2 * (uy2 * (uy2 * 0.27385f - 0.73369f) + 0.46341f)) /
            (uy2 * (uy2 * (uy2 * 0.093073f + 0.309420f) - 1.0f) + 0.597999f);
  float sy_g = TR_COMPAT_NO_SQRT ? s * z * (1.0f + sx_g * sx_g)
                                 : s * z * sqrtf(1.0f + sx_g * sx_g);
  bool near_ = cos_t > 0.9999f;
  float sx = near_ ? sx_n : sx_g;
  float sy = near_ ? sy_n : sy_g;
  float cphi = cos_phi(wo_st);
  float sphi = sin_phi(wo_st);
  float sxr = cphi * sx - sphi * sy;
  float syr = sphi * sx + cphi * sy;
  sx = sxr * ax;
  sy = syr * ay;
  return vnormalize(v3(-sx, -sy, 1.0f));
}
HD V3 sample_wh_trowbridge(V3 wo, float ux, float uy, float ax, float ay) {
  bool flip = wo.z < 0.0f;
  V3 won = flip ? vneg(wo) : wo;
  V3 wh = sample_wh_trowbridge_oneside(won, ux, uy, ax, ay);
  return flip ? vneg(wh) : wh;
}
HD V3 mf_sample_wh(int dist, V3 wo, float ux, float uy, float ax, float ay,
                   int dists) {
  return use_beckmann(dist, dists) ? sample_wh_beckmann(wo, ux, uy, ax, ay)
                                   : sample_wh_trowbridge(wo, ux, uy, ax, ay);
}

}  // namespace cmath
