// The per-lane bounce shade: CUDA C++ translation of
// arendur_tpu_torch/render/cbounce.py (cbody), which ports
// arendur_tpu/render/cbounce.py:77-811.  One call shades one lane:
// it reads the lane's IN_COLS=58 input column entries and writes its
// OUT_COLS=32 outputs (column layout of pallas_bounce.py:64-86).
//
// Where the Python version evaluates every branch and selects with
// torch.where, this version evaluates only the selected branch; the
// selected value is the same.  The host-static configuration (slot and
// distribution presence, light column map, light types present,
// full-phi, Russian-roulette settings) arrives as a ShadeCfg.
//
// The body itself is cbounce_body.cuh, compiled here on float for the
// forward kernel and in cbounce_ad.cuh on the taped scalar for the
// backward kernel.  Its two halves also run alone, on float, in the
// textured split: hit_lane (hit info, uv and the ray-cone uv footprint
// over HIT_IN_COLS=41 columns) and shade_split_lane (the shade proper
// over SHADE_IN_COLS=50 texture-resolved columns), the bodies of
// render/cbounce.py's cbody_hit and cbody_shade.
#pragma once

#include "cmath.cuh"

namespace cshade {

using namespace cdefs;

constexpr int IN_COLS = 58;
constexpr int OUT_COLS = 32;
constexpr int HIT_IN_COLS = 41;   // 0:39 as IN_COLS, cone width, spread
constexpr int HIT_OUT_COLS = 28;
constexpr int SHADE_IN_COLS = 50;
constexpr int MAX_SLOTS = 3;
constexpr int M_MATTE = 0, M_PLASTIC = 1, M_GLASS = 2, M_TRANSLUCENT = 3;
constexpr int L_AREA_SPHERE = 0, L_AREA_TRI = 1, L_POINT = 2, L_SPOT = 3,
              L_DISTANT = 4;
constexpr float GAMMA7 = (float)(7.0 * 0x1p-24 / (1.0 - 7.0 * 0x1p-24));

// Host-static configuration, filled by kernels/ops.py (same order).
struct ShadeCfg {
  int pres[MAX_SLOTS];  // per slot column: bitmask of BSDF types (bit t)
  int any_pres;         // union of pres
  int single_col;       // at most one slot column can hold a BSDF
  int fam_dist[10];     // per slot type: bit0 Beckmann, bit1 Trowbridge
  int lpresent;         // bitmask of light types present
  int c_ltype, c_emission, c_pos, c_aux, c_params;
  int c_tri_v0, c_tri_v1, c_tri_v2, c_tri_n0, c_tri_n1, c_tri_n2;
  int c_s_o2w, c_s_w2o, c_s_radius, c_s_zmin, c_s_zmax, c_s_thetamin,
      c_s_thetamax, c_s_phimax;
  int emi;       // first emission column
  int min_depth;
  int full_phi;
  int theta_compat;
  float rr_threshold;
  float rr_q;      // max(rr_threshold, 0.05), rounded from double
  float rr_scale;  // 1 / (1 - q), rounded from double
};

struct Tables {
  const float* ltab;
  int nl, cl;
  const float* mtab;  // [nm, 16]
  int nm;
  const float* stab;  // [ns, 24]
  int ns;
};

HD int row_idx(int idx, int n) { return (idx >= 0 && idx < n) ? idx : 0; }
HD bool has_l(const ShadeCfg& cfg, int t) { return (cfg.lpresent >> t) & 1; }

// The table rows one lane reads, by slot: the material row, the row of
// the light it hit (emission), the row of the light it samples, the
// sphere row.  The backward kernel sums each table's cotangent per row
// slot.
constexpr int SLOT_M = 0, SLOT_LE = 1, SLOT_LS = 2, SLOT_S = 3;
constexpr int N_ROW_SLOTS = 4;

}  // namespace cshade

namespace cbounce {

using namespace cmath;
using namespace cshade;

HD Row mkrow(const float* p, int) { return p; }
// the backward's value / constant conversions (identities here)
HD V3 vval(V3 a) { return a; }
HD V3 vconst(V3 a) { return a; }
HD V3 ld3(Row r, int c) { return v3(r[c], r[c + 1], r[c + 2]); }

#include "cbounce_body.cuh"

// x(c) = lane's input column c; out(c) = lane's output column c
HD void cbody_lane(const float* x, long stride, const Tables& tb,
                   const ShadeCfg& cfg, float* out) {
  float xv[IN_COLS];
  for (int c = 0; c < IN_COLS; ++c) xv[c] = x[(long)c * stride];
  float res[28];
  int rows[N_ROW_SLOTS];
  cbody_core(xv, tb, cfg, res, rows);
  for (int j = 0; j < 28; ++j) out[(long)j * stride] = res[j];
  for (int j = 28; j < OUT_COLS; ++j) out[(long)j * stride] = 0.0f;
}

// ---------------------------------------------------------------------------
// the textured split (render/cbounce.py cbody_hit / cbody_shade)
// ---------------------------------------------------------------------------

// uv at a local sphere point (render/cbounce.py _sphere_uv)
HD void sphere_uv(Row s, V3 p, float* u, float* v) {
  float radius = s[16], thetamin = s[17], thetamax = s[18], phimax = s[19];
  float phi = atan2_poly(p.y, p.x);
  phi = phi < 0.0f ? phi + (float)(2.0 * PI_D) : phi;
  *u = phi / mx(phimax, 1e-8f);
  float theta = acos_poly(clampf_(p.z / mx(radius, 1e-20f),
                                  (float)(-1.0 + 1e-7), (float)(1.0 - 1e-7)));
  float dt = thetamax - thetamin;
  *v = (theta - thetamin) / (fabsf(dt) < 1e-8f ? 1.0f : dt);
}

// least-squares duv from dp = dpdu du + dpdv dv, the axis where |n| is
// largest dropped (render/cbounce.py _solve_duv_c)
HD void solve_duv(V3 n, V3 dpdu, V3 dpdv, V3 dp, float* du, float* dv) {
  float anx = fabsf(n.x), any_ = fabsf(n.y), anz = fabsf(n.z);
  bool amax0 = (anx >= any_) && (anx >= anz);
  bool amax2 = !amax0 && (anz > any_);
  float a00 = amax0 ? dpdu.y : dpdu.x, a01 = amax0 ? dpdv.y : dpdv.x;
  float a10 = amax2 ? dpdu.y : dpdu.z, a11 = amax2 ? dpdv.y : dpdv.z;
  float b0 = amax0 ? dp.y : dp.x, b1 = amax2 ? dp.y : dp.z;
  float det = a00 * a11 - a01 * a10;
  bool ok = fabsf(det) > 1e-20f;
  float inv = ok ? 1.0f / det : 0.0f;
  *du = (a11 * b0 - a01 * b1) * inv;
  *dv = (a00 * b1 - a10 * b0) * inv;
}

// uv footprint of a ray cone of width r arriving along d (render/
// cbounce.py _cone_duv_c): duv = (du/dx, dv/dx, du/dy, dv/dy).  The
// inverse length is 1 / sqrtf, correctly rounded like the plain
// version's 1 / torch.sqrt (rsqrtf is not).
HD void cone_duv(float r, V3 d, V3 ng, V3 dpdu, V3 dpdv, float duv[4]) {
  float cos_i = vdot(d, ng);
  V3 proj = vsub(d, vscale(ng, cos_i));
  float p2 = vlength2(proj);
  float rs = 1.0f / sqrtf(mx(p2, 1e-30f));
  V3 nd = vnormalize(dpdu);
  V3 e1 = p2 > 1e-12f ? vscale(proj, rs) : nd;
  V3 e2 = vcross(ng, e1);
  V3 a1 = vscale(e1, r / mx(fabsf(cos_i), 0.1f));
  V3 a2 = vscale(e2, r);
  solve_duv(ng, dpdu, dpdv, a1, &duv[0], &duv[1]);
  solve_duv(ng, dpdu, dpdv, a2, &duv[2], &duv[3]);
}

// The hit body over one lane: HIT_IN_COLS inputs -> HIT_OUT_COLS outputs
// (pos, pos_err, ng, ns, dpdu, dpdv, uv, duvdx, duvdy, mat_id, light_id,
// cone width, pad).  Only tb.stab / tb.ns are read.
HD void hit_lane(const float* x, long stride, const Tables& tb, float* out) {
  float xv[HIT_IN_COLS];
  for (int c = 0; c < HIT_IN_COLS; ++c) xv[c] = x[(long)c * stride];
  HitInfo h;
  int rows[N_ROW_SLOTS];
  hit_info(xv, tb, &h, rows);
  const float* tr = xv + 13;
  float u, v;
  if (h.is_sph) {
    sphere_uv(tb.stab + 24 * rows[SLOT_S], v3(xv[10], xv[11], xv[12]), &u,
              &v);
  } else {
    float b2 = 1.0f - h.b0 - h.b1;
    u = h.b0 * tr[18] + h.b1 * tr[20] + b2 * tr[22];
    v = h.b0 * tr[19] + h.b1 * tr[21] + b2 * tr[23];
  }
  float cone_w = xv[HIT_IN_COLS - 2], spread = xv[HIT_IN_COLS - 1];
  float ft = h.hitmask ? xv[6] : 0.0f;
  float r_cone = cone_w + spread * ft;
  float duv[4];
  cone_duv(r_cone, v3(xv[3], xv[4], xv[5]), h.ng, h.dpdu, h.dpdv, duv);
  float r[HIT_OUT_COLS] = {
      h.pos.x, h.pos.y, h.pos.z, h.pos_err.x, h.pos_err.y, h.pos_err.z,
      h.ng.x, h.ng.y, h.ng.z, h.ns.x, h.ns.y, h.ns.z,
      h.dpdu.x, h.dpdu.y, h.dpdu.z, h.dpdv.x, h.dpdv.y, h.dpdv.z,
      u, v, duv[0], duv[1], duv[2], duv[3],
      (float)h.mat_id, (float)h.light_id, h.hitmask ? r_cone : cone_w, 0.0f};
  for (int j = 0; j < HIT_OUT_COLS; ++j) out[(long)j * stride] = r[j];
}

// The shade body over one lane: SHADE_IN_COLS texture-resolved inputs
// -> OUT_COLS outputs, the layout of cbody_lane's.  Only the light
// table of tb is read.
HD void shade_split_lane(const float* x, long stride, const Tables& tb,
                         const ShadeCfg& cfg, float* out) {
  float xv[SHADE_IN_COLS];
  for (int c = 0; c < SHADE_IN_COLS; ++c) xv[c] = x[(long)c * stride];
  auto c3 = [&](int j) { return v3(xv[j], xv[j + 1], xv[j + 2]); };
  ShadeIn s;
  s.d = c3(0);
  s.pos = c3(3);
  s.pos_err = c3(6);
  s.ng = c3(9);
  s.ns = c3(12);
  s.dpdu = c3(15);
  s.mtype = (int)xv[18];
  s.kd = c3(19);
  s.ks = c3(22);
  s.sigma = xv[25];
  s.rough = xv[26];
  s.eta = xv[27];
  s.dissolve = xv[28];
  s.light_id = (int)xv[29];
  s.hitmask = xv[30] > 0.5f;
  s.beta = c3(31);
  s.L = c3(34);
  s.specular = xv[37] > 0.5f;
  s.sel_prev = (int)xv[38];
  s.wb_prev = xv[39];
  s.nee_prev = xv[40] > 0.5f;
  s.alive = xv[41] > 0.5f;
  s.lidx = (int)xv[42];
  s.selpdf = xv[43];
  s.ul0 = xv[44];
  s.ul1 = xv[45];
  s.ub0 = xv[46];
  s.ub1 = xv[47];
  s.u_rr = xv[48];
  s.bounce = xv[49];
  float res[28];
  int rows[N_ROW_SLOTS];
  shade_core(s, tb, cfg, res, rows);
  for (int j = 0; j < 28; ++j) out[(long)j * stride] = res[j];
  for (int j = 28; j < OUT_COLS; ++j) out[(long)j * stride] = 0.0f;
}

}  // namespace cbounce
