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
// backward kernel.
#pragma once

#include "cmath.cuh"

namespace cshade {

using namespace cdefs;

constexpr int IN_COLS = 58;
constexpr int OUT_COLS = 32;
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

}  // namespace cbounce
