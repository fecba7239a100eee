// The bounce body (cbounce_body.cuh) on the taped scalar ad::R, and
// the per-lane backward of the bounce-shade backward kernel (K4): one
// lane's forward is recorded on its tape, then swept in reverse.
#pragma once

#include "cbounce.cuh"
#include "cmath_ad.cuh"

namespace cbounce_ad {

using namespace cmath_ad;
using namespace cshade;

HD Row mkrow(const float* p, int slot) {
  Row r;
  r.p = p;
  r.slot = slot;
  r.off = 0;
  return r;
}
HD V3 ld3(Row r, int c) { return v3(r[c], r[c + 1], r[c + 2]); }

#include "cbounce_body.cuh"

// leaf slot of the lane's input columns (the table row slots are
// SLOT_M..SLOT_S)
constexpr int SLOT_X = N_ROW_SLOTS;

// One lane's backward.  x / ct / dx: the lane's input, output cotangent
// and input cotangent columns (stride apart).  lane_tab: the lane's
// share of the table cotangents, its row slot SLOT_M..SLOT_S starting
// at tab_base[slot] (zero on entry); rows: the table row of each slot.
// Returns false when the tape was too short (dx and lane_tab are then
// NaN).
HD bool cbody_lane_bwd(const float* x, const float* ct, long stride,
                       const Tables& tb, const ShadeCfg& cfg, float* dx,
                       float* lane_tab, const int* tab_base,
                       int rows[N_ROW_SLOTS]) {
  ad::Tape& t = ad::tape();
  int& n = ad::count();
  n = 0;
  R xv[IN_COLS];
  for (int c = 0; c < IN_COLS; ++c)
    xv[c] = ad::leaf(x[(long)c * stride], SLOT_X, c);
  R res[28];
  cbody_core(xv, tb, cfg, res, rows);
  for (int c = 0; c < IN_COLS; ++c) dx[(long)c * stride] = 0.0f;
  if (n > t.cap) {
    for (int c = 0; c < IN_COLS; ++c) dx[(long)c * stride] = NAN;
    for (int s = 0; s < N_ROW_SLOTS; ++s)
      for (int c = tab_base[s]; c < tab_base[s + 1]; ++c) lane_tab[c] = NAN;
    return false;
  }
  // outputs 28..31 are constant zeros
  for (int j = 0; j < 28; ++j)
    if (res[j].i >= 0) t.adj[ad::at(res[j].i)] += ct[(long)j * stride];
  for (int k = n - 1; k >= 0; --k) {
    long ak = ad::at(k);
    float g = t.adj[ak];
    unsigned p = t.par[ak];
    int a = (short)(p & 0xffffu);
    int b = (short)(p >> 16);
    if (a <= -2) {  // a leaf: slot -2 - a, column b
      int slot = -2 - a;
      if (slot == SLOT_X)
        dx[(long)b * stride] += g;
      else
        lane_tab[tab_base[slot] + b] += g;
      continue;
    }
    if (a >= 0) t.adj[ad::at(a)] += g * t.da[ak];
    if (b >= 0) t.adj[ad::at(b)] += g * t.db[ak];
  }
  return true;
}

}  // namespace cbounce_ad

#undef HDB
#define HDB HD
