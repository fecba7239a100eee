// The bounce body (cbounce_body.cuh) on the taped scalar ad::R, and
// the per-lane code of the bounce-shade backward kernel (K4): the
// classifier of lanes whose VJP needs the body, the pass-through of
// those that do not, and the backward of those that do (one lane's
// forward is recorded on its tape, then swept in reverse).  The kernel
// (cbounce_bwd.cu) and its host build (cbounce_bwd_host.cpp) share it.
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
// The body functions are calls here, so their Slots live in local memory
// whatever the index: a run-time slot index reads the entry directly,
// and the compiler shapes the slot loops.
template <class T>
HD T pick3(const T (&a)[MAX_SLOTS], int k) {
  return a[k];
}
#define SLOT_LOOP

#include "cbounce_body.cuh"
#undef SLOT_LOOP

// leaf slot of the lane's input columns (the table row slots are
// SLOT_M..SLOT_S)
constexpr int SLOT_X = N_ROW_SLOTS;
// the sweep holds the records of the SWEEP_AHEAD nodes after the next
constexpr int SWEEP_AHEAD = 4;

// The layout of a lane's table share: row slot s takes columns
// base[s]..base[s + 1] of the lane's row of lane_tab, and its
// [rows[s], cols] region of a partial sum starts at off[s].
struct TabLayout {
  int base[N_ROW_SLOTS + 1];
  int off[N_ROW_SLOTS + 1];
  int rows[N_ROW_SLOTS];
  HD TabLayout(int nl, int cl, int nm, int ns) {
    int cols[N_ROW_SLOTS] = {16, cl, cl, 24};
    int nrows[N_ROW_SLOTS] = {nm, nl, nl, ns};
    base[0] = 0;
    off[0] = 0;
    for (int s = 0; s < N_ROW_SLOTS; ++s) {
      rows[s] = nrows[s];
      base[s + 1] = base[s] + cols[s];
      off[s + 1] = off[s] + nrows[s] * cols[s];
    }
  }
};

// Whether a lane's VJP needs its body.  A lane past the wave's live
// count (lane >= n_alive) never does: the forward passes its L, beta
// and wb_prev through (cbounce.cuh dead_lane), so its VJP is the
// identity on them (pass_through).  Nor does a live lane that adds no
// emission (cbounce_body.cuh emission_gate) and whose output cotangent
// is zero outside L and finite on L: there L_out = L_in + 0 and every
// other output has a zero cotangent, so dx is ct_L on L_in and zero
// elsewhere (pass_through, whose beta and wb_prev columns are then
// zero), and the lane adds nothing to the table cotangents.  x / ct:
// the lane's input and output cotangent columns, stride apart.  Plain
// twin: render/cbounce.py bwd_needs_body.
HD bool needs_body(const float* x, const float* ct, long stride, long lane,
                   long n_alive, const Tables& tb) {
  if (lane >= n_alive) return false;
  const bool hit = x[(long)C_HIT * stride] > 0.5f;
  const int light_id = cbounce::hit_light_id(
      hit, x[(long)C_IS_SPH * stride] > 0.5f,
      (int)x[(long)C_S_IDX * stride], x[(long)C_TRI_LIGHT * stride], tb);
  if (cbounce::emission_gate(x[(long)C_ALIVE * stride] > 0.5f, hit,
                             light_id))
    return true;
  for (int j = 0; j < 28; ++j) {
    const float g = ct[(long)j * stride];
    if (j >= OUT_L && j < OUT_L + 3 ? !isfinite(g) : g != 0.0f) return true;
  }
  return false;
}

// dx of a lane that needs no body: the cotangents of L, beta and
// wb_prev on their input columns, zero elsewhere.
HD void pass_through(const float* ct, long stride, float* dx) {
  for (int c = 0; c < IN_COLS; ++c) dx[(long)c * stride] = 0.0f;
  for (int j = 0; j < 3; ++j) {
    dx[(long)(C_L + j) * stride] = ct[(long)(OUT_L + j) * stride];
    dx[(long)(C_BETA + j) * stride] = ct[(long)(OUT_BETA + j) * stride];
  }
  dx[(long)C_WB_PREV * stride] = ct[(long)OUT_WB_PREV * stride];
}

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
  cbody_core(xv, tb, cfg, ArrayOut{res}, rows);
  for (int c = 0; c < IN_COLS; ++c) dx[(long)c * stride] = 0.0f;
  if (n > t.cap) {
    for (int c = 0; c < IN_COLS; ++c) dx[(long)c * stride] = NAN;
    for (int s = 0; s < N_ROW_SLOTS; ++s)
      for (int c = tab_base[s]; c < tab_base[s + 1]; ++c) lane_tab[c] = NAN;
    return false;
  }
  // node k of this lane's tape is tp[k * st]
  ad::Node* const tp = t.node + ad::tape_slot();
  const long st = t.stride;
  const int nn = n;
  // outputs 28..31 are constant zeros
  for (int j = 0; j < 28; ++j)
    if (res[j].i >= 0) tp[res[j].i * st].adj += ct[(long)j * stride];
  // The sweep, from the last node to the first.  A node's record is
  // loaded SWEEP_AHEAD + 1 nodes before its turn, so that the loads
  // overlap the work between; its adjoint is then the loaded one plus
  // near[0], the contributions of the nodes swept since the load, which
  // stay in registers (near[d]: node k - d).  A contribution to an older
  // node, and a leaf's adjoint, is added in memory by a reduction the
  // thread does not wait for.  The sums are deterministic: each part of
  // an adjoint is added to in the order of the sweep.
  ad::Node rec[SWEEP_AHEAD + 1];  // rec[d]: node k - d
  float near[SWEEP_AHEAD + 1];
#pragma unroll
  for (int d = 0; d <= SWEEP_AHEAD; ++d) {
    if (nn - 1 - d >= 0) rec[d] = ad::get(tp + (nn - 1 - d) * st);
    near[d] = 0.0f;
  }
  for (int k = nn - 1; k >= 0; --k) {
    const ad::Node cur = rec[0];
    const float g = cur.adj + near[0];
#pragma unroll
    for (int d = 0; d < SWEEP_AHEAD; ++d) {
      rec[d] = rec[d + 1];
      near[d] = near[d + 1];
    }
    near[SWEEP_AHEAD] = 0.0f;
    if (k - 1 - SWEEP_AHEAD >= 0)
      rec[SWEEP_AHEAD] = ad::get(tp + (k - 1 - SWEEP_AHEAD) * st);
    const int a = (short)(cur.par & 0xffffu);
    const int b = (short)(cur.par >> 16);
    if (a <= -2) {  // a leaf: slot -2 - a, column b
      const int slot = -2 - a;
      ad::add(slot == SLOT_X ? dx + (long)b * stride
                             : lane_tab + tab_base[slot] + b,
              g);
      continue;
    }
    // after the shift, near[e] is node k - 1 - e's, e <= SWEEP_AHEAD (the
    // one whose record was just loaded, so it takes node k's part here)
    const int ops[2] = {a, b};
    const float part[2] = {cur.da, cur.db};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int o = ops[q];
      if (o < 0) continue;
      const float c = g * part[q];
      bool kept = false;
#pragma unroll
      for (int e = 0; e <= SWEEP_AHEAD; ++e)
        if (o == k - 1 - e) {
          near[e] += c;
          kept = true;
        }
      if (!kept) ad::add(&tp[o * st].adj, c);
    }
  }
  return true;
}

}  // namespace cbounce_ad

#undef HDB
#define HDB HD
