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

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

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
// input columns the kernels read outside the body (render/cbounce.py
// C_* for the fused layout, S_* for the split shade's) and output
// columns of the carried values
constexpr int C_HIT = 7, C_IS_SPH = 8, C_S_IDX = 9, C_TRI_LIGHT = 38,
              C_BETA = 39, C_L = 42, C_SPECULAR = 45, C_SEL_PREV = 46,
              C_WB_PREV = 47, C_ALIVE = 49;
constexpr int S_BETA = 31, S_L = 34, S_SPECULAR = 37, S_SEL_PREV = 38,
              S_WB_PREV = 39;
constexpr int OUT_L = 6, OUT_BETA = 9, OUT_WB_PREV = 15;

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

// The scene tables a lane reads: row r of the light table starts at
// ltab + lp * r, and so on.  A kernel that stages a table in shared
// memory may pad each row to an odd pitch (stage_tables), so that lanes
// reading different rows of a table read different banks; a table read
// in place, and every table of the host builds, keeps the dense
// [rows, cols] layout (dense_tables).
struct Tables {
  const float* ltab;
  int nl, cl;
  const float* mtab;  // [nm, 16]
  int nm;
  const float* stab;  // [ns, 24]
  int ns;
  int lp, mp, sp;  // row pitches in floats: >= cl, 16, 24
};
HD Tables dense_tables(const float* ltab, int nl, int cl, const float* mtab,
                       int nm, const float* stab, int ns) {
  return Tables{ltab, nl, cl, mtab, nm, stab, ns, cl, 16, 24};
}
// the least odd pitch that holds a row of `cols` floats: rows whose
// indices differ by less than 32 then start in different banks
HD int odd_pitch(int cols) { return cols | 1; }
// The pitch a table of `cols` columns is staged at in shared memory:
// the odd pitch (K3 / K6) or the dense one (K4 / K5)
HD int stage_pitch(int cols, bool odd) { return odd ? odd_pitch(cols) : cols; }
// Which tables a launch stages in shared memory (kernels/ops.py
// stage_plan; one bit a table): a table whose bit is clear is read in
// place, from global memory, at its dense pitch.  Scenes whose tables
// all fit stage all of them; a table past what a block can hold stays
// where it lies.
constexpr int STAGE_L = 1, STAGE_M = 2, STAGE_S = 4;
constexpr int STAGE_ALL = STAGE_L | STAGE_M | STAGE_S;

#ifdef __CUDACC__
// The live count a kernel reads on the device: *n_alive clamped into
// [0, n], or n where no count is given.
__device__ __forceinline__ long live_count(const int* n_alive, long n) {
  if (n_alive == nullptr) return n;
  const long na = *n_alive;
  return na < 0 ? 0 : (na > n ? n : na);
}

// Copy a dense [rows, cols] table into shared memory at row pitch
// `pitch`, the block's threads striding over its elements.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int rows, int cols, int pitch,
                                           float* dst) {
  const int total = rows * cols;
  if (pitch == cols) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) dst[i] = src[i];
    return;
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / cols;
    dst[r * pitch + (i - r * cols)] = src[i];
  }
}

// The tables of a block: those `staged` names copied into smem in the
// order lights, materials, spheres, each row at stage_pitch, the others
// read in place at their dense pitches.  The block's threads stride over
// the staged elements; the caller then waits at a barrier.  With
// `staged` the constant STAGE_ALL this is the copy of every table and
// the pointers all lie in shared memory.
__device__ __forceinline__ Tables stage_tables(
    const float* __restrict__ ltab, int nl, int cl,
    const float* __restrict__ mtab, int nm, const float* __restrict__ stab,
    int ns, int staged, bool odd, float* smem) {
  Tables tb = dense_tables(ltab, nl, cl, mtab, nm, stab, ns);
  float* p = smem;
  if (staged & STAGE_L) {
    tb.lp = stage_pitch(cl, odd);
    stage_rows(ltab, nl, cl, tb.lp, p);
    tb.ltab = p;
    p += nl * tb.lp;
  }
  if (staged & STAGE_M) {
    tb.mp = stage_pitch(16, odd);
    stage_rows(mtab, nm, 16, tb.mp, p);
    tb.mtab = p;
    p += nm * tb.mp;
  }
  if (staged & STAGE_S) {
    tb.sp = stage_pitch(24, odd);
    stage_rows(stab, ns, 24, tb.sp, p);
    tb.stab = p;
  }
  return tb;
}

// Bytes of shared memory stage_tables takes
inline size_t staged_bytes(int nl, int cl, int nm, int ns, int staged,
                           bool odd) {
  return sizeof(float) *
         (((staged & STAGE_L) ? (size_t)nl * stage_pitch(cl, odd) : 0) +
          ((staged & STAGE_M) ? (size_t)nm * stage_pitch(16, odd) : 0) +
          ((staged & STAGE_S) ? (size_t)ns * stage_pitch(24, odd) : 0));
}

// Let `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only after the attribute is raised).  Returns a cudaError_t code.
inline int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// info[0..4) = smem, the blocks of `block` threads with smem bytes of
// dynamic shared memory an SM holds at once, the kernel's registers a
// thread and its local memory a thread (B).  Returns a cudaError_t code.
inline int occupancy(const void* kernel, int block, size_t smem, int* info) {
  int e = allow_smem(kernel, smem);
  if (e) return e;
  cudaFuncAttributes attr;
  cudaError_t c = cudaFuncGetAttributes(&attr, kernel);
  if (c != cudaSuccess) return (int)c;
  c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel, block,
                                                    smem);
  info[0] = (int)smem;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  return (int)c;
}
#endif

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

// a[k] for a slot index k known only at run time, as selects among the
// constant entries: the slot arrays are then only ever indexed by
// constants and stay in registers (one run-time index would put the
// whole Slots in local memory, a stack frame of 192 bytes a lane)
static_assert(MAX_SLOTS == 3, "pick3 selects among three slots");
template <class T>
HD T pick3(const T (&a)[MAX_SLOTS], int k) {
  return k == 2 ? a[2] : (k == 1 ? a[1] : a[0]);
}
// a loop that evaluates one slot per pass: one copy of the evaluation
#define SLOT_LOOP _Pragma("unroll 1")

#include "cbounce_body.cuh"
#undef SLOT_LOOP

// A lane's input columns, read where the body uses them: xv[c] is
// x[c * stride] (on the card a read-only load).
struct Cols {
  const float* x;
  long stride;
  HD float operator[](int c) const {
#ifdef __CUDA_ARCH__
    return __ldg(x + (long)c * stride);
#else
    return x[(long)c * stride];
#endif
  }
};

// A lane's output columns: out(j, v) writes column j.
struct ColumnOut {
  float* out;
  long stride;
  HD void operator()(int j, float v) const { out[(long)j * stride] = v; }
};

// x(c) = lane's input column c; out(c) = lane's output column c
HD void cbody_lane(const float* x, long stride, const Tables& tb,
                   const ShadeCfg& cfg, float* out) {
  int rows[N_ROW_SLOTS];
  const ColumnOut o{out, stride};
  cbody_core(Cols{x, stride}, tb, cfg, o, rows);
#pragma unroll
  for (int j = 28; j < OUT_COLS; ++j) o(j, 0.0f);
}

// The output of a lane past the wave's live count (n_alive), whose body
// does not run: the carried columns L, beta, specular, sel_prev and
// wb_prev pass through (the flags and indices converted as the body
// converts them), alive, nee_prev, need_shadow and contrib are 0, and
// the rays take constants: o = sh_o = 0, d = sh_d = (0, 0, 1) (the
// body's degenerate direction), sh_t = 0.  Nothing reads those lanes:
// the intersect kernels treat them as misses and the deferred MIS gates
// on alive.  c_beta, c_l, c_spec, c_sel, c_wb: the input columns of the
// carried values (the fused and the split layout differ).  Plain twin:
// render/cbounce.py dead_lane_out.
HD void dead_lane(const float* x, long stride, int c_beta, int c_l,
                  int c_spec, int c_sel, int c_wb, float* out) {
  const Cols xv{x, stride};
  const ColumnOut o{out, stride};
  const float zero = 0.0f, one = 1.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o(j, zero);
    o(3 + j, j == 2 ? one : zero);
    o(6 + j, xv[c_l + j]);
    o(9 + j, xv[c_beta + j]);
    o(17 + j, zero);
    o(20 + j, j == 2 ? one : zero);
    o(25 + j, zero);
  }
  o(12, zero);
  o(13, xv[c_spec] > 0.5f ? one : zero);
  o(14, (float)(int)xv[c_sel]);
  o(15, xv[c_wb]);
  o(16, zero);
  o(23, zero);
  o(24, zero);
#pragma unroll
  for (int j = 28; j < OUT_COLS; ++j) o(j, zero);
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
#pragma unroll
  for (int c = 0; c < HIT_IN_COLS; ++c) xv[c] = x[(long)c * stride];
  HitInfo h;
  int rows[N_ROW_SLOTS];
  hit_info(xv, tb, &h, rows);
  const float* tr = xv + 13;
  float u, v;
  if (h.is_sph) {
    sphere_uv(tb.stab + tb.sp * rows[SLOT_S], v3(xv[10], xv[11], xv[12]),
              &u, &v);
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
  const Cols xv{x, stride};
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
  int rows[N_ROW_SLOTS];
  const ColumnOut o{out, stride};
  shade_core(s, tb, cfg, o, rows);
#pragma unroll
  for (int j = 28; j < OUT_COLS; ++j) o(j, 0.0f);
}

}  // namespace cbounce
