// Per-lane pieces of the BSDF slot sweeps (K8 / K9, slot_shade.cu):
// the reader of a lane's BSDF where the BsdfSlots fields lie (a slot at
// a time), the reader of the earlier lane-major pack (all at once), the
// sweeps of one lane, and the material-recipe key K8 orders its lanes
// by.  __host__
// __device__, so that a host build (slot_shade_host.cpp) runs the same
// per-lane code and the same stable counting sort on the CPU.
#pragma once

#include "cbounce.cuh"

namespace slots {

using cmath::V3;
using cmath::v3;
using cshade::ShadeCfg;

constexpr int K = cshade::MAX_SLOTS;

// The BsdfSlots fields of N lanes, row-major as PyTorch holds them:
// ns ts bs ng [N,3] f32; type kind dist [N,K] int32; c0 c1 [N,K,3] f32;
// p0 p1 p2 [N,K] f32.
struct Fields {
  const float* ns;
  const float* ts;
  const float* bs;
  const float* ng;
  const int* type;
  const int* kind;
  const int* dist;
  const float* c0;
  const float* c1;
  const float* p0;
  const float* p1;
  const float* p2;
};

// a read-only load on the card, a plain one on the host
HD float ld(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}
HD int ld(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// row `lane` of an [N,3] field
HD V3 row3(const float* x, long lane) {
  const float* r = x + 3 * lane;
  return v3(ld(r), ld(r + 1), ld(r + 2));
}
HD void put3(float* x, long lane, V3 v) {
  float* r = x + 3 * lane;
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
}

// Lane `lane`'s BSDF read where it lies: the frame and the slots' kinds
// up front, the rest of a slot when the sweep reaches it (slot_at), so
// that no slot is held in registers across the sweeps' loops over
// slots.  Neighbouring lanes read neighbouring rows: a warp's loads of
// an [N,3] field cover 384 contiguous bytes.
struct LaneSlots {
  Fields p;
  long s;  // the lane's first slot: K * lane
  V3 ns, ts, bs, ng;
  int kind[K];
};
HD LaneSlots lane_slots(const Fields& p, long lane) {
  LaneSlots b;
  b.p = p;
  b.s = K * lane;
  b.ns = row3(p.ns, lane);
  b.ts = row3(p.ts, lane);
  b.bs = row3(p.bs, lane);
  b.ng = row3(p.ng, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) b.kind[k] = ld(p.kind + b.s + k);
  return b;
}
// slot k of the lane (found by the sweeps' slot_at(b, k) calls)
HD cbounce::Slot slot_at(const LaneSlots& b, int k) {
  const long i = b.s + k;
  cbounce::Slot sl;
  sl.type = ld(b.p.type + i);
  sl.kind = cbounce::pick3(b.kind, k);
  sl.dist = ld(b.p.dist + i);
  sl.c0 = row3(b.p.c0, i);
  sl.c1 = row3(b.p.c1, i);
  sl.p0 = ld(b.p.p0 + i);
  sl.p1 = ld(b.p.p1 + i);
  sl.p2 = ld(b.p.p2 + i);
  return sl;
}

// The earlier lane-major pack (bxdf/slot_shade.py pack_slots):
// PACK_COLS = 12 + 12 K columns [PACK_COLS, N] (frame ns ts bs ng, then
// per slot type, kind, dist as floats, c0, c1, p0, p1, p2), followed by
// wo and u (K8) or wo and wi (K9).
constexpr int PACK_COLS = 12 + 12 * K;
constexpr int C_TYPE = 12, C_KIND = 12 + K, C_DIST = 12 + 2 * K;
constexpr int C_C0 = 12 + 3 * K, C_C1 = 12 + 6 * K;
constexpr int C_P0 = 12 + 9 * K, C_P1 = 12 + 10 * K, C_P2 = 12 + 11 * K;
constexpr int SAMPLE_OUT_COLS = 8, EVAL_OUT_COLS = 4;

// column c of a lane's pack; x is the pack's base offset by the lane
HD float col(const float* x, long n, int c) { return ld(x + (long)c * n); }
HD V3 col3(const float* x, long n, int c) {
  return v3(col(x, n, c), col(x, n, c + 1), col(x, n, c + 2));
}

HD void read_packed(const float* x, long n, cbounce::Slots* b) {
  b->ns = col3(x, n, 0);
  b->ts = col3(x, n, 3);
  b->bs = col3(x, n, 6);
  b->ng = col3(x, n, 9);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b->type[k] = (int)col(x, n, C_TYPE + k);
    b->kind[k] = (int)col(x, n, C_KIND + k);
    b->dist[k] = (int)col(x, n, C_DIST + k);
    b->c0[k] = col3(x, n, C_C0 + 3 * k);
    b->c1[k] = col3(x, n, C_C1 + 3 * k);
    b->p0[k] = col(x, n, C_P0 + k);
    b->p1[k] = col(x, n, C_P1 + k);
    b->p2[k] = col(x, n, C_P2 + k);
  }
}

// The outputs of the in-place sweeps: f [N,3], wi [N,3] (K8), pdf [N],
// kind [N] int32 (K8), each lane's at its own index.
struct Outs {
  float* f;
  float* wi;
  float* pdf;
  int* kind;
};

// K8 on one lane: the BSDF from the fields, wo [N,3], u [N,2]
HD void sample_lane(const Fields& p, long lane, const float* wo,
                    const float* u, int types, const ShadeCfg& cfg,
                    const Outs& o) {
  const LaneSlots b = lane_slots(p, lane);
  V3 f, wi;
  float pdf;
  int kind;
  cbounce::bsdf_sample(b, row3(wo, lane), ld(u + 2 * lane),
                       ld(u + 2 * lane + 1), cfg, &f, &wi, &pdf, &kind,
                       types);
  put3(o.f, lane, f);
  put3(o.wi, lane, wi);
  o.pdf[lane] = pdf;
  o.kind[lane] = kind;
}

// K9 on one lane: the BSDF from the fields, wo and wi [N,3]
HD void eval_pdf_lane(const Fields& p, long lane, const float* wo,
                      const float* wi, int types, const ShadeCfg& cfg,
                      const Outs& o) {
  const LaneSlots b = lane_slots(p, lane);
  V3 f;
  float pdf;
  cbounce::bsdf_eval_pdf(b, row3(wo, lane), row3(wi, lane), cfg, &f, &pdf,
                         types);
  put3(o.f, lane, f);
  o.pdf[lane] = pdf;
}

// K8 / K9 on one lane of the earlier pack; x and out are offset by the
// lane: out [8, N] f wi pdf kind (kind as a float), [4, N] f pdf
HD void sample_packed_lane(const float* x, long n, int types,
                           const ShadeCfg& cfg, float* out) {
  cbounce::Slots b;
  read_packed(x, n, &b);
  V3 f, wi;
  float pdf;
  int kind;
  cbounce::bsdf_sample(b, col3(x, n, PACK_COLS), col(x, n, PACK_COLS + 3),
                       col(x, n, PACK_COLS + 4), cfg, &f, &wi, &pdf, &kind,
                       types);
  out[0] = f.x;
  out[n] = f.y;
  out[2 * n] = f.z;
  out[3 * n] = wi.x;
  out[4 * n] = wi.y;
  out[5 * n] = wi.z;
  out[6 * n] = pdf;
  out[7 * n] = (float)kind;
}

HD void eval_pdf_packed_lane(const float* x, long n, int types,
                             const ShadeCfg& cfg, float* out) {
  cbounce::Slots b;
  read_packed(x, n, &b);
  V3 f;
  float pdf;
  cbounce::bsdf_eval_pdf(b, col3(x, n, PACK_COLS),
                         col3(x, n, PACK_COLS + 3), cfg, &f, &pdf, types);
  out[0] = f.x;
  out[n] = f.y;
  out[2 * n] = f.z;
  out[3 * n] = pdf;
}

// ---------------------------------------------------------------------------
// the material-recipe order
// ---------------------------------------------------------------------------

// The recipe key of a lane: its three slot types, each coded by its
// place in its column's presence set (ShadeCfg pres), a type outside
// the set (T_NONE among them) by the set's size; a column of P types
// has P + 1 codes, so the keys number prod(P_k + 1) <= 11^3.  Lanes of
// one key take one path through each slot's switch.  Plain twin:
// bxdf/slot_shade.py recipe_key_reference.
constexpr int MAX_KEYS = 11 * 11 * 11;
// lanes a block of the order kernels counts and places, in ORDER_RUNS
// runs of ORDER_RUN lanes
constexpr int ORDER_TILE = 1024;
constexpr int ORDER_RUNS = 8;
constexpr int ORDER_RUN = ORDER_TILE / ORDER_RUNS;

HD int popc(unsigned v) {
#ifdef __CUDA_ARCH__
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

HD int column_code(int t, int pres) {
  const bool in = t >= 0 && t <= 9 && ((pres >> t) & 1);
  return in ? popc((unsigned)pres & ((1u << t) - 1u))
            : popc((unsigned)pres);
}

HD int key_count(const ShadeCfg& cfg) {
  int n = 1;
#pragma unroll
  for (int k = 0; k < K; ++k) n *= popc((unsigned)cfg.pres[k]) + 1;
  return n;
}

// the key of the lane whose types start at `type` (its [K] row)
HD int recipe_key(const int* type, const ShadeCfg& cfg) {
  int key = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    key = key * (popc((unsigned)cfg.pres[k]) + 1) +
          column_code(ld(type + k), cfg.pres[k]);
  return key;
}

// The stable counting sort runs over tiles of ORDER_TILE lanes: each
// tile counts its keys into counts[key * tiles + tile]; the first place
// of key k in tile t is the lanes of all tiles with a smaller key plus
// the lanes of key k in the tiles before t; a lane of the tile then
// goes to that place plus the lanes of its key before it in the tile
// (those of the earlier runs, then its rank within its own run).
HD long first_place(const int* counts, int tiles, int tile, int key) {
  long before = 0;
  for (int k = 0; k < key; ++k)
    for (int t = 0; t < tiles; ++t) before += counts[(long)k * tiles + t];
  for (int t = 0; t < tile; ++t) before += counts[(long)key * tiles + t];
  return before;
}

}  // namespace slots
