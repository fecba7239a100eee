// Host build of the BSDF slot sweeps' per-lane code (K8 / K9,
// slot_shade.cu), compiled by a host C++ compiler (no nvcc, no card):
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -o libslots.so slot_shade_host.cpp
//
// The in-place lane reader and the sweeps of slot_shade.cuh, K8's
// walked over the lanes in a given order and K9's in wave order, as the
// kernels walk them; the same sweeps over the earlier
// lane-major pack; and the material-recipe order, the stable counting
// sort over tiles of ORDER_TILE lanes that the order kernels run (each
// tile's histogram, each key's first place in each tile, the tile's
// lanes placed in lane order).  kernels/host_slots.py builds and calls
// it; tests/test_torch_slot_host.py holds it against the plain versions.
#include <string.h>

#include <algorithm>
#include <vector>

#include "slot_shade.cuh"

namespace {

cshade::ShadeCfg config(const void* cfg_words) {
  cshade::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  return cfg;
}

}  // namespace

// The in-place sweeps.  K8: u [n,2] -> f, wi [n,3], pdf [n], kind [n],
// lane order[i] shaded i-th (the recipe order); K9: wi [n,3] -> f, pdf,
// in wave order.
extern "C" int arendur_slot_sample_host(
    const float* ns, const float* ts, const float* bs, const float* ng,
    const int* type, const int* kind, const int* dist, const float* c0,
    const float* c1, const float* p0, const float* p1, const float* p2,
    const float* wo, const float* u, const int* order, long n, int types,
    const void* cfg_words, float* f, float* wi, float* pdf, int* kind_out) {
  const slots::Fields p{ns, ts, bs, ng, type, kind, dist,
                        c0, c1, p0, p1, p2};
  const cshade::ShadeCfg cfg = config(cfg_words);
  const slots::Outs o{f, wi, pdf, kind_out};
  for (long i = 0; i < n; ++i)
    slots::sample_lane(p, (long)order[i], wo, u, types, cfg, o);
  return 0;
}

extern "C" int arendur_slot_eval_pdf_host(
    const float* ns, const float* ts, const float* bs, const float* ng,
    const int* type, const int* kind, const int* dist, const float* c0,
    const float* c1, const float* p0, const float* p1, const float* p2,
    const float* wo, const float* wi, long n, int types,
    const void* cfg_words, float* f, float* pdf) {
  const slots::Fields p{ns, ts, bs, ng, type, kind, dist,
                        c0, c1, p0, p1, p2};
  const cshade::ShadeCfg cfg = config(cfg_words);
  const slots::Outs o{f, nullptr, pdf, nullptr};
  for (long lane = 0; lane < n; ++lane)
    slots::eval_pdf_lane(p, lane, wo, wi, types, cfg, o);
  return 0;
}

// The earlier route in wave order: xt [SLOT_COLS + 5 | 6, n] ->
// out [8, n] (sample) or [4, n].
extern "C" int arendur_slot_host_packed(int sample, const float* xt, long n,
                                        int types, const void* cfg_words,
                                        float* out) {
  const cshade::ShadeCfg cfg = config(cfg_words);
  for (long lane = 0; lane < n; ++lane) {
    if (sample)
      slots::sample_packed_lane(xt + lane, n, types, cfg, out + lane);
    else
      slots::eval_pdf_packed_lane(xt + lane, n, types, cfg, out + lane);
  }
  return 0;
}

// The recipe order of n lanes from type [n, K]: keys [n] (recipe_key)
// and order [n], a stable sort of the lanes by key.  Returns the number
// of keys, or -1 where it exceeds MAX_KEYS.
extern "C" int arendur_slot_order_host(const int* type, long n,
                                       const void* cfg_words, int* keys,
                                       int* order) {
  const cshade::ShadeCfg cfg = config(cfg_words);
  const int nkeys = slots::key_count(cfg);
  if (nkeys > slots::MAX_KEYS) return -1;
  const int tiles = (int)((n + slots::ORDER_TILE - 1) / slots::ORDER_TILE);
  for (long lane = 0; lane < n; ++lane)
    keys[lane] = slots::recipe_key(type + slots::K * lane, cfg);
  std::vector<int> counts((size_t)nkeys * tiles, 0);
  for (long lane = 0; lane < n; ++lane)
    ++counts[(size_t)keys[lane] * tiles + lane / slots::ORDER_TILE];
  std::vector<long> place((size_t)nkeys);
  std::vector<int> run((size_t)slots::ORDER_RUNS * nkeys);
  std::vector<int> rank(slots::ORDER_TILE);
  for (int t = 0; t < tiles; ++t) {
    for (int k = 0; k < nkeys; ++k)
      place[k] = slots::first_place(counts.data(), tiles, t, k);
    const long lo = (long)t * slots::ORDER_TILE;
    const long end = std::min(n, lo + slots::ORDER_TILE);
    std::fill(run.begin(), run.end(), 0);
    for (long lane = lo; lane < end; ++lane) {
      const int j = (int)(lane - lo);
      rank[j] = run[(size_t)(j / slots::ORDER_RUN) * nkeys + keys[lane]]++;
    }
    for (int k = 0; k < nkeys; ++k) {
      int before = 0;
      for (int v = 0; v < slots::ORDER_RUNS; ++v) {
        const int h = run[(size_t)v * nkeys + k];
        run[(size_t)v * nkeys + k] = before;
        before += h;
      }
    }
    for (long lane = lo; lane < end; ++lane) {
      const int j = (int)(lane - lo);
      order[place[keys[lane]] +
            run[(size_t)(j / slots::ORDER_RUN) * nkeys + keys[lane]] +
            rank[j]] = (int)lane;
    }
  }
  return nkeys;
}
