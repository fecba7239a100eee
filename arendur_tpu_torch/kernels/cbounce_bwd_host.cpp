// Host build of the bounce-shade backward's per-lane code (K4,
// cbounce_bwd.cu): the classifier, the pass-through and cbody_lane_bwd
// on the 16-byte tape records, compiled by a host C++ compiler (no
// nvcc, no card), walking the lanes in order on one host tape:
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -o libk4.so cbounce_bwd_host.cpp
//
// kernels/host_bwd.py builds and calls it; tests/test_torch_k4_host.py
// holds it against the plain VJP (render/cbounce.py
// cbody_vjp_reference).  The table cotangents are summed in lane order,
// one lane at a time.
#include <string.h>

#include <vector>

#include "cbounce_ad.cuh"

// The arguments of arendur_bounce_shade_bwd (host memory, n_alive a
// plain count), less its scratch; dlt / dmt / dst are overwritten.  need [n]: 1 where the
// lane's VJP needed the body; nodes [n]: the tape nodes the lane
// recorded (0 for a lane that needed no body).  Returns the number of
// lanes that ran past cap (their dx and table shares are NaN).
extern "C" int arendur_bounce_shade_bwd_host(
    const float* xt, const float* ct, const float* ltab, int nl, int cl,
    const float* mtab, int nm, const float* stab, int ns, long n,
    long n_alive, const void* cfg_words, int cap, float* dx, float* dlt, float* dmt,
    float* dst, int* need, int* nodes) {
  cshade::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  std::vector<ad::Node> tape((size_t)cap);
  ad::h_tape.node = tape.data();
  ad::h_tape.stride = 1;
  ad::h_tape.cap = cap;
  const cshade::Tables tb =
      cshade::dense_tables(ltab, nl, cl, mtab, nm, stab, ns);
  const cbounce_ad::TabLayout lay(nl, cl, nm, ns);
  float* dtab[cshade::N_ROW_SLOTS] = {dmt, dlt, dlt, dst};
  memset(dmt, 0, sizeof(float) * nm * 16);
  memset(dlt, 0, sizeof(float) * nl * cl);
  memset(dst, 0, sizeof(float) * ns * 24);
  std::vector<float> share((size_t)lay.base[cshade::N_ROW_SLOTS]);
  int failed = 0;
  for (long lane = 0; lane < n; ++lane) {
    ad::h_count = 0;
    need[lane] =
        cbounce_ad::needs_body(xt + lane, ct + lane, n, lane, n_alive, tb);
    if (!need[lane]) {
      cbounce_ad::pass_through(ct + lane, n, dx + lane);
      nodes[lane] = ad::h_count;
      continue;
    }
    for (float& v : share) v = 0.0f;
    int rows[cshade::N_ROW_SLOTS];
    failed += !cbounce_ad::cbody_lane_bwd(xt + lane, ct + lane, n, tb, cfg,
                                          dx + lane, share.data(), lay.base,
                                          rows);
    nodes[lane] = ad::h_count;
    for (int s = 0; s < cshade::N_ROW_SLOTS; ++s) {
      const int ncols = lay.base[s + 1] - lay.base[s];
      for (int c = 0; c < ncols; ++c)
        dtab[s][rows[s] * ncols + c] += share[lay.base[s] + c];
    }
  }
  return failed;
}
