// Host build of the cluster closest-hit / any-hit kernels' per-thread
// loop (K1 / K2, intersect.cu), compiled by a host C++ compiler (no
// nvcc, no card):
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -o libisect.so intersect_host.cpp
//
// A block of the kernel holds 32R rays, thread `lane` of each warp the
// rays lane, lane + 32, ...; its warps split each chunk's four-triangle
// groups and merge their results per cluster.  Here each thread's R
// rays run through every group of every chunk in order, with the same
// isect:: pieces the kernel runs: the sphere pass, the per-ray slab
// test of every cluster against the running bound, the float4 groups
// (dets4) and the accept in ascending slot order with the deferred
// division (accept4).  The split, the merges, the block's staging and
// the warps' votes change no ray's result (a ray that does not want a
// cluster accepts nothing in it; the merges keep the least (t, rank)),
// so the host walks every cluster and records, per ray and cluster, the
// chunks the ray needs: kernels/host_isect.py builds and calls it,
// tests/test_torch_isect_host.py holds it against the plain versions,
// tools/isect_cpu_counts.py counts the work of each culling grain.
#include <string.h>

#include "intersect.cuh"

namespace {

using isect::CHUNK;
using isect::GROUP;

template <bool ANY, int R>
void run(const float* o, const float* d, const float* tmax, const float* w,
         const float* cbox, int n_alive, const float* sph, int ns,
         bool full_phi, long n, int C, int K, int period, float* t_out,
         int* i_out, unsigned char* need) {
  const int per = K / CHUNK;
  for (long first = 0; first < n; first += 32 * R) {
    for (int lane = 0; lane < 32; ++lane) {
      isect::Ray ray[R];
      float tm[R], best[R];
      int bslot[R];
      bool live[R], blocked[R], want[R];
      long idx[R];
      for (int r = 0; r < R; ++r) {
        const long i = first + 32 * r + lane;
        const long li = period > 0 ? i % period : i;
        idx[r] = i;
        live[r] = (i < n) && (li < n_alive);
        if (i < n) {
          isect::ray_setup(o + 3 * i, d + 3 * i, &ray[r]);
          tm[r] = tmax[i];
        } else {
          const float z[3] = {0.0f, 0.0f, 0.0f};
          isect::ray_setup(z, z, &ray[r]);
          tm[r] = 0.0f;
        }
        best[r] = tm[r];
        bslot[r] = -1;
        blocked[r] = false;
        if (ns > 0) {
          if (live[r])
            isect::sphere_pass(ray[r], tm[r], sph, ns, full_phi, &best[r],
                               &bslot[r]);
          blocked[r] = bslot[r] != -1;
        }
      }
      for (int c = 0; c < C; ++c) {
        bool mine = false;
        for (int r = 0; r < R; ++r) {
          want[r] = live[r] && !(ANY && blocked[r]) &&
                    isect::slab_hit(ray[r], cbox + 8 * c,
                                    ANY ? tm[r] : best[r]);
          mine |= want[r];
          if (need && idx[r] < n)
            need[idx[r] * C + c] = want[r] ? (unsigned char)per : 0;
        }
        if (!mine) continue;
        const float* wc = w + (long)c * 16 * 4 * K;
        for (int ch = 0; ch < per; ++ch) {
          bool open = !ANY;
          for (int r = 0; r < R; ++r) open |= want[r] && !blocked[r];
          if (!open) break;
          bool was[R];
          for (int r = 0; r < R; ++r) was[r] = blocked[r];
          for (int g = 0; g < CHUNK; g += GROUP) {
            float dq[4][GROUP][R];
            isect::dets4<R>(ray, wc + ch * CHUNK + g, 4 * K, K, dq);
            isect::accept4<ANY, R>(dq, ray, want, tm, c * K + ch * CHUNK + g,
                                   best, bslot, blocked);
          }
          // the any hit: a ray blocked in this chunk needs no later one
          for (int r = 0; r < R; ++r)
            if (ANY && need && want[r] && blocked[r] && !was[r])
              need[idx[r] * C + c] = (unsigned char)(ch + 1);
        }
      }
      for (int r = 0; r < R; ++r) {
        const long i = idx[r];
        if (i >= n) continue;
        if (ANY) {
          i_out[i] = blocked[r] ? 1 : 0;
        } else {
          t_out[i] = bslot[r] == -1 ? tm[r] : best[r];
          i_out[i] = bslot[r];
        }
      }
    }
  }
}

template <bool ANY>
int run_r(int rays_per_thread, const float* o, const float* d,
          const float* tmax, const float* w, const float* cbox, int n_alive,
          const float* sph, int ns, bool full_phi, long n, int C, int K,
          int period, float* t_out, int* i_out, unsigned char* need) {
  switch (rays_per_thread) {
    case 1:
      run<ANY, 1>(o, d, tmax, w, cbox, n_alive, sph, ns, full_phi, n, C, K,
                  period, t_out, i_out, need);
      return 0;
    case 2:
      run<ANY, 2>(o, d, tmax, w, cbox, n_alive, sph, ns, full_phi, n, C, K,
                  period, t_out, i_out, need);
      return 0;
    case 4:
      run<ANY, 4>(o, d, tmax, w, cbox, n_alive, sph, ns, full_phi, n, C, K,
                  period, t_out, i_out, need);
      return 0;
  }
  return -1;
}

// The instanced entries' per-ray loop (intersect.cu instanced_kernel):
// ray n through the instances in ascending order, each tested first by
// its world box against the ray's running bound (the closest hit: its
// best t so far; the any hit: tmax, and only while not blocked), then
// taken into the instance's frame and swept over the mesh's clusters as
// K1 / K2 sweep them (a strict t < best keeps the lowest instance at
// equal t).  The kernel's 32-ray blocks, their warps' split and votes
// change no ray's result, as in `run`.  ibox [n, I] (may be null): 1
// where the ray's world-box test admits the instance; need [n, I, C]
// (may be null): the chunks of K / 64 the ray needs of each cluster of
// each instance (the any hit's stop at the chunk that blocks it).
template <bool ANY>
void run_inst(const float* o, const float* d, const float* bound,
              const float* w, const float* cbox, const float* itab,
              int n_alive, const unsigned char* blocked_in, long n, int C,
              int K, int I, float* t_out, int* i_out, int* inst_out,
              unsigned char* ibox, unsigned char* need) {
  const int per = K / CHUNK;
  const bool want1[1] = {true};
  for (long i = 0; i < n; ++i) {
    const bool live = i < n_alive;
    const float tm = bound[i];
    float best[1] = {tm};
    int bslot[1] = {-1};
    int binst = 0;
    bool blocked[1] = {ANY && live && blocked_in && blocked_in[i] != 0};
    for (int j = 0; j < I; ++j) {
      const float* m = itab + (long)j * isect::ITAB_COLS;
      const bool in = live && !(ANY && blocked[0]) &&
                      isect::slab_hit(o + 3 * i, d + 3 * i,
                                      m + isect::ITAB_BOX,
                                      ANY ? tm : best[0]);
      if (ibox) ibox[i * I + j] = in ? 1 : 0;
      unsigned char* nd = need ? need + (i * I + j) * C : nullptr;
      if (nd) memset(nd, 0, C);
      if (!in) continue;
      float ol[3], dl[3];
      isect::to_instance(m, o + 3 * i, d + 3 * i, ol, dl);
      isect::Ray ray[1];
      isect::ray_setup(ol, dl, &ray[0]);
      const float tm1[1] = {tm};
      for (int c = 0; c < C; ++c) {
        if ((ANY && blocked[0]) ||
            !isect::slab_hit(ray[0], cbox + 8 * c, ANY ? tm : best[0]))
          continue;
        if (nd) nd[c] = (unsigned char)per;
        const float* wc = w + (long)c * 16 * 4 * K;
        const float before = best[0];
        for (int ch = 0; ch < per && !(ANY && blocked[0]); ++ch) {
          for (int g = 0; g < CHUNK; g += GROUP) {
            float dq[4][GROUP][1];
            isect::dets4<1>(ray, wc + ch * CHUNK + g, 4 * K, K, dq);
            isect::accept4<ANY, 1>(dq, ray, want1, tm1,
                                   c * K + ch * CHUNK + g, best, bslot,
                                   blocked);
          }
          if (ANY && nd && blocked[0]) nd[c] = (unsigned char)(ch + 1);
        }
        if (!ANY && best[0] < before) binst = j;
      }
    }
    if (ANY) {
      i_out[i] = blocked[0] ? 1 : 0;
    } else {
      t_out[i] = bslot[0] == -1 ? tm : best[0];
      i_out[i] = bslot[0];
      inst_out[i] = bslot[0] == -1 ? 0 : binst;
    }
  }
}

}  // namespace

// The kernels' arguments in host memory, n_alive by value, any = 0 for
// K1 (t_out, i_out = slot) and 1 for K2 (i_out = blocked, t_out
// unused).  need [n, C] (may be null): the chunks of K / 64 the ray
// needs in each cluster, 0 where it does not enter the cluster's box
// before its bound; the any hit's stop at the chunk that blocked it.
// No clusters (C = 0) is the sphere pass alone.  Returns 0, or -1 for
// arguments the kernels refuse.
extern "C" int arendur_isect_host(int any, int rays_per_thread,
                                  const float* o, const float* d,
                                  const float* tmax, const float* w,
                                  const float* cbox, int n_alive,
                                  const float* sph, int ns, int full_phi,
                                  long n, int C, int K, int period,
                                  float* t_out, int* i_out,
                                  unsigned char* need) {
  if (K <= 0 || K % CHUNK != 0 || K / CHUNK > 255 || C < 0 || ns < 0 ||
      (ns > 0 && period > 0))
    return -1;
  return any ? run_r<true>(rays_per_thread, o, d, tmax, w, cbox, n_alive, sph,
                           ns, full_phi != 0, n, C, K, period, t_out, i_out,
                           need)
             : run_r<false>(rays_per_thread, o, d, tmax, w, cbox, n_alive,
                            sph, ns, full_phi != 0, n, C, K, period, t_out,
                            i_out, need);
}

// The instanced entries (arendur_closest_hit_instanced /
// arendur_any_hit_instanced) in host memory: N world rays, one
// instanced mesh's cluster tables (C clusters of K) and its instance
// table itab [I, ITAB_COLS]; blocked_in [n] (any hit, may be null): the
// world's blocked flags.  The closest hit writes t_out (the bound on a
// miss), slot_out (-1 on a miss) and inst_out (0 on a miss); the any
// hit writes slot_out = blocked.  ibox / need as in run_inst (may be
// null).  Returns 0, or -1 for arguments the kernels refuse.
extern "C" int arendur_isect_inst_host(int any, const float* o,
                                       const float* d, const float* bound,
                                       const float* w, const float* cbox,
                                       const float* itab, int n_alive,
                                       const unsigned char* blocked_in,
                                       long n, int C, int K, int I,
                                       float* t_out,
                                       int* slot_out, int* inst_out,
                                       unsigned char* ibox,
                                       unsigned char* need) {
  if (K <= 0 || K % CHUNK != 0 || K / CHUNK > 255 || C <= 0 || I < 0)
    return -1;
  if (any)
    run_inst<true>(o, d, bound, w, cbox, itab, n_alive, blocked_in, n, C, K,
                   I, t_out, slot_out, inst_out, ibox, need);
  else
    run_inst<false>(o, d, bound, w, cbox, itab, n_alive, blocked_in, n, C,
                    K, I, t_out, slot_out, inst_out, ibox, need);
  return 0;
}
