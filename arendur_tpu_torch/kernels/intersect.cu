// Cluster closest-hit (K1) and shadow any-hit (K2) kernels for Hopper
// (sm_90a).  They replace the Pallas TPU kernels
// arendur_tpu/shapes/pallas_intersect.py::_closest_kernel and
// ::_anyhit_kernel (launched by _run; entries intersect_clusters and
// occluded_clusters).
//
// One block of 256 threads takes one 256-ray tile, one thread per ray,
// and loops over the C clusters of K triangles.  Per cluster each ray
// slab-tests the cluster box against its running best t (any-hit: its
// tmax); a cluster no ray of the block survives is skipped whole.  The
// cluster's [16, 4K] determinant weights are staged through shared
// memory 64 triangles at a time (16 KB) and every surviving ray forms
// the four 16-term dot products per triangle with explicit FMAs; all
// threads read the same triangle at once, so the shared-memory reads
// are broadcasts.  Then the epsilon accept and, for the closest hit,
// the lowest-slot tie-break (strict < over ascending slots).
//
// Bound: 128 FMAs per (ray, triangle) in f32 outside the tensor cores
// (the TPU ran this product on its matrix unit); memory traffic is the
// weights (64 KB per cluster per block, from L2) plus 36 B per ray.  The
// slab cull and the block-wide skip are what keep the work near the
// rays that can hit.  Rays past n_alive (read from device memory, the
// integrator's compaction count) are misses and never test.
#include <cuda_runtime.h>

#include "intersect.cuh"

namespace {

constexpr int TILE = 256;
constexpr int CHUNK = 64;

template <bool ANY>
__global__ void __launch_bounds__(TILE)
    cluster_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmax,
                   const float* __restrict__ w,
                   const float* __restrict__ cbox,
                   const int* __restrict__ n_alive_p, int n, int C, int K,
                   int period, float* __restrict__ t_out,
                   int* __restrict__ i_out) {
  __shared__ float sw[16 * 4 * CHUNK];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int n_alive = *n_alive_p;
  const int li = period > 0 ? i % period : i;
  const bool live = (i < n) && (li < n_alive);
  isect::Ray r;
  float tm = 0.0f;
  if (i < n) {
    isect::ray_setup(o + 3 * (long)i, d + 3 * (long)i, &r);
    tm = tmax[i];
  } else {
    float z[3] = {0.0f, 0.0f, 0.0f};
    isect::ray_setup(z, z, &r);
  }
  float best = tm;
  int bslot = -1;
  bool blocked = false;
  const int K4 = 4 * K;
  for (int c = 0; c < C; ++c) {
    const float bound = ANY ? tm : best;
    bool box = live && isect::slab_hit(r, cbox + 8 * c, bound);
    bool want = ANY ? (box && !blocked) : box;
    if (!__syncthreads_or(want)) continue;
    const float* wc = w + (long)c * 16 * K4;
    for (int ch = 0; ch < K; ch += CHUNK) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < 16 * 4 * CHUNK; idx += TILE) {
        int f = idx / (4 * CHUNK);
        int rem = idx % (4 * CHUNK);
        int q = rem / CHUNK;
        int kk = rem % CHUNK;
        sw[idx] = wc[(long)f * K4 + q * K + ch + kk];
      }
      __syncthreads();
      if (!want) continue;
      for (int kk = 0; kk < CHUNK; ++kk) {
        const float* col = sw + kk;
        float det = isect::dot16(r, col + 0 * CHUNK, 4 * CHUNK);
        float tdet = isect::dot16(r, col + 1 * CHUNK, 4 * CHUNK);
        float udet = isect::dot16(r, col + 2 * CHUNK, 4 * CHUNK);
        float vdet = isect::dot16(r, col + 3 * CHUNK, 4 * CHUNK);
        float t;
        if (ANY) {
          if (isect::accept(det, tdet, udet, vdet, r.teps, tm, &t))
            blocked = true;
        } else if (isect::accept(det, tdet, udet, vdet, r.teps, best, &t)) {
          best = t;
          bslot = c * K + ch + kk;
        }
      }
    }
  }
  if (i >= n) return;
  if (ANY) {
    i_out[i] = blocked ? 1 : 0;
  } else {
    t_out[i] = bslot == -1 ? tm : best;
    i_out[i] = bslot;
  }
}

template <bool ANY>
int launch(const float* o, const float* d, const float* tmax, const float* w,
           const float* cbox, const int* n_alive, int n, int C, int K,
           int period, float* t_out, int* i_out, void* stream) {
  if (n <= 0) return 0;
  if (K % CHUNK != 0) return (int)cudaErrorInvalidValue;
  unsigned grid = (unsigned)((n + TILE - 1) / TILE);
  cluster_kernel<ANY><<<grid, TILE, 0, (cudaStream_t)stream>>>(
      o, d, tmax, w, cbox, n_alive, n, C, K, period, t_out, i_out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface; returns a cudaError_t code (0 = launched).
extern "C" int arendur_closest_hit(const float* o, const float* d,
                                   const float* tmax, const float* w,
                                   const float* cbox, const int* n_alive,
                                   int n, int C, int K, int period,
                                   float* t_out, int* slot_out,
                                   void* stream) {
  return launch<false>(o, d, tmax, w, cbox, n_alive, n, C, K, period, t_out,
                       slot_out, stream);
}

extern "C" int arendur_any_hit(const float* o, const float* d,
                               const float* tmax, const float* w,
                               const float* cbox, const int* n_alive, int n,
                               int C, int K, int period, int* blocked_out,
                               void* stream) {
  return launch<true>(o, d, tmax, w, cbox, n_alive, n, C, K, period, nullptr,
                      blocked_out, stream);
}
