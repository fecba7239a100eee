// Cluster closest-hit (K1) and shadow any-hit (K2) kernels for Hopper
// (sm_90a).  They replace the Pallas TPU kernels
// arendur_tpu/shapes/pallas_intersect.py::_closest_kernel and
// ::_anyhit_kernel (launched by _run; entries intersect_clusters and
// occluded_clusters), their analytic-sphere branch _sphere_best
// included.
//
// One block of 256 threads takes one 256-ray tile, one thread per ray.
// First the sphere branch: the block stages the S rows of the sphere
// table (w2o(16) radius zmin zmax phimax pad(4), sphere.kernel_table)
// in shared memory, and each live ray tests every sphere in ascending
// order: the world ray goes to the sphere's frame as _sphere_best does
// it (row-layout products, the point multiplied by 1 / w, not divided),
// then the shared local test of the bounce shade
// (cbounce_body.cuh intersect_local_sphere, on float; the phi clip
// skipped where full_phi says every sphere is full), and a hit with
// t < best (strict, so the lowest sphere index wins a tie) seeds the
// running best t and the code -(2+s) (K1), or marks the ray blocked
// (K2).  Then the C clusters of K triangles.  Per cluster each ray
// slab-tests the cluster box against its running best t (any-hit: its
// tmax); a cluster no ray of the block survives is skipped whole, and a
// blocked ray tests no cluster.  The cluster's [16, 4K] determinant
// weights are staged through shared memory 64 triangles at a time
// (16 KB) and every surviving ray forms the four 16-term dot products
// per triangle with explicit FMAs; all threads read the same triangle
// at once, so the shared-memory reads are broadcasts.  Then the epsilon
// accept and, for the closest hit, the lowest-slot tie-break (strict <
// over ascending slots): a triangle replaces a sphere hit only when it
// is strictly closer, so the sphere wins ties.
//
// Bound: 128 FMAs per (ray, triangle) in f32 outside the tensor cores
// (the TPU ran this product on its matrix unit), ~60-90 f32 operations
// per (ray, sphere); memory traffic is the weights (64 KB per cluster
// per block, from L2) plus 36 B per ray.  The slab cull and the
// block-wide skip are what keep the work near the rays that can hit;
// a sphere hit found first bounds the cull.  Rays past n_alive (read
// from device memory, the integrator's compaction count) are misses
// and test nothing, spheres included.  The sphere table takes S * 96 B
// of shared memory beside the 16 KB weight chunk: at most MAX_SPHERES
// rows (the 227 KB a block can hold); a larger table is refused.
#include <cuda_runtime.h>

#include "cbounce.cuh"
#include "intersect.cuh"

namespace {

constexpr int TILE = 256;
constexpr int CHUNK = 64;
constexpr int SPH_COLS = 24;
constexpr int WEIGHT_BYTES = 16 * 4 * CHUNK * (int)sizeof(float);
constexpr int BLOCK_SMEM = 232448;  // the most shared memory of a block
constexpr int DEFAULT_SMEM = 48 * 1024;  // without the opt-in attribute
constexpr int MAX_SPHERES =
    (BLOCK_SMEM - WEIGHT_BYTES) / (SPH_COLS * (int)sizeof(float));

template <bool ANY>
__global__ void __launch_bounds__(TILE)
    cluster_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmax,
                   const float* __restrict__ w,
                   const float* __restrict__ cbox,
                   const int* __restrict__ n_alive_p,
                   const float* __restrict__ sph, int ns, int full_phi,
                   int n, int C, int K, int period,
                   float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ float sw[16 * 4 * CHUNK];
  extern __shared__ float ssph[];
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
  if (ns > 0) {
    for (int idx = threadIdx.x; idx < ns * SPH_COLS; idx += TILE)
      ssph[idx] = sph[idx];
    __syncthreads();
    if (live) {
      cmath::V3 ow = cmath::v3(r.F[0], r.F[1], r.F[2]);
      cmath::V3 dw = cmath::v3(r.F[3], r.F[4], r.F[5]);
      for (int s = 0; s < ns; ++s) {
        const float* m = ssph + SPH_COLS * s;
        cmath::V3 ol = cmath::tp16(m, ow);
        cmath::V3 dl = cmath::tv16(m, dw);
        cmath::V3 p;
        float t;
        bool hit = cbounce::intersect_local_sphere(
            ol, dl, tm, m[16], m[17], m[18], m[19], full_phi != 0, &p, &t);
        if (hit && t < best) {
          best = t;
          bslot = -(2 + s);
        }
      }
      blocked = bslot != -1;
    }
  }
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
           const float* cbox, const int* n_alive, const float* sph, int ns,
           int full_phi, int n, int C, int K, int period, float* t_out,
           int* i_out, void* stream) {
  if (n <= 0) return 0;
  // a sphere table is refused past the shared memory and with batched
  // instancing (the JAX package never passes one there)
  if (K % CHUNK != 0 || ns < 0 || ns > MAX_SPHERES || (ns > 0 && period > 0))
    return (int)cudaErrorInvalidValue;
  const int smem = ns * SPH_COLS * (int)sizeof(float);
  if (smem + WEIGHT_BYTES > DEFAULT_SMEM) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_kernel<ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned grid = (unsigned)((n + TILE - 1) / TILE);
  cluster_kernel<ANY><<<grid, TILE, smem, (cudaStream_t)stream>>>(
      o, d, tmax, w, cbox, n_alive, sph, ns, full_phi, n, C, K, period,
      t_out, i_out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface; returns a cudaError_t code (0 = launched).  sph [ns, 24]
// may be null with ns = 0 (no spheres).
extern "C" int arendur_closest_hit(const float* o, const float* d,
                                   const float* tmax, const float* w,
                                   const float* cbox, const int* n_alive,
                                   const float* sph, int ns, int full_phi,
                                   int n, int C, int K, int period,
                                   float* t_out, int* slot_out,
                                   void* stream) {
  return launch<false>(o, d, tmax, w, cbox, n_alive, sph, ns, full_phi, n, C,
                       K, period, t_out, slot_out, stream);
}

extern "C" int arendur_any_hit(const float* o, const float* d,
                               const float* tmax, const float* w,
                               const float* cbox, const int* n_alive,
                               const float* sph, int ns, int full_phi, int n,
                               int C, int K, int period, int* blocked_out,
                               void* stream) {
  return launch<true>(o, d, tmax, w, cbox, n_alive, sph, ns, full_phi, n, C,
                      K, period, nullptr, blocked_out, stream);
}

extern "C" int arendur_max_spheres() { return MAX_SPHERES; }
