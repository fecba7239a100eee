// Cluster closest-hit (K1) and shadow any-hit (K2) kernels for Hopper
// (sm_90a).  They replace the Pallas TPU kernels
// arendur_tpu/shapes/pallas_intersect.py::_closest_kernel and
// ::_anyhit_kernel (launched by _run; entries intersect_clusters and
// occluded_clusters), their analytic-sphere branch _sphere_best
// included.
//
// Work and bound.  A (ray, triangle) pair is four 16-term dot products
// of the ray's features with the triangle's determinant weights: 64
// FMAs, 128 flops, in f32 outside the tensor cores (the TPU ran this
// product on its matrix unit), then the epsilon accept (~15 f32
// operations; the reciprocal only for the few pairs that pass the sign
// and barycentric tests).  A (ray, sphere) pair is ~60-90 operations.
// Bytes are small: 36 B per ray and the cluster weights (64 KB per
// cluster at K = 256, read from the L2 by every block that needs
// them).  So the bound is f32 issue on the pairs the rays need: the
// clusters whose box a ray enters before its bound.  What kept the
// first version (one ray a thread, 256-ray blocks) far from it, and
// what this design does about each:
//  - one shared-memory load per FMA (a scalar broadcast per feature and
//    triangle, a quarter of the FMA rate): a group of four triangles is
//    swept at once, and one 16-byte broadcast load of feature f,
//    quantity q carries the weights of four triangles into 4R FMAs for
//    the R rays a thread holds (the next feature's loads issued before
//    this one's FMAs);
//  - staging that nothing overlapped (16 scalar loads and two
//    __syncthreads per 64-triangle chunk): chunks reach shared memory
//    through a ring of STAGES buffers filled by the Tensor Memory
//    Accelerator, one request per chunk (cp.async.bulk.tensor over a 2-D
//    descriptor of the weights seen as [C * 64, K]: the chunk is one
//    64 x 64 box; 64 row copies of 256 B per chunk measured request-bound),
//    issued by warp 0 with the chunk's tag, each stage completing on a
//    "full" mbarrier and released through an "empty" mbarrier that every
//    warp arrives on, so the next chunks load while the warps compute
//    and no block-wide barrier runs per chunk; the next cluster staged
//    is the next one some ray wants at the block's bounds then;
//  - culling per 256-ray block: a block holds 32R rays, each
//    slab-tested per cluster and voted on per warp; a cluster no ray
//    wants is neither staged nor swept, and the any hit leaves a
//    cluster at the next chunk once every ray that wanted it is blocked;
//  - one warp's serial sweep: a block's W warps hold the same rays and
//    split every chunk's 16 groups, so a launch with few live rays (the
//    late bounces: 2.8k-30k rays) spreads its sweep over W times the
//    warps and more SMs; the closest hit merges the warps' best per
//    cluster (one barrier), the any hit shares its blocked flags in
//    shared memory;
//  - the division on every pair: taken only where the pair passes
//    (isect::accept);
//  - tiles past n_alive: a block none of whose rays is live writes its
//    misses and exits before it loads or stages anything.
// A ray that does not want a cluster accepts nothing in it, even where
// its warp computes, so every ray's result is that of the one-ray loop:
// per ray, the spheres in ascending order, then the clusters in
// ascending order, each slab-tested against the ray's running best t
// (any hit: its tmax) and swept in ascending slot order with a strict
// t < best.  The lowest slot wins a tie, a sphere wins a tie with a
// triangle, the lowest sphere index wins among spheres (the merges keep
// the least (t, rank)); t and slot are the same to the bit as the
// one-ray kernel's (each determinant is the same fmaf chain over
// f = 0..15).
//
// Launch shape: R = 1 ray a thread, W = 8 warps a block (32 rays: 2,048
// blocks for a 65,536-ray wave), STAGES = 3 chunks of 64 triangles
// (48 KB) in flight.  Measured on one H100 (PERF.md), R = 1 beats R = 2
// and 4 on the main path's queries: a block of 32 rays culls at a finer
// grain and holds fewer registers (80: three blocks, 24 warps an SM),
// and W = 8 beats W = 4 on the small late launches; 2 or 4 stages
// change nothing.  chip_smoke.py phase 2 reports the registers (ptxas),
// the shared memory and the blocks per SM (arendur_isect_occupancy).
// What bounds them now (one H100, PERF.md; per fused wave of cb.json by
// queued events): K1 ~1.2 ms over 9 launches, K2 ~0.83 ms over 8 (the
// first version 5.1 and 3.8).  Of K1's, ~0.32 ms is the ring and block
// set-up (the kernel with its sweep taken out) and ~0.86 ms the sweep,
// at ~35 % of the f32 FMA rate on the pairs its 32-ray blocks compute,
// which are 1.9-3.2x the pairs its rays need after the camera bounce;
// the accept ~0.03 ms.  K2's blocks compute 4.2-5.1x the pairs their
// rays need (a block's shadow rays aim at two lights).  Neither is bound
// by bytes: the culling grain and the FMA loop's issue rate bound both;
// per-cluster ray lists (ROADMAP Queue 2b) would address the first.
//
// Tensor cores are not used: the product's reduction depth is 16, the
// accept after it runs on the CUDA cores whatever computes the product,
// and a 3xTF32 mma would round every determinant differently, so slots
// would no longer match the plain version lane for lane.  The next step,
// once this loop spends its time in FMAs, is 3xTF32 (ROADMAP Queue 2b).
//
// Shared memory: the sphere table (S rows of 96 B) is staged and tested
// first, in consecutive chunks of at most SPH_CHUNK = 512 rows (the
// ring's 48 KB) with a barrier between chunks (warp v the spheres v,
// v + W, ... of each); its space then holds the ring.  So a block takes
// the same 53,504 B whatever the table's size, and a table of any size
// is taken (the JAX package's _sphere_best unrolls over any count).  A
// table of up to 512 rows is one chunk.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

#include "intersect.cuh"

namespace {

using isect::CHUNK;
using isect::GROUP;
using isect::SPH_COLS;

constexpr int R = 1;  // rays a thread
constexpr int W = 8;  // warps a block
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = 16 * 4 * CHUNK;
constexpr int STAGE_BYTES = STAGE_FLOATS * (int)sizeof(float);
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BLOCK_SMEM = 232448;  // the most shared memory of a block
// the sphere rows the ring's space holds: the sphere pass stages and
// tests a table in chunks of this many
constexpr int SPH_CHUNK = RING_BYTES / (SPH_COLS * (int)sizeof(float));
static_assert(SPH_CHUNK % W == 0, "a chunk starts at a multiple of W");
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(b))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(saddr(b)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the completion of the barrier's phase of this parity; a
// wait of more than WAIT_TRAP_CYCLES (seconds) traps, so that a fault
// in the ring fails the launch instead of hanging the card
constexpr long long WAIT_TRAP_CYCLES = 1ll << 35;

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  if (mbar_try(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(b, parity))
    if (clock64() - t0 > WAIT_TRAP_CYCLES) __trap();
}

// one TMA request: the 64 x 64 box at column x, row y of the tensor map
// into dst, completing on bar
__device__ __forceinline__ void tile_load(float* dst, const CUtensorMap* map,
                                          int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(saddr(bar))
      : "memory");
}

// The order of two results at equal t: the spheres by index, then the
// triangles by slot, then no hit (the order in which the one-ray loop
// meets them; it keeps the first at equal t)
__device__ __forceinline__ int rank(int code) {
  return code >= 0 ? (1 << 24) + code : (code == -1 ? INT_MAX : -2 - code);
}

// The block's W warps hold the same rays and split the work; each
// keeps its own (best, bslot), and this merges them: every warp writes
// its own to the partials buffer `part` ([W][32R] t, then [W][32R]
// codes) and reads all W, keeping the least (t, rank).  One barrier:
// the callers alternate between two buffers.
__device__ __forceinline__ void merge_best(float (&best)[R], int (&bslot)[R],
                                           float* part, int warp, int lane) {
  int* code = reinterpret_cast<int*>(part + W * 32 * R);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    part[warp * 32 * R + 32 * r + lane] = best[r];
    code[warp * 32 * R + 32 * r + lane] = bslot[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t = part[32 * r + lane];
    int c = code[32 * r + lane];
    for (int v = 1; v < W; ++v) {
      const float tv = part[v * 32 * R + 32 * r + lane];
      const int cv = code[v * 32 * R + 32 * r + lane];
      if (tv < t || (tv == t && rank(cv) < rank(c))) {
        t = tv;
        c = cv;
      }
    }
    best[r] = t;
    bslot[r] = c;
  }
}

// The block's dynamic shared memory: the mbarriers, the stages' tags,
// two partials buffers and the any hit's blocked flags first, then
// (from a 128-byte boundary) the ring, whose space first holds the
// sphere table.
constexpr int PART_FLOATS = 2 * W * 32 * R;  // t and codes
constexpr int FIXED_BYTES =
    (2 * STAGES * 8 + STAGES * 4 + 2 * PART_FLOATS * 4 + 32 * R * 4 + 127) /
    128 * 128;
static_assert(FIXED_BYTES + RING_BYTES <= BLOCK_SMEM,
              "the ring fits beside the fixed part");

template <bool ANY>
__global__ void __launch_bounds__(32 * W)
    cluster_kernel(const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmax,
                   const float* __restrict__ cbox,
                   const int* __restrict__ n_alive_p,
                   const float* __restrict__ sph, int ns, int full_phi,
                   int n, int C, int K, int period,
                   float* __restrict__ t_out, int* __restrict__ i_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* tags = reinterpret_cast<int*>(empty + STAGES);
  float* parts = reinterpret_cast<float*>(tags + STAGES);
  int* flags = reinterpret_cast<int*>(parts + 2 * PART_FLOATS);
  float* ring = reinterpret_cast<float*>(smem + FIXED_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the block's 32R rays, thread `lane` of every warp holding the rays
  // lane, lane + 32, ...
  const long base = (long)blockIdx.x * (32 * R) + lane;
  const int n_alive = *n_alive_p;
  bool live[R];
  bool any_live = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long i = base + 32 * r;
    const long li = period > 0 ? i % period : i;
    live[r] = (i < n) && (li < n_alive);
    any_live |= live[r];
  }
  // every warp holds the same rays, so the vote is the block's
  if (!__any_sync(FULL_MASK, any_live)) {
    // a dead tile: misses, nothing loaded or staged
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long i = base + 32 * r;
      if (warp != 0 || i >= n) continue;
      if (ANY) {
        i_out[i] = 0;
      } else {
        t_out[i] = tmax[i];
        i_out[i] = -1;
      }
    }
    return;
  }
  isect::Ray ray[R];
  float tm[R], best[R];
  int bslot[R];
  bool blocked[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long i = base + 32 * r;
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
  }
  int part = 0;  // the partials buffer of the next merge
  if (ns > 0) {
    // the table in chunks of at most SPH_CHUNK rows, each staged into the
    // ring's space once the warps are done with the one before; warp v
    // tests the spheres v, v + W, ... (SPH_CHUNK is a multiple of W, so
    // each warp meets its spheres in ascending order across the chunks);
    // the merge keeps the least t and the lowest index at equal t, as
    // the one-ray loop does
    for (int s0 = 0; s0 < ns; s0 += SPH_CHUNK) {
      const int s1 = ns - s0 < SPH_CHUNK ? ns : s0 + SPH_CHUNK;
      if (s0 > 0) __syncthreads();
      for (int k = threadIdx.x; k < (s1 - s0) * SPH_COLS; k += 32 * W)
        ring[k] = sph[(long)s0 * SPH_COLS + k];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r])
          for (int s = s0 + warp; s < s1; s += W)
            isect::sphere_pass(ray[r], tm[r], ring + (s - s0) * SPH_COLS, 1,
                               full_phi != 0, &best[r], &bslot[r], s);
    }
    merge_best(best, bslot, parts, warp, lane);
    part = 1;
#pragma unroll
    for (int r = 0; r < R; ++r) blocked[r] = bslot[r] != -1;
  }
  if (warp == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) flags[32 * r + lane] = blocked[r];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the sphere rows were written through the generic proxy; the ring is
  // written by the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // Whether ray r wants cluster c: it is live (the any hit: and not
  // blocked, by this warp or another) and enters the box before its
  // bound.  Bounds only shrink, so a cluster no ray wants now is not
  // wanted later.
  auto wants = [&](int r, int c) {
    if (ANY) blocked[r] |= *(volatile int*)(flags + 32 * r + lane) != 0;
    return live[r] && !(ANY && blocked[r]) &&
           isect::slab_hit(ray[r], cbox + 8 * c, ANY ? tm[r] : best[r]);
  };
  // The ring's producer is warp 0: item i is chunk `ch` of cluster `pc`,
  // loaded into stage i % STAGES once every warp has released that
  // stage's previous item, its tag (pc * per + ch, or -1 after the last
  // cluster) written beside it.  The next cluster staged is the next one
  // some ray of the block wants at warp 0's bounds then (a closest hit's
  // bounds merged up to the clusters swept so far, so a superset of what
  // the warps will want when they reach it).  With no clusters (C = 0)
  // the first item is the end tag: no request is issued.
  const int per = K / CHUNK;
  auto next_wanted = [&](int c) {
    for (++c; c < C; ++c) {
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) any |= wants(r, c);
      if (__any_sync(FULL_MASK, any)) break;
    }
    return c;
  };
  int pc = 0, pch = 0, pi = 0;
  bool pdone = false;
  auto produce = [&]() {
    const int s = pi % STAGES;
    if (pi >= STAGES) mbar_wait(empty + s, ((pi / STAGES) - 1) & 1);
    ++pi;
    if (pc >= C) {
      if (lane == 0) {
        tags[s] = -1;
        mbar_arrive(full + s);
      }
      pdone = true;
      return;
    }
    if (lane == 0) {
      // the chunk is the box of rows (pc, f, q) = 64 pc .. 64 pc + 63 of
      // the weights seen as [C * 64, K], columns pch * CHUNK ..
      tags[s] = pc * per + pch;
      mbar_expect(full + s, STAGE_BYTES);
      tile_load(ring + s * STAGE_FLOATS, &wmap, pch * CHUNK, pc * 64,
                full + s);
    }
    if (++pch == per) {
      pch = 0;
      pc = next_wanted(pc);
    }
  };
  if (warp == 0) {
    pc = next_wanted(-1);
    while (pi < STAGES - 1 && !pdone) produce();
  }

  // warp v sweeps the groups [v G / W, (v + 1) G / W) of every chunk
  constexpr int GROUPS = CHUNK / GROUP;
  static_assert(GROUPS % W == 0, "the warps split a chunk's groups evenly");
  const int g0 = warp * (GROUPS / W) * GROUP;
  bool want[R];
  bool warp_wants = false, swept = false;
  for (int item = 0;; ++item) {
    if (warp == 0 && !pdone) produce();
    const int s = item % STAGES;
    mbar_wait(full + s, (item / STAGES) & 1);
    const int tag = tags[s];
    if (tag < 0) break;
    const int c = tag / per, ch = tag % per;
    if (ch == 0) {
      // a closest hit's bounds are the same in every warp (merged after
      // each cluster swept), so is its vote
      bool mine = false;
#pragma unroll
      for (int r = 0; r < R; ++r) mine |= want[r] = wants(r, c);
      swept = warp_wants = __any_sync(FULL_MASK, mine);
    } else if (ANY && warp_wants) {
      // leave once every ray that wants the cluster is blocked, by this
      // warp or another
      bool open = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        blocked[r] |= *(volatile int*)(flags + 32 * r + lane) != 0;
        open |= want[r] && !blocked[r];
      }
      warp_wants = __any_sync(FULL_MASK, open);
    }
    if (warp_wants) {
      const float* stage = ring + s * STAGE_FLOATS;
      const int slot0 = c * K + ch * CHUNK;
#pragma unroll 1
      for (int g = g0; g < g0 + (GROUPS / W) * GROUP; g += GROUP) {
        float dq[4][GROUP][R];
        isect::dets4<R>(ray, stage + g, 4 * CHUNK, CHUNK, dq);
        isect::accept4<ANY, R>(dq, ray, want, tm, slot0 + g, best, bslot,
                               blocked);
      }
      if (ANY)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (blocked[r]) flags[32 * r + lane] = 1;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (!ANY && swept && ch == per - 1) {
      merge_best(best, bslot, parts + part * PART_FLOATS, warp,
                       lane);
      part ^= 1;
    }
  }
  if (ANY) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) blocked[r] = flags[32 * r + lane] != 0;
  }
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long i = base + 32 * r;
    if (i >= n) continue;
    if (ANY) {
      i_out[i] = blocked[r] ? 1 : 0;
    } else {
      t_out[i] = bslot[r] == -1 ? tm[r] : best[r];
      i_out[i] = bslot[r];
    }
  }
}

// the dynamic shared memory of a block: the fixed part, then the ring,
// whose space first holds the sphere table's chunks (whatever the
// table's size)
constexpr int SMEM_BYTES = FIXED_BYTES + RING_BYTES;

// allow the kernel `smem` bytes of dynamic shared memory
template <bool ANY>
cudaError_t allow_smem(int smem) {
  static int opted = 48 * 1024;  // allowed so far
  if (smem <= opted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel<ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) opted = smem;
  return e;
}

struct Args {
  CUtensorMap wmap;
  const float *o, *d, *tmax, *w, *cbox;
  const int* n_alive;
  const float* sph;
  int ns, full_phi, n, C, K, period;
  float* t_out;
  int* i_out;
  void* stream;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The TMA descriptor of the weights w [C, 16, 4K] seen as a 2-D tensor
// of C * 64 rows (cluster, feature, quantity) of K floats, read in
// boxes of 64 rows x CHUNK columns: one chunk of one cluster.  It
// depends on (w, C, K) alone, so the last MAP_CACHE encoded are kept,
// the oldest replaced first: a wave's launches on one scene, which
// alternate between the world's weights and each instanced mesh's,
// encode each once.  `encodes` counts the encodings since the library
// was loaded.
constexpr int MAP_CACHE = 8;
long long encodes = 0;

cudaError_t weight_map(const float* w, int C, int K, CUtensorMap* map) {
  struct Entry {
    const float* w;
    int C, K;
    CUtensorMap map;
  };
  static std::mutex lock;
  static EncodeTiled encode = nullptr;
  static Entry cache[MAP_CACHE];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].w == w && cache[i].C == C && cache[i].K == K) {
      *map = cache[i].map;
      return cudaSuccess;
    }
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dim[2] = {(cuuint64_t)K, (cuuint64_t)C * 64};
  const cuuint64_t stride[1] = {(cuuint64_t)K * sizeof(float)};
  const cuuint32_t box[2] = {CHUNK, 64};
  const cuuint32_t step[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<float*>(w), dim, stride, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  ++encodes;
  cache[next] = Entry{w, C, K, *map};
  next = (next + 1) % MAP_CACHE;
  if (used < MAP_CACHE) ++used;
  return cudaSuccess;
}

template <bool ANY>
int launch(Args a) {
  if (a.n <= 0) return 0;
  // a sphere table is refused with batched instancing (the JAX package
  // never passes one there); the TMA descriptor needs 16-byte aligned
  // weights.  No clusters (C = 0, an empty world pool) is the sphere
  // branch alone: the ring stages nothing, so no descriptor is encoded
  if (a.K <= 0 || a.K % CHUNK != 0 || a.C < 0 || a.ns < 0 ||
      (a.ns > 0 && a.period > 0) || (a.C > 0 && ((uintptr_t)a.w & 15) != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (a.C > 0) {
    e = weight_map(a.w, a.C, a.K, &a.wmap);
    if (e != cudaSuccess) return (int)e;
  }
  e = allow_smem<ANY>(SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((a.n + 32L * R - 1) / (32L * R));
  cluster_kernel<ANY><<<grid, 32 * W, SMEM_BYTES, (cudaStream_t)a.stream>>>(
      a.wmap, a.o, a.d, a.tmax, a.cbox, a.n_alive, a.sph, a.ns, a.full_phi,
      a.n, a.C, a.K, a.period, a.t_out, a.i_out);
  return (int)cudaGetLastError();
}

template <bool ANY>
int occupancy() {
  int blocks = 0;
  cudaError_t e = allow_smem<ANY>(SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, cluster_kernel<ANY>, 32 * W, SMEM_BYTES);
  return e == cudaSuccess ? blocks : -(int)e;
}

// ---------------------------------------------------------------------------
// The instanced entries: N world rays against one instanced mesh.
//
// They replace the Pallas kernels with `period` (pallas_intersect.py:
// 161-166, 213-215) and the JAX package's [I * N]-lane batch around them
// (arendur_tpu/scene.py:780-792, 945-966, 1112-1121: every ray taken
// into all I frames by a batched product, one lane per (instance, ray)
// pair, then an argmin over the instances).  Here a block holds 32 world
// rays, one a thread, shared by its W warps as in cluster_kernel, and
// walks the instances in ascending order inside the kernel; the ray's
// best (t, slot, instance) stays in registers across them, so nothing of
// size [I * N] is written.
//  - Whole instances are culled: an instance table row (intersect.cuh
//    ITAB_COLS) holds w2o's 12 affine floats and the instance's padded
//    world box; each ray slab-tests the box against its running bound
//    (the any hit: tmax, while not blocked) and the warp votes.  An
//    instance no ray of the block wants is neither transformed, staged
//    nor swept.  The first ITAB_STAGED rows are staged in shared memory
//    beside the ring, the rest are read from global memory.
//  - The frame transform happens in registers: a wanted instance's
//    local o, d come from the row by isect::to_instance (scene.affine's
//    products and sums, each rounded once), then isect::ray_setup.
//  - The cluster sweep is cluster_kernel's: the ring's items are
//    (instance, cluster, chunk) in ascending order over the one copy of
//    the mesh's weights (one descriptor for all instances; the chunks
//    stay L2-resident after the first instance), the stages' parity and
//    tags carrying on from one instance to the next.  Warp 0 produces:
//    the next item is the next cluster some ray wants of the next
//    instance some ray wants, at warp 0's bounds then (a superset of
//    what the warps want when they reach it, as in cluster_kernel).
//  - The closest hit keeps the least t, the lowest slot within an
//    instance (merge_best per cluster swept) and the lowest instance at
//    equal t (a later instance replaces the best only when strictly
//    closer: torch.argmin's first minimum over the old route's [I, N]).
//  - The any hit starts from the world's blocked flags (those rays cost
//    nothing), a ray leaves the walk at the first instance that blocks
//    it, and a warp leaves a cluster once every ray that wanted it is
//    blocked.
// Every ray's result is the per-ray loop's (intersect_host.cpp
// run_inst): the instances in order, each admitted by its world box at
// the ray's running bound, then cluster_kernel's loop on the local ray.
// The box is padded (scene.instance_table), so the cull drops no hit
// and the result is also the plain version's, which culls nothing.
// Bound: the f32 operations of the (ray, instance, triangle) triples
// the rays need (128 each), or the rays' bytes where few are needed.
// ---------------------------------------------------------------------------

using isect::ITAB_COLS;
// the instance rows a block stages in shared memory (20 KB: three
// blocks an SM still fit); the rows past them are read from global
// memory
constexpr int ITAB_STAGED = 256;

int inst_smem_bytes(int ni) {
  const int staged = ni < ITAB_STAGED ? ni : ITAB_STAGED;
  return FIXED_BYTES + RING_BYTES + staged * ITAB_COLS * (int)sizeof(float);
}

template <bool ANY>
__global__ void __launch_bounds__(32 * W)
    instanced_kernel(const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ bound,
                     const float* __restrict__ cbox,
                     const float* __restrict__ itab,
                     const int* __restrict__ n_alive_p,
                     const unsigned char* __restrict__ blocked_in, int n,
                     int C, int K, int I, float* __restrict__ t_out,
                     int* __restrict__ i_out, int* __restrict__ inst_out,
                     unsigned char* __restrict__ b_out) {
  static_assert(R == 1, "one world ray a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* tags = reinterpret_cast<int*>(empty + STAGES);
  float* parts = reinterpret_cast<float*>(tags + STAGES);
  int* flags = reinterpret_cast<int*>(parts + 2 * PART_FLOATS);
  float* ring = reinterpret_cast<float*>(smem + FIXED_BYTES);
  float* tab = ring + STAGES * STAGE_FLOATS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long i = (long)blockIdx.x * 32 + lane;
  const bool live = i < n && i < *n_alive_p;
  if (!__any_sync(FULL_MASK, live)) {
    // a dead tile: misses, nothing loaded or staged
    if (warp != 0 || i >= n) return;
    if (ANY) {
      b_out[i] = 0;
    } else {
      t_out[i] = bound[i];
      i_out[i] = -1;
      inst_out[i] = 0;
    }
    return;
  }
  float ow[3] = {0.0f, 0.0f, 0.0f}, dw[3] = {0.0f, 0.0f, 0.0f};
  float tm[R] = {0.0f};
  if (i < n) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ow[a] = o[3 * i + a];
      dw[a] = d[3 * i + a];
    }
    tm[0] = bound[i];
  }
  float best[R] = {tm[0]};
  int bslot[R] = {-1};
  int binst = 0;
  bool blocked[R] = {ANY && live && blocked_in && blocked_in[i] != 0};
  const int staged = I < ITAB_STAGED ? I : ITAB_STAGED;
  for (int k = threadIdx.x; k < staged * ITAB_COLS / 4; k += 32 * W)
    reinterpret_cast<float4*>(tab)[k] =
        __ldg(reinterpret_cast<const float4*>(itab) + k);
  auto row = [&](int j) -> const float* {
    return j < ITAB_STAGED ? tab + j * ITAB_COLS : itab + (long)j * ITAB_COLS;
  };
  if (warp == 0) flags[lane] = blocked[0];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The ray's running bound, its blocked flag as any warp has set it,
  // and whether its world-box test admits instance j
  auto bnd = [&]() { return ANY ? tm[0] : best[0]; };
  auto refresh = [&]() {
    if (ANY) blocked[0] |= *(volatile int*)(flags + lane) != 0;
  };
  auto admits = [&](int j) {
    refresh();
    return live && !(ANY && blocked[0]) &&
           isect::slab_hit(ow, dw, row(j) + isect::ITAB_BOX, bnd());
  };
  // The producer (warp 0): instance pj (the rays' local o / d in pol /
  // pdl, pin its admission), cluster pc, chunk pch, item pi.
  const int per = K / CHUNK;
  int pj = -1, pc = C - 1, pch = 0, pi = 0;
  float pol[3] = {0.0f, 0.0f, 0.0f}, pdl[3] = {0.0f, 0.0f, 0.0f};
  bool pin = false, pdone = false;
  // move (pj, pc) to the next pair some ray of the block wants; pj = I
  // past the last
  auto next_wanted = [&]() {
    for (;;) {
      for (++pc; pc < C; ++pc) {
        refresh();
        const bool w = pin && !(ANY && blocked[0]) &&
                       isect::slab_hit(pol, pdl, cbox + 8 * pc, bnd());
        if (__any_sync(FULL_MASK, w)) return;
      }
      for (++pj; pj < I; ++pj) {
        pin = admits(pj);
        if (__any_sync(FULL_MASK, pin)) break;
      }
      if (pj >= I) return;
      isect::to_instance(row(pj), ow, dw, pol, pdl);
      pc = -1;
    }
  };
  auto produce = [&]() {
    const int s = pi % STAGES;
    if (pi >= STAGES) mbar_wait(empty + s, ((pi / STAGES) - 1) & 1);
    ++pi;
    if (pj >= I) {
      if (lane == 0) {
        tags[s] = -1;
        mbar_arrive(full + s);
      }
      pdone = true;
      return;
    }
    if (lane == 0) {
      tags[s] = (pj * C + pc) * per + pch;
      mbar_expect(full + s, STAGE_BYTES);
      tile_load(ring + s * STAGE_FLOATS, &wmap, pch * CHUNK, pc * 64,
                full + s);
    }
    if (++pch == per) {
      pch = 0;
      next_wanted();
    }
  };
  if (warp == 0) {
    next_wanted();
    while (pi < STAGES - 1 && !pdone) produce();
  }

  constexpr int GROUPS = CHUNK / GROUP;
  const int g0 = warp * (GROUPS / W) * GROUP;
  isect::Ray ray[R];
  bool want[R] = {false};
  bool in = false, warp_wants = false, swept = false;
  int cj = -1, part = 0;
  float before = 0.0f;
  for (int item = 0;; ++item) {
    if (warp == 0 && !pdone) produce();
    const int s = item % STAGES;
    mbar_wait(full + s, (item / STAGES) & 1);
    const int tag = tags[s];
    if (tag < 0) break;
    const int ch = tag % per, jc = tag / per;
    const int c = jc % C, j = jc / C;
    if (ch == 0) {
      if (j != cj) {
        // the first cluster staged of instance j: the local ray, and
        // whether the ray's world-box test admits j (a closest hit's
        // bounds and so this vote are the same in every warp)
        cj = j;
        in = admits(j);
        float ol[3], dl[3];
        isect::to_instance(row(j), ow, dw, ol, dl);
        isect::ray_setup(ol, dl, &ray[0]);
      }
      before = best[0];
      refresh();
      want[0] = in && !(ANY && blocked[0]) &&
                isect::slab_hit(ray[0], cbox + 8 * c, bnd());
      swept = warp_wants = __any_sync(FULL_MASK, want[0]);
    } else if (ANY && warp_wants) {
      // leave once every ray that wants the cluster is blocked
      refresh();
      warp_wants = __any_sync(FULL_MASK, want[0] && !blocked[0]);
    }
    if (warp_wants) {
      const float* stage = ring + s * STAGE_FLOATS;
      const int slot0 = c * K + ch * CHUNK;
#pragma unroll 1
      for (int g = g0; g < g0 + (GROUPS / W) * GROUP; g += GROUP) {
        float dq[4][GROUP][R];
        isect::dets4<R>(ray, stage + g, 4 * CHUNK, CHUNK, dq);
        isect::accept4<ANY, R>(dq, ray, want, tm, slot0 + g, best, bslot,
                               blocked);
      }
      if (ANY && blocked[0]) flags[lane] = 1;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (!ANY && swept && ch == per - 1) {
      merge_best(best, bslot, parts + part * PART_FLOATS, warp, lane);
      part ^= 1;
      // a hit in this cluster is strictly closer than the best before it
      if (best[0] < before) binst = j;
    }
  }
  if (ANY) {
    __syncthreads();
    blocked[0] = flags[lane] != 0;
  }
  if (warp != 0 || i >= n) return;
  if (ANY) {
    b_out[i] = (live && blocked[0]) ? 1 : 0;
  } else {
    t_out[i] = bslot[0] == -1 ? tm[0] : best[0];
    i_out[i] = bslot[0];
    inst_out[i] = bslot[0] == -1 ? 0 : binst;
  }
}

template <bool ANY>
cudaError_t allow_inst_smem(int smem) {
  static int opted = 48 * 1024;  // allowed so far
  if (smem <= opted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      instanced_kernel<ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) opted = smem;
  return e;
}

struct InstArgs {
  CUtensorMap wmap;
  const float *o, *d, *bound, *w, *cbox, *itab;
  const int* n_alive;
  const unsigned char* blocked_in;
  int n, C, K, I;
  float* t_out;
  int *i_out, *inst_out;
  unsigned char* b_out;
  void* stream;
};

template <bool ANY>
int launch_inst(InstArgs a) {
  if (a.n <= 0) return 0;
  // the tags (instance, cluster, chunk) must fit an int; the descriptor
  // and the table's float4 copies need 16-byte aligned tensors
  if (a.K <= 0 || a.K % CHUNK != 0 || a.C <= 0 || a.I < 0 ||
      (long long)a.I * a.C * (a.K / CHUNK) > INT_MAX ||
      ((uintptr_t)a.w & 15) != 0 || ((uintptr_t)a.itab & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = weight_map(a.w, a.C, a.K, &a.wmap);
  if (e != cudaSuccess) return (int)e;
  const int smem = inst_smem_bytes(a.I);
  e = allow_inst_smem<ANY>(smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((a.n + 31L) / 32L);
  instanced_kernel<ANY><<<grid, 32 * W, smem, (cudaStream_t)a.stream>>>(
      a.wmap, a.o, a.d, a.bound, a.cbox, a.itab, a.n_alive, a.blocked_in,
      a.n, a.C, a.K, a.I, a.t_out, a.i_out, a.inst_out, a.b_out);
  return (int)cudaGetLastError();
}

template <bool ANY>
int inst_occupancy(int ni) {
  const int smem = inst_smem_bytes(ni);
  int blocks = 0;
  cudaError_t e = allow_inst_smem<ANY>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, instanced_kernel<ANY>, 32 * W, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace

// The instanced entries; return a cudaError_t code (0 = launched).  N
// world rays, one instanced mesh: its cluster tables (C >= 1 clusters
// of K) and instance table itab [I, ITAB_COLS].  The closest hit writes
// t_out (the bound on a miss), slot_out (the local slot, -1 on a miss)
// and inst_out (0 on a miss); the any hit writes blocked_out (1 where a
// triangle of some instance lies within tmax or blocked_in, which may
// be null, is set; 0 past n_alive).
extern "C" int arendur_closest_hit_instanced(
    const float* o, const float* d, const float* bound, const float* w,
    const float* cbox, const float* itab, const int* n_alive, int n, int C,
    int K, int I, float* t_out, int* slot_out, int* inst_out, void* stream) {
  return launch_inst<false>(InstArgs{{}, o, d, bound, w, cbox, itab,
                                     n_alive, nullptr, n, C, K, I, t_out,
                                     slot_out, inst_out, nullptr, stream});
}

extern "C" int arendur_any_hit_instanced(
    const float* o, const float* d, const float* tmax, const float* w,
    const float* cbox, const float* itab, const int* n_alive,
    const unsigned char* blocked_in, int n, int C, int K, int I,
    unsigned char* blocked_out, void* stream) {
  return launch_inst<true>(InstArgs{{}, o, d, tmax, w, cbox, itab, n_alive,
                                    blocked_in, n, C, K, I, nullptr, nullptr,
                                    nullptr, blocked_out, stream});
}

// What an instanced launch over ni instances holds: the dynamic shared
// memory of a block (into *smem) and the blocks an SM holds at once
// (negative: a cudaError).
extern "C" int arendur_isect_inst_occupancy(int any, int ni, int* smem) {
  *smem = inst_smem_bytes(ni);
  return any ? inst_occupancy<true>(ni) : inst_occupancy<false>(ni);
}

// C interface; returns a cudaError_t code (0 = launched).  sph [ns, 24]
// may be null with ns = 0 (no spheres).
extern "C" int arendur_closest_hit(const float* o, const float* d,
                                   const float* tmax, const float* w,
                                   const float* cbox, const int* n_alive,
                                   const float* sph, int ns, int full_phi,
                                   int n, int C, int K, int period,
                                   float* t_out, int* slot_out,
                                   void* stream) {
  return launch<false>(Args{{}, o, d, tmax, w, cbox, n_alive, sph, ns,
                            full_phi, n, C, K, period, t_out, slot_out,
                            stream});
}

extern "C" int arendur_any_hit(const float* o, const float* d,
                               const float* tmax, const float* w,
                               const float* cbox, const int* n_alive,
                               const float* sph, int ns, int full_phi, int n,
                               int C, int K, int period, int* blocked_out,
                               void* stream) {
  return launch<true>(Args{{}, o, d, tmax, w, cbox, n_alive, sph, ns,
                           full_phi, n, C, K, period, nullptr, blocked_out,
                           stream});
}

// The TMA descriptors encoded since the library was loaded (the launches
// that found theirs in the cache encode none).
extern "C" long long arendur_isect_encodes() { return encodes; }

// What a launch holds, for the build report: the dynamic shared memory
// of a block (into *smem; the same for a sphere table of any size), and
// the blocks an SM holds at once (negative: a cudaError) for the
// closest (any = 0) or the any hit.
extern "C" int arendur_isect_occupancy(int any, int* smem) {
  *smem = SMEM_BYTES;
  return any ? occupancy<true>() : occupancy<false>();
}
