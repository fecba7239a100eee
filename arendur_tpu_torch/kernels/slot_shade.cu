// The BSDF slot sweeps of the composed path for Hopper (sm_90a): the
// slot-sample kernel (K8) replaces the Pallas TPU kernel
// arendur_tpu/bxdf/pallas_shade.py::_sample_kernel (entry bsdf_sample),
// the eval-pdf kernel (K9) replaces ::_eval_pdf_kernel (entry
// bsdf_eval_pdf).  Their entries are bxdf/slot_shade.py's.
//
// One thread per lane reads the lane's BSDF where the BsdfSlots fields
// lie (slot_shade.cuh Fields: [N,3], [N,K] and [N,K,3] rows, no pack)
// with wo and u (K8) or wo and wi (K9), and writes f [N,3], wi [N,3],
// pdf [N] and kind [N] int32 (K8) or f and pdf (K9) at the lane's own
// index.  The bodies are the slot sweeps the bounce kernels run
// (cbounce_body.cuh bsdf_sample / bsdf_eval_pdf), over the kinds in
// `types`, specialised by the same host-static ShadeCfg presence and
// distribution sets; the light fields of the ShadeCfg are unused here.
//
// Lanes whose slots hold different BSDF families run each family's
// body in turn within a warp.  So K8 takes an order [N] int32, the
// BSDF's material-recipe order: thread i shades lane order[i].  K9
// shades its lanes in wave order (the order gained it nothing on a
// BPT wave and cost it on a composed one, PERF.md §6).  The order
// (slot_order_*_kernel) is a stable counting sort of the lanes by
// material recipe (slot_shade.cuh recipe_key): per tile of ORDER_TILE
// lanes a histogram, then per tile the first place of each key from
// all tiles' counts, each lane's rank among the tile's earlier lanes
// of its key (a warp a run of ORDER_RUN lanes), and the lanes placed.
// No host sync; the caller builds it once per BSDF and reuses it.
//
// Bound: per lane K8 moves 61 floats and K9 58 (244 and 232 B), ~15 MB
// at N = 65,536, ~4.6 us at the HBM rate; a few hundred f32 operations
// per lane take about as long at the f32 peak, so both kernels sit near
// the balance point and their time is the latency of one long
// per-thread program.
//
// The earlier route, a lane-major pack of the BSDF ([SLOT_COLS, N]
// columns, slot_shade.cuh read_packed) into [8, N] / [4, N] outputs,
// stays callable (arendur_slot_*_packed) so that the two can be timed
// in one run; no render launches it.
#include <cuda_runtime.h>
#include <string.h>

#include "slot_shade.cuh"

namespace {

using slots::ORDER_TILE;

// K8 / K9 are launched __launch_bounds__(BLOCK, 1): without the minimum
// ptxas kept them at 80 / 72 registers with 8-16 B of spills; with it,
// 90 / 79 registers and no spill (K8's 32 B frame is the math library's
// sinf / cosf argument reduction for |x| > 105,615)
constexpr int BLOCK = 128;
constexpr int ORDER_BLOCK = 256;
constexpr int ORDER_WARPS = ORDER_BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BLOCK, 1)
    slot_sample_kernel(slots::Fields p, const float* __restrict__ wo,
                       const float* __restrict__ u,
                       const int* __restrict__ order, long n, int types,
                       cbounce::ShadeCfg cfg, slots::Outs o) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  slots::sample_lane(p, (long)__ldg(order + i), wo, u, types, cfg, o);
}

__global__ void __launch_bounds__(BLOCK, 1)
    slot_eval_pdf_kernel(slots::Fields p, const float* __restrict__ wo,
                         const float* __restrict__ wi, long n, int types,
                         cbounce::ShadeCfg cfg, slots::Outs o) {
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  slots::eval_pdf_lane(p, lane, wo, wi, types, cfg, o);
}

__global__ void __launch_bounds__(BLOCK)
    slot_sample_packed_kernel(const float* __restrict__ xt, long n,
                              int types, cbounce::ShadeCfg cfg,
                              float* __restrict__ out) {
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  slots::sample_packed_lane(xt + lane, n, types, cfg, out + lane);
}

__global__ void __launch_bounds__(BLOCK)
    slot_eval_pdf_packed_kernel(const float* __restrict__ xt, long n,
                                int types, cbounce::ShadeCfg cfg,
                                float* __restrict__ out) {
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  slots::eval_pdf_packed_lane(xt + lane, n, types, cfg, out + lane);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The histogram of one tile's keys: counts[key * tiles + tile].  A
// warp's lanes of one key add once (their leader adds their number).
__global__ void __launch_bounds__(ORDER_BLOCK)
    slot_order_count_kernel(const int* __restrict__ type, long n,
                            cbounce::ShadeCfg cfg, int nkeys,
                            int* __restrict__ counts) {
  __shared__ int hist[slots::MAX_KEYS];
  for (int k = threadIdx.x; k < nkeys; k += ORDER_BLOCK) hist[k] = 0;
  __syncthreads();
  const long first = (long)blockIdx.x * ORDER_TILE;
  for (int j = threadIdx.x; j < ORDER_TILE; j += ORDER_BLOCK) {
    const long lane = first + j;
    const bool valid = lane < n;
    const unsigned act = __ballot_sync(FULL, valid);
    if (valid) {
      const int key = slots::recipe_key(type + slots::K * lane, cfg);
      const unsigned peers = __match_any_sync(act, key);
      if ((peers & lanes_below()) == 0) atomicAdd(&hist[key], __popc(peers));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nkeys; k += ORDER_BLOCK)
    counts[(long)k * gridDim.x + blockIdx.x] = hist[k];
}

// One tile's lanes placed.  Warp w takes the tile's run w of
// ORDER_RUN lanes: it counts its run's keys (run[w][key]) and ranks each
// lane among the run's earlier lanes of its key, 32 lanes at a time.
// place[key] = the key's first place in this tile (all tiles' lanes of
// smaller keys, this key's lanes in the tiles before), run[w][key]
// becomes the lanes of the key in the runs before w, and each lane goes
// to place[key] + run[w][key] + its rank.
__global__ void __launch_bounds__(ORDER_BLOCK)
    slot_order_scatter_kernel(const int* __restrict__ type, long n,
                              cbounce::ShadeCfg cfg, int nkeys,
                              const int* __restrict__ counts,
                              int* __restrict__ order) {
  static_assert(slots::ORDER_RUNS == ORDER_WARPS, "a warp a run");
  __shared__ int place[slots::MAX_KEYS];
  __shared__ int total[slots::MAX_KEYS];
  __shared__ unsigned short run[ORDER_WARPS][slots::MAX_KEYS];
  __shared__ short keys[ORDER_TILE];
  __shared__ short rank[ORDER_TILE];
  __shared__ int warp_sum[ORDER_WARPS];
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long first = (long)tile * ORDER_TILE;
  for (int k = threadIdx.x; k < nkeys; k += ORDER_BLOCK) {
    place[k] = 0;
    total[k] = 0;
#pragma unroll
    for (int v = 0; v < ORDER_WARPS; ++v) run[v][k] = 0;
  }
  __syncthreads();
  for (int c = 0; c < slots::ORDER_RUN; c += 32) {
    const int j = w * slots::ORDER_RUN + c + l;
    const long lane = first + j;
    const bool valid = lane < n;
    const unsigned act = __ballot_sync(FULL, valid);
    if (valid) {
      const int key = slots::recipe_key(type + slots::K * lane, cfg);
      const unsigned peers = __match_any_sync(act, key);
      const int before = run[w][key];
      keys[j] = (short)key;
      rank[j] = (short)(before + __popc(peers & lanes_below()));
      __syncwarp(act);
      if ((peers & lanes_below()) == 0) run[w][key] = before + __popc(peers);
    }
    __syncwarp();
  }
  // per key: its lanes in all tiles, and in the tiles before this one
  for (int e = threadIdx.x; e < nkeys * tiles; e += ORDER_BLOCK) {
    const int c = counts[e];
    if (c) {
      const int k = e / tiles;
      atomicAdd(&total[k], c);
      if (e - k * tiles < tile) atomicAdd(&place[k], c);
    }
  }
  __syncthreads();
  // place[k] += the lanes of all smaller keys: an exclusive scan of
  // total over the keys, each thread taking a run of `per` keys; and
  // run[v][k] becomes the key's lanes in the runs before v
  const int per = (nkeys + ORDER_BLOCK - 1) / ORDER_BLOCK;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nkeys);
  int sum = 0;
  for (int k = lo; k < hi; ++k) {
    sum += total[k];
    int runs = 0;
#pragma unroll
    for (int v = 0; v < ORDER_WARPS; ++v) {
      const int h = run[v][k];
      run[v][k] = (unsigned short)runs;
      runs += h;
    }
  }
  int incl = sum;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, s);
    incl += l >= s ? v : 0;
  }
  if (l == 31) warp_sum[w] = incl;
  __syncthreads();
  if (w == 0) {
    int v = l < ORDER_WARPS ? warp_sum[l] : 0;
#pragma unroll
    for (int s = 1; s < ORDER_WARPS; s <<= 1) {
      const int u = __shfl_up_sync(FULL, v, s);
      v += l >= s ? u : 0;
    }
    if (l < ORDER_WARPS) warp_sum[l] = v;
  }
  __syncthreads();
  int below = incl - sum + (w > 0 ? warp_sum[w - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int t = total[k];
    place[k] += below;
    below += t;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ORDER_TILE; j += ORDER_BLOCK) {
    const long lane = first + j;
    if (lane < n) {
      const int key = keys[j];
      order[place[key] + run[j / slots::ORDER_RUN][key] + rank[j]] =
          (int)lane;
    }
  }
}

unsigned blocks(long n, int per) { return (unsigned)((n + per - 1) / per); }

cbounce::ShadeCfg config(const void* cfg_words) {
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  return cfg;
}

slots::Fields fields(const float* ns, const float* ts, const float* bs,
                     const float* ng, const int* type, const int* kind,
                     const int* dist, const float* c0, const float* c1,
                     const float* p0, const float* p1, const float* p2) {
  return slots::Fields{ns, ts, bs, ng, type, kind, dist,
                       c0, c1, p0, p1, p2};
}

}  // namespace

static_assert(sizeof(cbounce::ShadeCfg) == 42 * 4, "ShadeCfg layout");
static_assert(slots::MAX_KEYS < 32768, "keys are staged as shorts");

// C interface.  The BSDF fields as BsdfSlots holds them (contiguous,
// device memory); wo [n,3], u [n,2] and the recipe order [n] int32
// (K8), or wo and wi [n,3] (K9); cfg_words: the ShadeCfg as 42
// little-endian 32-bit words (host memory).  K8 writes f [n,3], wi
// [n,3], pdf [n], kind [n] int32; K9 f [n,3], pdf [n].  Each returns a
// cudaError_t code (0 = launched; K8 refuses a null order).
extern "C" int arendur_slot_sample(
    const float* ns, const float* ts, const float* bs, const float* ng,
    const int* type, const int* kind, const int* dist, const float* c0,
    const float* c1, const float* p0, const float* p1, const float* p2,
    const float* wo, const float* u, const int* order, long n, int types,
    const void* cfg_words, float* f, float* wi, float* pdf, int* kind_out,
    void* stream) {
  if (n <= 0) return 0;
  if (!order) return (int)cudaErrorInvalidValue;
  slot_sample_kernel<<<blocks(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      fields(ns, ts, bs, ng, type, kind, dist, c0, c1, p0, p1, p2), wo, u,
      order, n, types, config(cfg_words),
      slots::Outs{f, wi, pdf, kind_out});
  return (int)cudaGetLastError();
}

extern "C" int arendur_slot_eval_pdf(
    const float* ns, const float* ts, const float* bs, const float* ng,
    const int* type, const int* kind, const int* dist, const float* c0,
    const float* c1, const float* p0, const float* p1, const float* p2,
    const float* wo, const float* wi, long n, int types,
    const void* cfg_words, float* f, float* pdf, void* stream) {
  if (n <= 0) return 0;
  slot_eval_pdf_kernel<<<blocks(n, BLOCK), BLOCK, 0,
                         (cudaStream_t)stream>>>(
      fields(ns, ts, bs, ng, type, kind, dist, c0, c1, p0, p1, p2), wo, wi,
      n, types, config(cfg_words),
      slots::Outs{f, nullptr, pdf, nullptr});
  return (int)cudaGetLastError();
}

// The material-recipe order of n lanes from their types [n, K] int32:
// order [n] int32, a stable sort by recipe_key under the ShadeCfg's
// presence sets.  nkeys = slots::key_count of the ShadeCfg; counts:
// device scratch of nkeys * ceil(n / ORDER_TILE) int32.  Two launches.
extern "C" int arendur_slot_order(const int* type, long n,
                                  const void* cfg_words, int nkeys,
                                  int* counts, int* order, void* stream) {
  if (n <= 0) return 0;
  const cbounce::ShadeCfg cfg = config(cfg_words);
  if (nkeys != slots::key_count(cfg)) return (int)cudaErrorInvalidValue;
  const unsigned tiles = blocks(n, ORDER_TILE);
  cudaStream_t s = (cudaStream_t)stream;
  slot_order_count_kernel<<<tiles, ORDER_BLOCK, 0, s>>>(type, n, cfg, nkeys,
                                                        counts);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  slot_order_scatter_kernel<<<tiles, ORDER_BLOCK, 0, s>>>(type, n, cfg,
                                                          nkeys, counts,
                                                          order);
  return (int)cudaGetLastError();
}

// The earlier route: xt [SLOT_COLS + 5, n] / [SLOT_COLS + 6, n]
// lane-major (bxdf/slot_shade.py pack_slots) -> out [8, n] / [4, n].
extern "C" int arendur_slot_sample_packed(const float* xt, long n, int types,
                                          const void* cfg_words, float* out,
                                          void* stream) {
  if (n <= 0) return 0;
  slot_sample_packed_kernel<<<blocks(n, BLOCK), BLOCK, 0,
                              (cudaStream_t)stream>>>(xt, n, types,
                                                      config(cfg_words), out);
  return (int)cudaGetLastError();
}

extern "C" int arendur_slot_eval_pdf_packed(const float* xt, long n,
                                            int types, const void* cfg_words,
                                            float* out, void* stream) {
  if (n <= 0) return 0;
  slot_eval_pdf_packed_kernel<<<blocks(n, BLOCK), BLOCK, 0,
                                (cudaStream_t)stream>>>(
      xt, n, types, config(cfg_words), out);
  return (int)cudaGetLastError();
}
