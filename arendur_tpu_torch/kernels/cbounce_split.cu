// The textured split of the bounce for Hopper (sm_90a): the hit kernel
// (K5) replaces the Pallas TPU kernel
// arendur_tpu/render/cbounce.py::_kernel_hit (launched by hit_shade_t),
// the split shade kernel (K6) replaces ::_kernel_shade (launched by
// _run_shade, entry shade_split_t).  Between the two, the texel lookups
// run as plain PyTorch (materials.resolve_params), as the JAX package
// runs them in XLA between its two kernels.
//
// Both kernels run one thread per lane over a lane-transposed wave, so
// every column load and store is coalesced, with one table staged per
// block in shared memory (read in place from global memory instead
// where it does not fit the 227 KB a block may use: kernels/ops.py
// stage_plan): K5 reads [HIT_IN_COLS=41, N] and the sphere
// table and writes [HIT_OUT_COLS=28, N]; K6 reads [SHADE_IN_COLS=50, N]
// and the light table and writes [OUT_COLS=32, N].  Their bodies are the
// two halves of the fused bounce K3 runs (cbounce_body.cuh hit_info and
// shade_core), compiled from the same source.
//
// Bound: per lane K5 moves 69 floats and K6 82 (276 and 328 B; K6 41
// on a lane past the live count), so at N = 65,536 the bytes take ~5-6
// us at the HBM rate; the kernels are bound by the latency and issue
// rate of a long per-thread program, as K3 is.  K5 has no material or
// light branch; K6 has K3's design (kernels/cbounce.cu): only the lanes
// below the live count n_alive run the body (a block wholly past it
// writes the contract's columns, cbounce.cuh dead_lane), no arrays in
// local memory, the light table's rows at an odd pitch in shared
// memory, and the registers capped at 128 for 4 blocks an SM.
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int SPLIT_BLOCK = 128;
constexpr int SPLIT_MIN_BLOCKS = 4;

// INPLACE (K5, K6): the kernel's table read in place from global memory
// where it does not fit a block's shared memory (kernels/ops.py
// stage_plan), else staged as below
template <bool INPLACE>
__global__ void __launch_bounds__(BLOCK)
    hit_shade_kernel(const float* __restrict__ xt,
                     const float* __restrict__ stab, int ns, long n,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  const cshade::Tables tb =
      cshade::stage_tables(nullptr, 0, 0, nullptr, 0, stab, ns,
                           INPLACE ? 0 : cshade::STAGE_S, false, smem);
  if (!INPLACE) __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  cbounce::hit_lane(xt + lane, n, tb, out + lane);
}

template <bool INPLACE>
__global__ void __launch_bounds__(SPLIT_BLOCK, SPLIT_MIN_BLOCKS)
    shade_split_kernel(const float* __restrict__ xt,
                       const float* __restrict__ ltab, int nl, int cl,
                       long n, const int* __restrict__ n_alive,
                       cbounce::ShadeCfg cfg, float* __restrict__ out) {
  using namespace cshade;
  const long na = live_count(n_alive, n);
  const long lane = (long)blockIdx.x * SPLIT_BLOCK + threadIdx.x;
  if ((long)blockIdx.x * SPLIT_BLOCK >= na) {  // the whole block is past it
    if (lane < n)
      cbounce::dead_lane(xt + lane, n, S_BETA, S_L, S_SPECULAR, S_SEL_PREV,
                         S_WB_PREV, out + lane);
    return;
  }
  extern __shared__ float smem[];
  const Tables tb = stage_tables(ltab, nl, cl, nullptr, 0, nullptr, 0,
                                 INPLACE ? 0 : STAGE_L, true, smem);
  if (!INPLACE) __syncthreads();
  if (lane >= n) return;
  if (lane >= na) {
    cbounce::dead_lane(xt + lane, n, S_BETA, S_L, S_SPECULAR, S_SEL_PREV,
                       S_WB_PREV, out + lane);
    return;
  }
  cbounce::shade_split_lane(xt + lane, n, tb, cfg, out + lane);
}

const void* split_kernel_for(int staged) {
  return (staged & cshade::STAGE_L) ? (const void*)shade_split_kernel<false>
                                    : (const void*)shade_split_kernel<true>;
}

}  // namespace

// C interface.  Each returns a cudaError_t code (0 = launched).  staged:
// the cshade::STAGE_* bit of the kernel's table (K5 STAGE_S, K6
// STAGE_L) where it is staged in shared memory, else it is read in
// place (kernels/ops.py stage_plan).
extern "C" int arendur_hit_shade(const float* xt, const float* stab, int ns,
                                 int staged, long n, float* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const bool st = (staged & cshade::STAGE_S) != 0;
  const size_t smem =
      cshade::staged_bytes(0, 0, 0, ns, staged & cshade::STAGE_S, false);
  const void* k = st ? (const void*)hit_shade_kernel<false>
                     : (const void*)hit_shade_kernel<true>;
  int e = cshade::allow_smem(k, smem);
  if (e) return e;
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  if (st)
    hit_shade_kernel<false><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        xt, stab, ns, n, out);
  else
    hit_shade_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        xt, stab, ns, n, out);
  return (int)cudaGetLastError();
}

// cfg_words: the ShadeCfg as 42 little-endian 32-bit words (host
// memory); n_alive: the live count on the device (int32; null: every
// lane is live)
extern "C" int arendur_shade_split(const float* xt, const float* ltab,
                                   int nl, int cl, int staged, long n,
                                   const int* n_alive,
                                   const void* cfg_words, float* out,
                                   void* stream) {
  if (n <= 0) return 0;
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  staged &= cshade::STAGE_L;
  const size_t smem = cshade::staged_bytes(nl, cl, 0, 0, staged, true);
  int e = cshade::allow_smem(split_kernel_for(staged), smem);
  if (e) return e;
  unsigned grid = (unsigned)((n + SPLIT_BLOCK - 1) / SPLIT_BLOCK);
  if (staged)
    shade_split_kernel<false>
        <<<grid, SPLIT_BLOCK, smem, (cudaStream_t)stream>>>(
            xt, ltab, nl, cl, n, n_alive, cfg, out);
  else
    shade_split_kernel<true>
        <<<grid, SPLIT_BLOCK, smem, (cudaStream_t)stream>>>(
            xt, ltab, nl, cl, n, n_alive, cfg, out);
  return (int)cudaGetLastError();
}

// What a K6 launch over a light table of nl rows of cl floats holds
// (cshade::occupancy: smem, blocks an SM, registers, local memory).
extern "C" int arendur_shade_split_occupancy(int nl, int cl, int staged,
                                             int* info) {
  staged &= cshade::STAGE_L;
  return cshade::occupancy(split_kernel_for(staged), SPLIT_BLOCK,
                           cshade::staged_bytes(nl, cl, 0, 0, staged, true), info);
}
