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
// block in shared memory: K5 reads [HIT_IN_COLS=41, N] and the sphere
// table and writes [HIT_OUT_COLS=28, N]; K6 reads [SHADE_IN_COLS=50, N]
// and the light table and writes [OUT_COLS=32, N].  Their bodies are the
// two halves of the fused bounce K3 runs (cbounce_body.cuh hit_info and
// shade_core), compiled from the same source.
//
// Bound: per lane K5 moves 69 floats and K6 82 (276 and 328 B), so at
// N = 65,536 the bytes take ~5-6 us at the HBM rate; the kernels are
// bound by the latency and issue rate of a long per-thread program, as
// K3 is.  The design keeps every intermediate in registers; K5 has no
// material or light branch, K6 the same divergence as K3.
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce.cuh"

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
    hit_shade_kernel(const float* __restrict__ xt,
                     const float* __restrict__ stab, int ns, long n,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nst = ns * 24;
  for (int i = threadIdx.x; i < nst; i += blockDim.x) smem[i] = stab[i];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  cbounce::Tables tb = {};
  tb.stab = smem;
  tb.ns = ns;
  cbounce::hit_lane(xt + lane, n, tb, out + lane);
}

__global__ void __launch_bounds__(BLOCK)
    shade_split_kernel(const float* __restrict__ xt,
                       const float* __restrict__ ltab, int nl, int cl,
                       long n, cbounce::ShadeCfg cfg,
                       float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nlt = nl * cl;
  for (int i = threadIdx.x; i < nlt; i += blockDim.x) smem[i] = ltab[i];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  cbounce::Tables tb = {};
  tb.ltab = smem;
  tb.nl = nl;
  tb.cl = cl;
  cbounce::shade_split_lane(xt + lane, n, tb, cfg, out + lane);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// C interface.  Each returns a cudaError_t code (0 = launched).
extern "C" int arendur_hit_shade(const float* xt, const float* stab, int ns,
                                 long n, float* out, void* stream) {
  if (n <= 0) return 0;
  size_t smem = sizeof(float) * (size_t)ns * 24;
  int e = set_smem((const void*)hit_shade_kernel, smem);
  if (e) return e;
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  hit_shade_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(xt, stab, ns,
                                                                 n, out);
  return (int)cudaGetLastError();
}

// cfg_words: the ShadeCfg as 42 little-endian 32-bit words (host memory)
extern "C" int arendur_shade_split(const float* xt, const float* ltab,
                                   int nl, int cl, long n,
                                   const void* cfg_words, float* out,
                                   void* stream) {
  if (n <= 0) return 0;
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  size_t smem = sizeof(float) * (size_t)nl * cl;
  int e = set_smem((const void*)shade_split_kernel, smem);
  if (e) return e;
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  shade_split_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      xt, ltab, nl, cl, n, cfg, out);
  return (int)cudaGetLastError();
}
