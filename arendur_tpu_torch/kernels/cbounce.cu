// Bounce-shade kernel for Hopper (sm_90a): replaces the Pallas TPU
// kernel arendur_tpu/render/cbounce.py::_kernel (launched by _run,
// entry bounce_shade_t), and also serves scenes whose tables have more
// than 32 rows, for which the JAX package takes the row-form kernel
// arendur_tpu/render/pallas_bounce.py::_kernel with its one-hot row
// select: a direct indexed row load has no such cap.
//
// One thread shades one ray over the lane-transposed wave xt
// [IN_COLS=58, N] -> out [OUT_COLS=32, N]: neighbouring threads read
// neighbouring addresses of every column, so each column load and
// store is coalesced.  The light, material and sphere tables are staged
// once per block into shared memory and read by direct row index (no
// row cap: the tables only have to fit the 227 KB a block may use).
//
// Bound: per ray the kernel moves 90 floats (360 B) and spends a few
// thousand f32 operations plus transcendentals, so at N = 65,536 it is
// bound by latency and issue rate of a long per-thread program, not by
// memory; the design keeps every intermediate in registers and pays
// for divergence between material and light branches.  The plain
// PyTorch version (render/cbounce.py::cbody_reference) materialises
// every intermediate as a [N] tensor instead.
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce.cuh"

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
    bounce_shade_kernel(const float* __restrict__ xt,
                        const float* __restrict__ ltab, int nl, int cl,
                        const float* __restrict__ mtab, int nm,
                        const float* __restrict__ stab, int ns, long n,
                        cbounce::ShadeCfg cfg, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nlt = nl * cl, nmt = nm * 16, nst = ns * 24;
  float* sl = smem;
  float* sm = sl + nlt;
  float* ss = sm + nmt;
  for (int i = threadIdx.x; i < nlt; i += blockDim.x) sl[i] = ltab[i];
  for (int i = threadIdx.x; i < nmt; i += blockDim.x) sm[i] = mtab[i];
  for (int i = threadIdx.x; i < nst; i += blockDim.x) ss[i] = stab[i];
  __syncthreads();
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  cbounce::Tables tb;
  tb.ltab = sl;
  tb.nl = nl;
  tb.cl = cl;
  tb.mtab = sm;
  tb.nm = nm;
  tb.stab = ss;
  tb.ns = ns;
  cbounce::cbody_lane(xt + lane, n, tb, cfg, out + lane);
}

}  // namespace

static_assert(sizeof(cbounce::ShadeCfg) == 42 * 4, "ShadeCfg layout");

// C interface.  cfg_words: the ShadeCfg as 42 little-endian 32-bit words
// (host memory).  Returns a cudaError_t code (0 = launched).
extern "C" int arendur_bounce_shade(const float* xt, const float* ltab,
                                    int nl, int cl, const float* mtab,
                                    int nm, const float* stab, int ns,
                                    long n, const void* cfg_words,
                                    float* out, void* stream) {
  if (n <= 0) return 0;
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  size_t smem = sizeof(float) * ((size_t)nl * cl + (size_t)nm * 16 +
                                 (size_t)ns * 24);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bounce_shade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  bounce_shade_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
      xt, ltab, nl, cl, mtab, nm, stab, ns, n, cfg, out);
  return (int)cudaGetLastError();
}
