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
// row cap).  A table that does not fit the 227 KB a block may use is
// read in place from global memory instead (kernels/ops.py stage_plan
// stages the material, sphere and light tables, in that order, while
// they fit): the body reads its rows through the same pointers, so its
// outputs do not depend on where a row lies.
//
// Bound: per live lane the kernel moves 90 floats (360 B), per lane
// past the live count 41 (the 9 carried inputs and the 32 outputs), so
// a full first bounce of 65,536 lanes moves 23.6 MB, 7.0 us at the HBM
// rate.  What sets its time instead is the issue and latency of one
// long per-lane program (a few thousand instructions, transcendentals
// and IEEE divisions among them, with material and light branches that
// diverge within a warp).  The design:
//   * only the live lanes run the body: the wave is compacted alive
//     first, and the kernel reads the live count n_alive on the device,
//     so a block wholly past it skips the table staging and writes the
//     contract's columns (cbounce.cuh dead_lane), and the one block that
//     straddles it branches per warp;
//   * no arrays in local memory: the body indexes its slot arrays only
//     by compile-time constants, reads each input column where it uses
//     it and writes each output column as it is known (cbounce.cuh Cols,
//     ColumnOut);
//   * each table row sits at an odd pitch in shared memory, so lanes of
//     a warp that read different rows of a table read different banks;
//   * __launch_bounds__(BLOCK, MIN_BLOCKS) caps the registers at the
//     128 that 4 blocks of 128 threads an SM leave.  The body wants
//     ~142 and spills ~70 B a thread at 128, but the 16 warps an SM
//     hide more latency than the spills cost: the shapes measured
//     (tools/shade_shapes.py, PERF.md §6) are no faster with fewer
//     registers and more warps, nor with more registers and fewer.
// Divergence sets most of the time after the first bounce: a warp runs
// every arm of the material, light and sample branches one of its
// lanes takes (PERF.md §6: the same lanes sorted by branch class take
// about half the time); the lanes are shaded in the wave's order.
// The plain PyTorch version (render/cbounce.py::cbody_reference)
// materialises every intermediate as a [N] tensor instead.
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 4;

// INPLACE false: every table staged (the launch of every scene whose
// tables fit); true: the tables `staged` names staged, the others read
// in place (cbounce.cuh stage_tables)
template <bool INPLACE>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    bounce_shade_kernel(const float* __restrict__ xt,
                        const float* __restrict__ ltab, int nl, int cl,
                        const float* __restrict__ mtab, int nm,
                        const float* __restrict__ stab, int ns, int staged,
                        long n, const int* __restrict__ n_alive,
                        cbounce::ShadeCfg cfg, float* __restrict__ out) {
  using namespace cshade;
  const long na = live_count(n_alive, n);
  const long lane = (long)blockIdx.x * BLOCK + threadIdx.x;
  if ((long)blockIdx.x * BLOCK >= na) {  // the whole block is past it
    if (lane < n)
      cbounce::dead_lane(xt + lane, n, C_BETA, C_L, C_SPECULAR, C_SEL_PREV,
                         C_WB_PREV, out + lane);
    return;
  }
  extern __shared__ float smem[];
  const Tables tb = stage_tables(ltab, nl, cl, mtab, nm, stab, ns,
                                 INPLACE ? staged : STAGE_ALL, true, smem);
  __syncthreads();
  if (lane >= n) return;
  if (lane >= na) {
    cbounce::dead_lane(xt + lane, n, C_BETA, C_L, C_SPECULAR, C_SEL_PREV,
                       C_WB_PREV, out + lane);
    return;
  }
  cbounce::cbody_lane(xt + lane, n, tb, cfg, out + lane);
}

const void* kernel_for(int staged) {
  return staged == cshade::STAGE_ALL ? (const void*)bounce_shade_kernel<false>
                                     : (const void*)bounce_shade_kernel<true>;
}

}  // namespace

static_assert(sizeof(cbounce::ShadeCfg) == 42 * 4, "ShadeCfg layout");

// C interface.  cfg_words: the ShadeCfg as 42 little-endian 32-bit words
// (host memory); staged: the cshade::STAGE_* bits of the tables staged
// in shared memory (kernels/ops.py stage_plan), the others read in
// place; n_alive: the live count on the device (int32; null: every lane
// is live).  Returns a cudaError_t code (0 = launched).
extern "C" int arendur_bounce_shade(const float* xt, const float* ltab,
                                    int nl, int cl, const float* mtab,
                                    int nm, const float* stab, int ns,
                                    int staged, long n, const int* n_alive,
                                    const void* cfg_words, float* out,
                                    void* stream) {
  if (n <= 0) return 0;
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  const size_t smem = cshade::staged_bytes(nl, cl, nm, ns, staged, true);
  int e = cshade::allow_smem(kernel_for(staged), smem);
  if (e) return e;
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  if (staged == cshade::STAGE_ALL)
    bounce_shade_kernel<false><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        xt, ltab, nl, cl, mtab, nm, stab, ns, staged, n, n_alive, cfg, out);
  else
    bounce_shade_kernel<true><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        xt, ltab, nl, cl, mtab, nm, stab, ns, staged, n, n_alive, cfg, out);
  return (int)cudaGetLastError();
}

// What a launch over these tables holds (cshade::occupancy): info[0..4)
// = dynamic shared memory of a block (B), blocks an SM holds at once,
// registers a thread, local memory a thread (B).  Returns a cudaError_t
// code.
extern "C" int arendur_bounce_shade_occupancy(int nl, int cl, int nm, int ns,
                                              int staged, int* info) {
  return cshade::occupancy(kernel_for(staged), BLOCK,
                           cshade::staged_bytes(nl, cl, nm, ns, staged, true),
                           info);
}
