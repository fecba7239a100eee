// Bounce-shade backward kernel for Hopper (sm_90a): replaces the Pallas
// TPU kernel arendur_tpu/render/cbounce.py::_bwd_kernel (launched by
// _run_bwd), the VJP of the bounce shade (cbounce.cu).  Entry:
// render/cbounce.py::_BounceShadeKernel.backward.
//
// In: the wave xt [IN_COLS=58, N], the light / material / sphere tables
// and the output cotangent ct [OUT_COLS=32, N].  Out: the input
// cotangent dx [58, N] (every column; flag and index columns get 0, as
// jax.vjp gives them) and the table cotangents summed over lanes.
//
// The TPU kernel recomputes the forward in-kernel and applies jax.vjp
// there.  Here one thread takes one lane: it records the lane's forward
// (cbounce_body.cuh on the taped scalar of ad.cuh) on its own tape in
// device memory, then sweeps the tape backwards (cbounce_ad.cuh).  The
// tables stay in shared memory, as in the forward kernel; each table
// element the lane reads is a tape leaf whose adjoint goes to the
// lane's share of that table row.
//
// The TPU sums the table cotangents by += across its sequential grid;
// blocks here run concurrently, so the sum is taken in two more
// launches, in a fixed order and without float atomics: a partial sum
// per 256 lanes (one thread per table column and row slot walks its
// lanes in order), then a sum of the partials in block order.  Two
// launches on the same input give bit-identical table cotangents.
//
// Bound: per lane the kernel reads 90 floats and writes 58, but it
// also writes and reads back its tape: about 940 nodes of 16 bytes for
// a lane of a Cornell camera wave, up to ~2,300 on fuzzed lanes, plus
// the adjoint updates.  At N = 65,536 that is some 3 GB of tape
// traffic, so the kernel is bound by device-memory bytes of its tape,
// not by the arithmetic of the few thousand operations per lane.
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce_ad.cuh"

namespace {

constexpr int BLOCK = ad::MAX_THREADS;
constexpr int RED_LANES = 256;   // lanes per partial table sum
constexpr int RED_THREADS = 256;

struct TabLayout {
  // lane_tab columns of each row slot (base[s]..base[s+1]) and the
  // offset of each row slot's [rows, cols] region in a partial
  int base[cshade::N_ROW_SLOTS + 1];
  int off[cshade::N_ROW_SLOTS + 1];
  int rows[cshade::N_ROW_SLOTS];
  __host__ __device__ TabLayout(int nl, int cl, int nm, int ns) {
    int cols[4] = {16, cl, cl, 24};
    int nrows[4] = {nm, nl, nl, ns};
    base[0] = 0;
    off[0] = 0;
    for (int s = 0; s < 4; ++s) {
      rows[s] = nrows[s];
      base[s + 1] = base[s] + cols[s];
      off[s + 1] = off[s] + nrows[s] * cols[s];
    }
  }
};

__global__ void __launch_bounds__(BLOCK)
    bounce_shade_bwd_kernel(const float* __restrict__ xt,
                            const float* __restrict__ ct,
                            const float* __restrict__ ltab, int nl, int cl,
                            const float* __restrict__ mtab, int nm,
                            const float* __restrict__ stab, int ns, long n,
                            cshade::ShadeCfg cfg, ad::Tape tape,
                            float* __restrict__ dx,
                            float* __restrict__ lane_tab,
                            int* __restrict__ lane_rows,
                            unsigned long long* __restrict__ node_stats) {
  extern __shared__ float smem[];
  const int nlt = nl * cl, nmt = nm * 16, nst = ns * 24;
  float* sl = smem;
  float* sm = sl + nlt;
  float* ss = sm + nmt;
  for (int i = threadIdx.x; i < nlt; i += blockDim.x) sl[i] = ltab[i];
  for (int i = threadIdx.x; i < nmt; i += blockDim.x) sm[i] = mtab[i];
  for (int i = threadIdx.x; i < nst; i += blockDim.x) ss[i] = stab[i];
  if (threadIdx.x == 0) ad::s_tape = tape;
  __syncthreads();
  cshade::Tables tb;
  tb.ltab = sl;
  tb.nl = nl;
  tb.cl = cl;
  tb.mtab = sm;
  tb.nm = nm;
  tb.stab = ss;
  tb.ns = ns;
  TabLayout lay(nl, cl, nm, ns);
  const int p = lay.base[4];
  const long step = (long)gridDim.x * blockDim.x;
  unsigned long long most = 0, total = 0;
  for (long lane = (long)blockIdx.x * blockDim.x + threadIdx.x; lane < n;
       lane += step) {
    int rows[cshade::N_ROW_SLOTS];
    cbounce_ad::cbody_lane_bwd(xt + lane, ct + lane, n, tb, cfg, dx + lane,
                               lane_tab + lane * p, lay.base, rows);
    for (int s = 0; s < cshade::N_ROW_SLOTS; ++s)
      lane_rows[s * n + lane] = rows[s];
    const unsigned long long used = (unsigned long long)ad::count();
    most = used > most ? used : most;
    total += used;
  }
  // integer atomics: the result does not depend on their order
  atomicMax(node_stats, most);
  atomicAdd(node_stats + 1, total);
}

// partial[b] = sum over lanes [b * RED_LANES, (b + 1) * RED_LANES) of the
// lanes' table shares, per row slot; one thread per (row slot, column)
// walks the lanes in order, so no two threads write one element.
__global__ void __launch_bounds__(RED_THREADS)
    table_partials_kernel(const float* __restrict__ lane_tab,
                          const int* __restrict__ lane_rows, long n, int nl,
                          int cl, int nm, int ns,
                          float* __restrict__ partials) {
  TabLayout lay(nl, cl, nm, ns);
  const int p = lay.base[4];
  float* part = partials + (long)blockIdx.x * lay.off[4];
  const long l0 = (long)blockIdx.x * RED_LANES;
  const long l1 = l0 + RED_LANES < n ? l0 + RED_LANES : n;
  for (int pc = threadIdx.x; pc < p; pc += blockDim.x) {
    int s = 0;
    while (pc >= lay.base[s + 1]) ++s;
    const int c = pc - lay.base[s];
    const int ncols = lay.base[s + 1] - lay.base[s];
    float* reg = part + lay.off[s];
    for (int r = 0; r < lay.rows[s]; ++r) reg[r * ncols + c] = 0.0f;
    for (long l = l0; l < l1; ++l)
      reg[lane_rows[s * n + l] * ncols + c] += lane_tab[l * p + pc];
  }
}

// The table cotangents: the partials summed in block order (the two
// light-row slots of a partial in slot order).
__global__ void table_reduce_kernel(const float* __restrict__ partials,
                                    int nblk, int nl, int cl, int nm, int ns,
                                    float* __restrict__ dlt,
                                    float* __restrict__ dmt,
                                    float* __restrict__ dst) {
  TabLayout lay(nl, cl, nm, ns);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nmt = nm * 16, nlt = nl * cl, nst = ns * 24;
  if (e >= nmt + nlt + nst) return;
  float acc = 0.0f;
  if (e < nmt) {
    for (int b = 0; b < nblk; ++b)
      acc += partials[(long)b * lay.off[4] + lay.off[0] + e];
    dmt[e] = acc;
  } else if (e < nmt + nlt) {
    const int k = e - nmt;
    for (int b = 0; b < nblk; ++b) {
      const float* part = partials + (long)b * lay.off[4];
      acc += part[lay.off[1] + k];
      acc += part[lay.off[2] + k];
    }
    dlt[k] = acc;
  } else {
    const int k = e - nmt - nlt;
    for (int b = 0; b < nblk; ++b)
      acc += partials[(long)b * lay.off[4] + lay.off[3] + k];
    dst[k] = acc;
  }
}

}  // namespace

// C interface.  cfg_words: the ShadeCfg as 42 32-bit words (host
// memory).  Scratch, all device memory from the caller: the tape
// (par, da, db, adj: cap * tape_threads each), lane_tab [n, p] zeroed,
// lane_rows [4, n], partials [ceil(n / 256), E] and node_stats [2]
// zeroed (it receives the most tape nodes a lane used and their sum
// over lanes), where p = 16 + 2 cl + 24 and E = 16 nm + 2 nl cl + 24 ns.
// tape_threads must be a multiple of 128.  Returns a cudaError_t code
// (0 = launched).
extern "C" int arendur_bounce_shade_bwd(
    const float* xt, const float* ct, const float* ltab, int nl, int cl,
    const float* mtab, int nm, const float* stab, int ns, long n,
    const void* cfg_words, unsigned* tape_par, float* tape_da,
    float* tape_db, float* tape_adj, long tape_threads, int cap,
    float* dx, float* lane_tab, int* lane_rows, float* partials,
    float* dlt, float* dmt, float* dst, unsigned long long* node_stats,
    void* stream) {
  if (n <= 0) return 0;
  cshade::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  ad::Tape tape;
  tape.par = tape_par;
  tape.da = tape_da;
  tape.db = tape_db;
  tape.adj = tape_adj;
  tape.stride = tape_threads;
  tape.cap = cap;
  size_t smem = sizeof(float) * ((size_t)nl * cl + (size_t)nm * 16 +
                                 (size_t)ns * 24);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bounce_shade_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  unsigned grid = (unsigned)(tape_threads / BLOCK);
  bounce_shade_bwd_kernel<<<grid, BLOCK, smem, st>>>(
      xt, ct, ltab, nl, cl, mtab, nm, stab, ns, n, cfg, tape, dx, lane_tab,
      lane_rows, node_stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nblk = (int)((n + RED_LANES - 1) / RED_LANES);
  table_partials_kernel<<<nblk, RED_THREADS, 0, st>>>(lane_tab, lane_rows, n,
                                                       nl, cl, nm, ns,
                                                       partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int ne = nm * 16 + nl * cl + ns * 24;
  table_reduce_kernel<<<(ne + 255) / 256, 256, 0, st>>>(
      partials, nblk, nl, cl, nm, ns, dlt, dmt, dst);
  return (int)cudaGetLastError();
}
