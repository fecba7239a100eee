// Bounce-shade backward kernel (K4) for Hopper (sm_90a): replaces the
// Pallas TPU kernel arendur_tpu/render/cbounce.py::_bwd_kernel
// (launched by _run_bwd), the VJP of the bounce shade (cbounce.cu).
// Entry: render/cbounce.py::_BounceShadeKernel.backward.
//
// In: the wave xt [IN_COLS=58, N], the light / material / sphere tables
// and the output cotangent ct [OUT_COLS=32, N].  Out: the input
// cotangent dx [58, N] (every column; flag and index columns get 0, as
// jax.vjp gives them) and the table cotangents summed over lanes.
//
// The TPU kernel recomputes the forward in-kernel and applies jax.vjp
// there, on every lane.  Here the backward is five launches:
//   1. classify: one thread per lane decides whether the lane's VJP
//      needs the body (cbounce_ad.cuh needs_body).  Where the lane is
//      past the wave's live count (the forward passed it through), or
//      adds no emission and its cotangent is zero outside L, dx is the
//      cotangent of L, beta and wb_prev on their input columns
//      (pass_through), written here.  In a train step that is a third
//      of the first bounce's lanes and most of the later ones';
//   2. list: one block turns the flags into the list of lanes that need
//      the body, in lane order, and its count, by a prefix sum over the
//      flags (deterministic; no host sync: the later launches read the
//      count on the device);
//   3. tape: one thread per listed lane records the lane's forward
//      (cbounce_body.cuh on the taped scalar of ad.cuh) on its own tape
//      in device memory, then sweeps the tape backwards
//      (cbounce_ad.cuh cbody_lane_bwd).  The tables stay in shared
//      memory, as in the forward kernel (those that do not fit a block
//      are read in place: kernels/ops.py stage_plan); each table
//      element the lane reads is a tape leaf whose adjoint goes to the
//      lane's share of that table row (row i of lane_tab for list
//      position i);
//   4-5. the table cotangents: blocks run concurrently, where the TPU
//      sums by += across its sequential grid, so the sum over lanes is
//      taken in a fixed order and without atomics shared by threads: a
//      partial sum per 256 list positions (one thread per table column
//      and row slot walks its positions in order), then a sum of the
//      partials in block order.  Two launches on the same input give
//      bit-identical results.
//
// Bound: the work moves the lanes' 90 input and 58 output floats and
// the tables, but a listed lane also writes and reads back its tape:
// ~940 nodes of 16 bytes on a Cornell camera-wave lane, ~1,400 on the
// lanes a train step's later bounces list, up to ~2,300.  The design
// cuts those bytes twice: only listed lanes tape, and a node is one
// 16-byte record written with one vector store and read with one
// vector load, laid out node-major across the threads (ad.cuh).  What
// bounds a launch then is the serial chain of its longest lane: on an
// H100 a launch that lists 481 lanes takes 1.6 ms and one that lists
// 13,060 takes 2.3 ms (tools/k4_bounces.py), each lane's nodes taking
// some hundreds of cycles of memory latency apiece.  So the sweep hides
// what latency it can: it loads each record a few nodes ahead and adds
// its operands' adjoints without waiting on them (cbody_lane_bwd).
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce_ad.cuh"

namespace {

using cbounce_ad::TabLayout;

constexpr int BLOCK = ad::MAX_THREADS;
constexpr int CLASSIFY_THREADS = 256;
constexpr int LIST_THREADS = 1024;  // 32 warps, one scan word each
constexpr int LIST_RUN = 8;         // consecutive lanes per thread and tile
constexpr int RED_LANES = 256;      // list positions per partial sum
constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(CLASSIFY_THREADS)
    bounce_shade_bwd_classify_kernel(const float* __restrict__ xt,
                                     const float* __restrict__ ct,
                                     const float* __restrict__ stab, int ns,
                                     long n,
                                     const int* __restrict__ n_alive,
                                     int* __restrict__ need,
                                     float* __restrict__ dx) {
  const cshade::Tables tb =
      cshade::dense_tables(nullptr, 0, 0, nullptr, 0, stab, ns);
  const long na = n_alive ? *n_alive : n;
  const long step = (long)gridDim.x * blockDim.x;
  for (long lane = (long)blockIdx.x * blockDim.x + threadIdx.x; lane < n;
       lane += step) {
    const bool body =
        cbounce_ad::needs_body(xt + lane, ct + lane, n, lane, na, tb);
    need[lane] = body;
    if (!body) cbounce_ad::pass_through(ct + lane, n, dx + lane);
  }
}

// list[0..count) = the lanes whose flag is set, in lane order.  One
// block walks the flags in tiles of LIST_THREADS * LIST_RUN lanes, each
// thread a run of LIST_RUN consecutive lanes: the flagged lanes of each
// run counted, an inclusive scan of the counts over the warp and of the
// 32 warp totals, and each flagged lane's place = the tile's base + the
// flagged lanes before it.  Also sets node_stats: [0], [1] to 0 (the
// tape kernel's max and sum of nodes) and [2] to the count.
__global__ void __launch_bounds__(LIST_THREADS)
    bounce_shade_bwd_list_kernel(const int* __restrict__ need, long n,
                                 int* __restrict__ list,
                                 int* __restrict__ count,
                                 unsigned long long* __restrict__ node_stats) {
  __shared__ int warp_incl[LIST_THREADS / 32];
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5;
  int base = 0;
  for (long t0 = 0; t0 < n; t0 += (long)LIST_THREADS * LIST_RUN) {
    const long l0 = t0 + (long)threadIdx.x * LIST_RUN;
    unsigned bits = 0;
    for (int k = 0; k < LIST_RUN; ++k)
      if (l0 + k < n && need[l0 + k] != 0) bits |= 1u << k;
    const int c = __popc(bits);
    int v = c;  // flagged lanes of this warp's runs up to this one
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (wl >= o) v += u;
    }
    if (wl == 31) warp_incl[w] = v;
    __syncthreads();
    if (w == 0) {
      int t = warp_incl[wl];
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, t, o);
        if (wl >= o) t += u;
      }
      warp_incl[wl] = t;
    }
    __syncthreads();
    int pos = base + (w ? warp_incl[w - 1] : 0) + v - c;
    for (int k = 0; k < LIST_RUN; ++k)
      if ((bits >> k) & 1u) list[pos++] = (int)(l0 + k);
    base += warp_incl[LIST_THREADS / 32 - 1];
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    *count = base;
    node_stats[0] = 0;
    node_stats[1] = 0;
    node_stats[2] = (unsigned long long)base;
  }
}

// INPLACE false: every table staged (the launch of every scene whose
// tables fit); true: the tables `staged` names (cshade::STAGE_*) staged,
// the others read in place from global memory at the same dense pitch
template <bool INPLACE>
__global__ void __launch_bounds__(BLOCK)
    bounce_shade_bwd_kernel(const float* __restrict__ xt,
                            const float* __restrict__ ct,
                            const float* __restrict__ ltab, int nl, int cl,
                            const float* __restrict__ mtab, int nm,
                            const float* __restrict__ stab, int ns,
                            int staged, long n,
                            const int* __restrict__ list,
                            const int* __restrict__ count,
                            cshade::ShadeCfg cfg, ad::Tape tape,
                            float* __restrict__ dx,
                            float* __restrict__ lane_tab,
                            int* __restrict__ lane_rows,
                            unsigned long long* __restrict__ node_stats) {
  const long m = *count;
  if ((long)blockIdx.x * blockDim.x >= m) return;  // the whole block idles
  extern __shared__ float smem[];
  const cshade::Tables tb = cshade::stage_tables(
      ltab, nl, cl, mtab, nm, stab, ns,
      INPLACE ? staged : cshade::STAGE_ALL, false, smem);
  if (threadIdx.x == 0) ad::s_tape = tape;
  __syncthreads();
  TabLayout lay(nl, cl, nm, ns);
  const int p = lay.base[4];
  const long step = (long)gridDim.x * blockDim.x;
  unsigned long long most = 0, total = 0;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const long lane = list[i];
    float* tab = lane_tab + i * p;
    for (int c = 0; c < p; ++c) tab[c] = 0.0f;
    int rows[cshade::N_ROW_SLOTS];
    cbounce_ad::cbody_lane_bwd(xt + lane, ct + lane, n, tb, cfg, dx + lane,
                               tab, lay.base, rows);
    for (int s = 0; s < cshade::N_ROW_SLOTS; ++s)
      lane_rows[s * n + i] = rows[s];
    const unsigned long long used = (unsigned long long)ad::count();
    most = used > most ? used : most;
    total += used;
  }
  // integer atomics: the result does not depend on their order
  atomicMax(node_stats, most);
  atomicAdd(node_stats + 1, total);
}

// partial[b] = sum over list positions [b * RED_LANES, (b + 1) *
// RED_LANES) of the lanes' table shares, per row slot; one thread per
// (row slot, column) walks the positions in order, so no two threads
// write one element.  Blocks past the count write nothing.
__global__ void __launch_bounds__(RED_THREADS)
    bounce_shade_bwd_partials_kernel(const float* __restrict__ lane_tab,
                                     const int* __restrict__ lane_rows,
                                     long n, const int* __restrict__ count,
                                     int nl, int cl, int nm, int ns,
                                     float* __restrict__ partials) {
  const long m = *count;
  const long l0 = (long)blockIdx.x * RED_LANES;
  if (l0 >= m) return;
  const long l1 = l0 + RED_LANES < m ? l0 + RED_LANES : m;
  TabLayout lay(nl, cl, nm, ns);
  const int p = lay.base[4];
  float* part = partials + (long)blockIdx.x * lay.off[4];
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

// The table cotangents: the partials of the count's blocks summed in
// block order (the two light-row slots of a partial in slot order).
__global__ void bounce_shade_bwd_reduce_kernel(
    const float* __restrict__ partials, const int* __restrict__ count,
    int nl, int cl, int nm, int ns, float* __restrict__ dlt,
    float* __restrict__ dmt, float* __restrict__ dst) {
  TabLayout lay(nl, cl, nm, ns);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nmt = nm * 16, nlt = nl * cl, nst = ns * 24;
  if (e >= nmt + nlt + nst) return;
  const int nblk = (*count + RED_LANES - 1) / RED_LANES;
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
// memory).  n_alive: the wave's live count on the device (int32; null:
// every lane is live).  Scratch, all device memory from the caller, none of it
// zeroed: the tape (cap * tape_threads nodes of 16 bytes), lists
// [2 n + 1] int (flags, list, count), lane_tab [n, p], lane_rows
// [4, n], partials [ceil(n / 256), E] and node_stats [3] (it receives
// the most tape nodes a listed lane used, their sum over the listed
// lanes and the number of listed lanes), where p = 16 + 2 cl + 24 and
// E = 16 nm + 2 nl cl + 24 ns.  tape_threads must be a multiple of
// 128.  staged: the cshade::STAGE_* bits of the tables the tape kernel
// stages in shared memory (kernels/ops.py stage_plan), the others read
// in place.  Returns a cudaError_t code (0 = launched).
extern "C" int arendur_bounce_shade_bwd(
    const float* xt, const float* ct, const float* ltab, int nl, int cl,
    const float* mtab, int nm, const float* stab, int ns, int staged, long n,
    const int* n_alive, const void* cfg_words, void* tape_nodes,
    long tape_threads, int cap,
    int* lists, float* dx, float* lane_tab, int* lane_rows, float* partials,
    float* dlt, float* dmt, float* dst, unsigned long long* node_stats,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) {  // no lane: zero cotangents and statistics
    void* zero[4] = {dlt, dmt, dst, node_stats};
    size_t bytes[4] = {sizeof(float) * nl * cl, sizeof(float) * nm * 16,
                       sizeof(float) * ns * 24, 3 * sizeof(*node_stats)};
    for (int k = 0; k < 4; ++k) {
      cudaError_t e = cudaMemsetAsync(zero[k], 0, bytes[k], st);
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
  cshade::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  ad::Tape tape;
  tape.node = (ad::Node*)tape_nodes;
  tape.stride = tape_threads;
  tape.cap = cap;
  int* need = lists;
  int* list = lists + n;
  int* count = lists + 2 * n;
  const bool all = staged == cshade::STAGE_ALL;
  const size_t smem = cshade::staged_bytes(nl, cl, nm, ns, staged, false);
  {
    const int e = cshade::allow_smem(
        all ? (const void*)bounce_shade_bwd_kernel<false>
            : (const void*)bounce_shade_bwd_kernel<true>,
        smem);
    if (e) return e;
  }
  const unsigned cgrid =
      (unsigned)((n + CLASSIFY_THREADS - 1) / CLASSIFY_THREADS);
  bounce_shade_bwd_classify_kernel<<<cgrid, CLASSIFY_THREADS, 0, st>>>(
      xt, ct, stab, ns, n, n_alive, need, dx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bounce_shade_bwd_list_kernel<<<1, LIST_THREADS, 0, st>>>(need, n, list,
                                                           count, node_stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(tape_threads / BLOCK);
  if (all)
    bounce_shade_bwd_kernel<false><<<grid, BLOCK, smem, st>>>(
        xt, ct, ltab, nl, cl, mtab, nm, stab, ns, staged, n, list, count,
        cfg, tape, dx, lane_tab, lane_rows, node_stats);
  else
    bounce_shade_bwd_kernel<true><<<grid, BLOCK, smem, st>>>(
        xt, ct, ltab, nl, cl, mtab, nm, stab, ns, staged, n, list, count,
        cfg, tape, dx, lane_tab, lane_rows, node_stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nblk = (int)((n + RED_LANES - 1) / RED_LANES);
  bounce_shade_bwd_partials_kernel<<<nblk, RED_THREADS, 0, st>>>(
      lane_tab, lane_rows, n, count, nl, cl, nm, ns, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int ne = nm * 16 + nl * cl + ns * 24;
  bounce_shade_bwd_reduce_kernel<<<(ne + 255) / 256, 256, 0, st>>>(
      partials, count, nl, cl, nm, ns, dlt, dmt, dst);
  return (int)cudaGetLastError();
}
