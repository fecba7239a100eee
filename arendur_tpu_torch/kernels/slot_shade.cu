// The BSDF slot sweeps of the composed path for Hopper (sm_90a): the
// slot-sample kernel (K8) replaces the Pallas TPU kernel
// arendur_tpu/bxdf/pallas_shade.py::_sample_kernel (entry bsdf_sample),
// the eval-pdf kernel (K9) replaces ::_eval_pdf_kernel (entry
// bsdf_eval_pdf).  Their entries are bxdf/slot_shade.py's.
//
// One thread per lane over a lane-major (component) wave: the BSDF of a
// lane is SLOT_COLS = 12 + 12 K columns [SLOT_COLS, N] (frame ns ts bs
// ng, then per slot type, kind, dist, c0, c1, p0, p1, p2), followed by
// wo and u (K8, [53, N] -> f wi pdf kind [8, N]) or wo and wi (K9,
// [54, N] -> f pdf [4, N]).  Neighbouring threads read neighbouring
// addresses of every column, so each load and store is coalesced (the
// TPU kernels' [N, 13 + 12 K + 5] row pack would make each thread read
// a 200-byte row).  The bodies are the slot sweeps the bounce kernels
// run (cbounce_body.cuh bsdf_sample / bsdf_eval_pdf), over the kinds in
// `types`, specialised by the same host-static ShadeCfg presence and
// distribution sets; the light fields of the ShadeCfg are unused here.
//
// Bound: per lane K8 moves 61 floats and K9 58 (244 and 232 B), ~15 MB
// at N = 65,536, ~4.6 us at the HBM rate; a few hundred f32 operations
// per lane take about as long at the f32 peak, so both kernels sit near
// the balance point and their time is the latency of one long
// per-thread program with divergent slot families.
#include <cuda_runtime.h>
#include <string.h>

#include "cbounce.cuh"

namespace {

using cmath::V3;
using cmath::v3;

constexpr int K = cshade::MAX_SLOTS;
constexpr int SLOT_COLS = 12 + 12 * K;
constexpr int C_TYPE = 12, C_KIND = 12 + K, C_DIST = 12 + 2 * K;
constexpr int C_C0 = 12 + 3 * K, C_C1 = 12 + 6 * K;
constexpr int C_P0 = 12 + 9 * K, C_P1 = 12 + 10 * K, C_P2 = 12 + 11 * K;
constexpr int SAMPLE_IN_COLS = SLOT_COLS + 5, SAMPLE_OUT_COLS = 8;
constexpr int EVAL_IN_COLS = SLOT_COLS + 6, EVAL_OUT_COLS = 4;
constexpr int BLOCK = 128;

__device__ __forceinline__ V3 col3(const float* x, long n, int c) {
  return v3(x[(long)c * n], x[(long)(c + 1) * n], x[(long)(c + 2) * n]);
}

__device__ __forceinline__ void read_slots(const float* x, long n,
                                           cbounce::Slots* b) {
  b->ns = col3(x, n, 0);
  b->ts = col3(x, n, 3);
  b->bs = col3(x, n, 6);
  b->ng = col3(x, n, 9);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b->type[k] = (int)x[(long)(C_TYPE + k) * n];
    b->kind[k] = (int)x[(long)(C_KIND + k) * n];
    b->dist[k] = (int)x[(long)(C_DIST + k) * n];
    b->c0[k] = col3(x, n, C_C0 + 3 * k);
    b->c1[k] = col3(x, n, C_C1 + 3 * k);
    b->p0[k] = x[(long)(C_P0 + k) * n];
    b->p1[k] = x[(long)(C_P1 + k) * n];
    b->p2[k] = x[(long)(C_P2 + k) * n];
  }
}

__global__ void __launch_bounds__(BLOCK)
    slot_sample_kernel(const float* __restrict__ xt, long n, int types,
                       cbounce::ShadeCfg cfg, float* __restrict__ out) {
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* x = xt + lane;
  cbounce::Slots b;
  read_slots(x, n, &b);
  V3 wo = col3(x, n, SLOT_COLS);
  float ux = x[(long)(SLOT_COLS + 3) * n], uy = x[(long)(SLOT_COLS + 4) * n];
  V3 f, wi;
  float pdf;
  int kind;
  cbounce::bsdf_sample(b, wo, ux, uy, cfg, &f, &wi, &pdf, &kind, types);
  float r[SAMPLE_OUT_COLS] = {f.x, f.y, f.z, wi.x, wi.y, wi.z, pdf,
                              (float)kind};
  for (int j = 0; j < SAMPLE_OUT_COLS; ++j) out[(long)j * n + lane] = r[j];
}

__global__ void __launch_bounds__(BLOCK)
    slot_eval_pdf_kernel(const float* __restrict__ xt, long n, int types,
                         cbounce::ShadeCfg cfg, float* __restrict__ out) {
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* x = xt + lane;
  cbounce::Slots b;
  read_slots(x, n, &b);
  V3 wo = col3(x, n, SLOT_COLS), wi = col3(x, n, SLOT_COLS + 3);
  V3 f;
  float pdf;
  cbounce::bsdf_eval_pdf(b, wo, wi, cfg, &f, &pdf, types);
  float r[EVAL_OUT_COLS] = {f.x, f.y, f.z, pdf};
  for (int j = 0; j < EVAL_OUT_COLS; ++j) out[(long)j * n + lane] = r[j];
}

}  // namespace

static_assert(sizeof(cbounce::ShadeCfg) == 42 * 4, "ShadeCfg layout");

// C interface.  xt: [SAMPLE_IN_COLS, n] / [EVAL_IN_COLS, n] lane-major;
// cfg_words: the ShadeCfg as 42 little-endian 32-bit words (host
// memory).  Each returns a cudaError_t code (0 = launched).
extern "C" int arendur_slot_sample(const float* xt, long n, int types,
                                   const void* cfg_words, float* out,
                                   void* stream) {
  if (n <= 0) return 0;
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  slot_sample_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(xt, n, types,
                                                               cfg, out);
  return (int)cudaGetLastError();
}

extern "C" int arendur_slot_eval_pdf(const float* xt, long n, int types,
                                     const void* cfg_words, float* out,
                                     void* stream) {
  if (n <= 0) return 0;
  cbounce::ShadeCfg cfg;
  memcpy(&cfg, cfg_words, sizeof(cfg));
  unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  slot_eval_pdf_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      xt, n, types, cfg, out);
  return (int)cudaGetLastError();
}
