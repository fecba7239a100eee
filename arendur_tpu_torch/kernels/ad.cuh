// Reverse-mode differentiation for the bounce-shade backward kernel.
//
// ad::R is a float that, when it depends on a differentiable input,
// names the node of a per-thread tape that produced it.  Each
// primitive below writes its node with the local partial derivatives
// of its result with respect to its one or two operands; the backward
// kernel runs the bounce body (cbounce_body.cuh) on R values, which
// records the lane's forward, then sweeps the tape from the last node
// to the first, adding each node's adjoint times its partials into its
// operands' adjoints.  This is the chain rule of autograd over the
// plain PyTorch body, written per primitive; the derivative conventions
// are PyTorch's, so the kernel agrees with autograd over the plain
// version:
//   * clamp(x, lo, hi), and max / min against a constant (torch.clamp):
//     the full gradient where lo <= x <= hi, none outside and none for
//     NaN, applied as a select (a NaN adjoint outside does not leak);
//   * max of two values (torch.maximum): half each at a tie;
//   * |x|: sign(x), so 0 at 0;
//   * nextafter: the identity (one ulp);
//   * a ?: select: the whole adjoint to the chosen operand.
// Constants (no node) carry no gradient.
//
// Tape layout: one 16-byte record per node, written with one vector
// store and read back with one vector load; node k of tape slot g sits
// at record k * stride + g, so a warp that records in step writes 512
// contiguous bytes per node and a warp out of step one sector per lane.
// A node holds its two operand nodes as 16-bit indices (-1: none), its
// two partials and its adjoint.  A leaf (an input column or a table
// element) has no operands; its first index is -(2 + slot) and its
// second the column, so the sweep knows where its adjoint goes.
#pragma once

#include <math.h>

#include "cmath.cuh"

namespace ad {

struct alignas(16) Node {
  unsigned par;  // operand nodes: low 16 bits a, high 16 bits b
  float da, db;  // partials with respect to a and b
  float adj;     // adjoint, accumulated by the sweep
};

struct Tape {
  Node* node;
  long stride;  // tape slots (threads)
  int cap;      // nodes per slot
};

#ifdef __CUDACC__
constexpr int MAX_THREADS = 128;  // threads of a block that use a tape
__shared__ Tape s_tape;
__shared__ int s_count[MAX_THREADS];
#endif
inline Tape h_tape;
inline int h_count;

HD Tape& tape() {
#ifdef __CUDA_ARCH__
  return s_tape;
#else
  return h_tape;
#endif
}
HD int& count() {
#ifdef __CUDA_ARCH__
  return s_count[threadIdx.x];
#else
  return h_count;
#endif
}
HD long tape_slot() {
#ifdef __CUDA_ARCH__
  return (long)blockIdx.x * blockDim.x + threadIdx.x;
#else
  return 0;
#endif
}
HD long at(int k) { return (long)k * tape().stride + tape_slot(); }

// The node's record in one store (adjoint 0), and read back in one load.
// On the card both go to the L2 and not the L1 (st / ld.global.cg): the
// sweep's adjoint reductions are made in the L2, and a record is read
// once per thread, so the L1 keeps the body's stack instead.
HD void put(long k, unsigned par, float da, float db) {
#ifdef __CUDA_ARCH__
  __stcg(reinterpret_cast<float4*>(tape().node + k),
         make_float4(__uint_as_float(par), da, db, 0.0f));
#else
  tape().node[k] = Node{par, da, db, 0.0f};
#endif
}
HD Node get(const Node* p) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  return Node{__float_as_uint(v.x), v.y, v.z, v.w};
#else
  return *p;
#endif
}
// *p += v; on the card a reduction that the thread does not wait for
// (red.global.add.f32: rounds to nearest, flushes subnormals to zero)
HD void add(float* p, float v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

struct R {
  float v;
  int i;  // tape node, -1: a constant
  HD R() : v(0.0f), i(-1) {}
  HD R(float x) : v(x), i(-1) {}
  HD explicit operator int() const { return (int)v; }
};

#ifdef __CUDACC__
#define AD_CALL static __host__ __device__ __noinline__
#else
#define AD_CALL inline
#endif

// Writes a node; returns a constant when neither operand is on the
// tape.  When the tape is full the count moves past cap (the lane is
// then reported as failed) and the result is a constant.  (A call, not
// inlined: every operation of the body records through it.)
AD_CALL R node(float v, int a, float pa, int b, float pb) {
  R r(v);
  if (a < 0 && b < 0) return r;
  int& n = count();
  Tape& t = tape();
  if (n >= t.cap) {
    n = t.cap + 1;
    return r;
  }
  put(at(n), ((unsigned)a & 0xffffu) | ((unsigned)b << 16), pa, pb);
  r.i = n++;
  return r;
}
AD_CALL R leaf(float v, int slot, int col) {
  R r(v);
  int& n = count();
  Tape& t = tape();
  if (n >= t.cap) {
    n = t.cap + 1;
    return r;
  }
  put(at(n), ((unsigned)(-2 - slot) & 0xffffu) | ((unsigned)col << 16),
      0.0f, 0.0f);
  r.i = n++;
  return r;
}
HD R unary(float v, R a, float pa) { return node(v, a.i, pa, -1, 0.0f); }
// the whole adjoint to a when pass holds, none otherwise (a select)
HD R gate(float v, R a, bool pass) { return node(v, pass ? a.i : -1, 1.0f, -1, 0.0f); }

HD float val(R a) { return a.v; }

HD R operator+(R a, R b) { return node(a.v + b.v, a.i, 1.0f, b.i, 1.0f); }
HD R operator+(R a, float b) { return unary(a.v + b, a, 1.0f); }
HD R operator+(float a, R b) { return unary(a + b.v, b, 1.0f); }
HD R operator-(R a, R b) { return node(a.v - b.v, a.i, 1.0f, b.i, -1.0f); }
HD R operator-(R a, float b) { return unary(a.v - b, a, 1.0f); }
HD R operator-(float a, R b) { return unary(a - b.v, b, -1.0f); }
HD R operator-(R a) { return unary(-a.v, a, -1.0f); }
HD R operator*(R a, R b) { return node(a.v * b.v, a.i, b.v, b.i, a.v); }
HD R operator*(R a, float b) { return unary(a.v * b, a, b); }
HD R operator*(float a, R b) { return unary(a * b.v, b, a); }
// d(a/b)/db = -(a/b)/b, PyTorch's order
HD R operator/(R a, R b) {
  float q = a.v / b.v;
  return node(q, a.i, 1.0f / b.v, b.i, -(q / b.v));
}
HD R operator/(R a, float b) { return unary(a.v / b, a, 1.0f / b); }
HD R operator/(float a, R b) {
  float q = a / b.v;
  return unary(q, b, -(q / b.v));
}

#define AD_CMP(op)                                                   \
  HD bool operator op(R a, R b) { return a.v op b.v; }               \
  HD bool operator op(R a, float b) { return a.v op b; }             \
  HD bool operator op(float a, R b) { return a op b.v; }
AD_CMP(<)
AD_CMP(>)
AD_CMP(<=)
AD_CMP(>=)
AD_CMP(==)
AD_CMP(!=)
#undef AD_CMP

HD R sqrtf(R a) {
  float r = ::sqrtf(a.v);
  return unary(r, a, 1.0f / (2.0f * r));
}
HD R rsqrtf(R a) {
  float r = ::rsqrtf(a.v);
  return unary(r, a, -0.5f * (r * r * r));
}
HD R expf(R a) {
  float r = ::expf(a.v);
  return unary(r, a, r);
}
HD R logf(R a) { return unary(::logf(a.v), a, 1.0f / a.v); }
HD R sinf(R a) { return unary(::sinf(a.v), a, ::cosf(a.v)); }
HD R cosf(R a) { return unary(::cosf(a.v), a, -::sinf(a.v)); }
HD R powf(R a, float e) {
  return unary(::powf(a.v, e), a, e == 0.0f ? 0.0f : e * ::powf(a.v, e - 1.0f));
}
HD R fabsf(R a) {
  float s = a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : a.v);
  return unary(::fabsf(a.v), a, s);
}
HD R nextafterf(R a, float to) { return unary(::nextafterf(a.v, to), a, 1.0f); }

// the cmath primitives (kernels/cmath.cuh) on R
HD bool fin(R x) { return isfinite(x.v); }
HD R mx(R x, float c) { return gate(cmath::mx(x.v, c), x, x.v >= c); }
HD R mn(R x, float c) { return gate(cmath::mn(x.v, c), x, x.v <= c); }
HD R clampf_(R x, float lo, float hi) {
  return gate(cmath::clampf_(x.v, lo, hi), x, x.v >= lo && x.v <= hi);
}
HD R mxx(R a, R b) {
  float pa = a.v == b.v ? 0.5f : 1.0f, pb = pa;
  return node(cmath::mxx(a.v, b.v), a.v < b.v ? -1 : a.i, pa,
              a.v > b.v ? -1 : b.i, pb);
}

// A table row on the tape: each element read is a leaf of the row's
// slot, so the sweep can add its adjoint to the lane's share of that
// table row.
struct Row {
  const float* p;
  int slot;
  int off;
  HD R operator[](int c) const { return leaf(p[c], slot, off + c); }
  HD Row operator+(int k) const {
    Row r = *this;
    r.p += k;
    r.off += k;
    return r;
  }
};
HD float rawf(Row r, int c) { return r.p[c]; }

}  // namespace ad
