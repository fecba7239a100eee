// The differentiable shading math (cmath_body.cuh) on the taped scalar
// ad::R: the half of kernels/cmath.cuh the backward kernel records.
#pragma once

#include "ad.cuh"
#include "cmath.cuh"

namespace cmath_ad {

using namespace cdefs;
using ad::R;
using ad::Row;
using ad::rawf;
using ad::val;
// R overloads, and the float ones for the float arithmetic the body
// does on values
using ad::clampf_;
using ad::fin;
using ad::mn;
using ad::mx;
using ad::mxx;
using cmath::clampf_;
using cmath::fin;
using cmath::mn;
using cmath::mx;
using cmath::mxx;
typedef R F;

// every recorded operation writes a tape node, so the larger functions
// are real calls here: inlining them all would make one function too
// large for the compiler to build in reasonable time
#undef HDB
#ifdef __CUDACC__
#define HDB static __host__ __device__ __noinline__
#else
#define HDB inline
#endif

#include "cmath_body.cuh"

// a value's float form, for the float-only routines, and a float
// vector's constant form (no gradient flows through it)
HD cmath::V3 vval(V3 a) { return cmath::v3(a.x.v, a.y.v, a.z.v); }
HD V3 vconst(cmath::V3 a) { return v3(a.x, a.y, a.z); }

}  // namespace cmath_ad
