// Per-sample arithmetic of the fused Monte-Carlo kernel, shared by the
// device code (fused_mc.cu) and a host build (tests compile this header
// with g++ and hold it against the PyTorch plain versions).
//
// Everything here is a pure function of its arguments, marked host and
// device through ZMC_HD:
//   * Threefry-2x32, 20 rounds, first output word (random_bits);
//   * the top-24-bit uniform (bits_to_uniform);
//   * the five eval bodies of repro/kernels/mc_eval/{kernel,ops}.py;
//   * the compactification of one axis (apply_transform), the per-axis
//     map of repro/core/domains.py:apply_transform that the wrapper stage
//     repro/kernels/template.py:compactified_body puts around a body;
//   * the Sobol point of one index on one dim (sobol_point, the Gray-code
//     construction of repro/core/sobol.py:sobol_bits and
//     repro/kernels/template.py:sobol_tiles), the step from one index's
//     point to that of the index 256 on (sobol_walk) and the digital
//     shift (sobol_shift, repro/core/sobol.py:shifts_for);
//   * the VEGAS importance map of one axis (apply_map_axis), the per-axis
//     arithmetic of repro/core/adaptive.py:apply_map that the wrapper stage
//     repro/kernels/template.py:adapted_body puts around a body.
//
// A body is written as a fold over the dimensions: acc = init(p), then
// acc = step(acc, x_d, p, d) for d = 0..dim-1, then value = fin(acc, p, dim).
// Each form's step adds one per-dimension term, in the same order as the
// reference body, so no per-sample array of coordinates is needed.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define ZMC_HD __host__ __device__ __forceinline__
#define ZMC_UNROLL _Pragma("unroll")
#else
#define ZMC_HD inline
#define ZMC_UNROLL
#endif

namespace zmc {

// c1 = fn_id * DIM_STRIDE + d (repro.core.rng.DIM_STRIDE).
constexpr uint32_t DIM_STRIDE = 256u;

// Form ids, in registration order (repro_torch/kernels/mc_eval/ops.py).
enum Form : int {
  FORM_HARMONIC = 0,
  FORM_ABS_SUM = 1,
  FORM_GAUSSIAN = 2,
  FORM_GENZ_OSC = 3,
  FORM_GENZ_CORNER = 4,
  N_FORMS = 5,
};

ZMC_HD uint32_t rotl32(uint32_t x, int r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

#define ZMC_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r);   \
  x1 ^= x0;

#define ZMC_TF_GROUP_A ZMC_TF_ROUND(13) ZMC_TF_ROUND(15) ZMC_TF_ROUND(26) ZMC_TF_ROUND(6)
#define ZMC_TF_GROUP_B ZMC_TF_ROUND(17) ZMC_TF_ROUND(29) ZMC_TF_ROUND(16) ZMC_TF_ROUND(24)

// First output word of Threefry-2x32 (Random123), 20 rounds.
ZMC_HD uint32_t random_bits(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  ZMC_TF_GROUP_A x0 += k1; x1 += k2 + 1u;
  ZMC_TF_GROUP_B x0 += k2; x1 += k0 + 2u;
  ZMC_TF_GROUP_A x0 += k0; x1 += k1 + 3u;
  ZMC_TF_GROUP_B x0 += k1; x1 += k2 + 4u;
  ZMC_TF_GROUP_A x0 += k2; x1 += k0 + 5u;
  (void)x1;
  return x0;
}

#undef ZMC_TF_GROUP_A
#undef ZMC_TF_GROUP_B
#undef ZMC_TF_ROUND

// Top 24 bits times 2^-24: exact in f32, in [0, 1).
ZMC_HD float bits_to_uniform(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f;
}

// -- Sobol points ----------------------------------------------------------
// Most dims a Sobol family may have (repro.core.sobol.MAX_DIM: the Joe-Kuo
// table's rows); direction vectors are u32[dim][32].
constexpr int SOBOL_MAX_DIM = 8;
// Counter plane of the digital shifts (repro.core.sobol.shifts_for).
constexpr uint32_t SOBOL_SHIFT_C0 = 0x50B01u;

// Unshifted Sobol point of index idx on one dim: the XOR of the direction
// vectors v[j] picked by the set bits of gray(idx) = idx ^ (idx >> 1).
ZMC_HD uint32_t sobol_point(const uint32_t* v, uint32_t idx) {
  const uint32_t gray = idx ^ (idx >> 1);
  uint32_t acc = 0u;
  ZMC_UNROLL
  for (int j = 0; j < 32; ++j)
    if ((gray >> j) & 1u) acc ^= v[j];
  return acc;
}

// The Gray-code walk along a stride-256 run of indices (a pass-1 thread's
// samples idx, idx + 256, ...).  From idx to next = idx + 256 (u32 wrap),
// gray(idx) changes in exactly two bits: bit 7 (idx's bit 8 flips, its
// bit 7 does not) and bit 8 + ctz(next >> 8), the Gray step of the 24-bit
// count idx >> 8.  Where that count wraps to 0 (next crosses 2^32) its Gray
// code loses its top bit, gray bit 31: ctz of the count with bit 23 set
// gives both cases.  So the point of next is the point of idx XOR v[7] XOR
// v[sobol_walk_bit(next)], bit for bit, for direction vectors v of any
// width (the kernel keeps their top 24 bits).
ZMC_HD int sobol_walk_bit(uint32_t next) {
  const uint32_t h = (next >> 8) | 0x800000u;
#if defined(__CUDA_ARCH__)
  return 7 + __ffs((int)h);
#else
  return 8 + __builtin_ctz(h);
#endif
}

ZMC_HD uint32_t sobol_walk(const uint32_t* v, uint32_t point, uint32_t next) {
  return point ^ v[7] ^ v[sobol_walk_bit(next)];
}

// Digital shift of (function, dim) with c1 = fn_id * DIM_STRIDE + d.
ZMC_HD uint32_t sobol_shift(uint32_t k0, uint32_t k1, uint32_t c1) {
  return random_bits(k0, k1, SOBOL_SHIFT_C0, c1);
}

// The uniform of a shifted point from the top 24 bits of point and shift
// ((point ^ shift) >> 8 == (point >> 8) ^ (shift >> 8)): bits_to_uniform
// of point ^ shift, exactly.
ZMC_HD float sobol_uniform(uint32_t point_top24, uint32_t shift_top24) {
  return (float)(point_top24 ^ shift_top24) * 5.9604644775390625e-08f;
}

// Quiet NaN: marks a sum the kernel could not compute (unknown form id).
ZMC_HD float quiet_nan() {
#if defined(__CUDA_ARCH__)
  return __int_as_float(0x7fffffff);
#else
  return NAN;
#endif
}

// x = lo + u * (hi - lo); the caller passes w = hi - lo.
ZMC_HD float affine(float lo, float w, float u) { return lo + u * w; }

// -- compactification of one axis -----------------------------------------
// Kind codes (repro.core.domains.TRANSFORM_*); they ride in f32 packed
// columns as exact small integers.
enum Transform : int {
  TRANSFORM_NONE = 0,   // finite edge: identity
  TRANSFORM_TAN = 1,    // (-inf, inf): x = tan(pi (u - 1/2))
  TRANSFORM_UPPER = 2,  // [a, inf):    x = a + u / (1 - u)
  TRANSFORM_LOWER = 3,  // (-inf, b]:   x = b - u / (1 - u)
};

// u is clamped into [CLIP_EPS, 1 - CLIP_EPS] before a map so it stays finite.
constexpr float CLIP_EPS = 1e-7f;
constexpr float PI_F = 3.14159265358979323846f;

// Maps u (the draw in the finite sampling box) through the axis' transform;
// returns x and writes the Jacobian dx/du to *jac (1 on a finite axis, where
// x = u untouched by the clamp).  Precise tanf/cosf: near the clamp the tan
// map's Jacobian pi / cos^2 reaches ~1e14 and the half-line's 1 / (1 - u)^2
// ~1e14, where the fast intrinsics are wrong.
ZMC_HD float apply_transform(float u, float kind, float shift, float* jac) {
  const int k = (int)kind;
  if (k == TRANSFORM_NONE) {
    *jac = 1.0f;
    return u;
  }
  const float uc = fminf(fmaxf(u, CLIP_EPS), 1.0f - CLIP_EPS);
  if (k == TRANSFORM_TAN) {
    const float a = PI_F * (uc - 0.5f);
    const float c = cosf(a);
    *jac = PI_F / (c * c);
    return tanf(a);
  }
  const float om = 1.0f - uc;
  *jac = 1.0f / (om * om);
  const float rat = uc / om;
  return k == TRANSFORM_UPPER ? shift + rat : shift - rat;
}

// -- the importance map of one axis ----------------------------------------
// e points at the axis' n_bins + 1 edges (strictly increasing).  The bin is
// idx = min((int)(u * n_bins), n_bins - 1), exact in f32 since u carries 24
// bits; x interpolates linearly inside it and *w = n_bins * (e1 - e0) is the
// axis' factor of the Jacobian.  The bin is read directly: repro's unrolled
// select over every bin exists because its TPU compiler rejects gathers.
ZMC_HD float apply_map_axis(float u, const float* e, int n_bins, float* w) {
  const float s = u * (float)n_bins;
  const int t = (int)s;
  const int idx = t < n_bins - 1 ? t : n_bins - 1;
  const float frac = s - (float)idx;
  const float e0 = e[idx];
  const float width = e[idx + 1] - e0;
  *w = width * (float)n_bins;
  return e0 + frac * width;
}

// -- eval bodies ---------------------------------------------------------
// p points at one function's packed parameter row.

template <int FORM>
struct Body;

// a cos(k.x) + b sin(k.x); cols [a, b, k_0..k_{dim-1}]
template <>
struct Body<FORM_HARMONIC> {
  static ZMC_HD float init(const float*) { return 0.0f; }
  static ZMC_HD float step(float acc, float x, const float* p, int d) {
    return acc + p[2 + d] * x;
  }
  static ZMC_HD float fin(float acc, const float* p, int) {
    return p[0] * cosf(acc) + p[1] * sinf(acc);
  }
};

// c |sum_d s_d x_d|; cols [c, s_0..s_{dim-1}]
template <>
struct Body<FORM_ABS_SUM> {
  static ZMC_HD float init(const float*) { return 0.0f; }
  static ZMC_HD float step(float acc, float x, const float* p, int d) {
    return acc + p[1 + d] * x;
  }
  static ZMC_HD float fin(float acc, const float* p, int) { return p[0] * fabsf(acc); }
};

// exp(-1/2 |x|^2 / sigma^2); cols [sigma]
template <>
struct Body<FORM_GAUSSIAN> {
  static ZMC_HD float init(const float*) { return 0.0f; }
  static ZMC_HD float step(float acc, float x, const float*, int) { return acc + x * x; }
  static ZMC_HD float fin(float acc, const float* p, int) {
    return expf(-0.5f * acc / (p[0] * p[0]));
  }
};

// Genz oscillatory cos(2 pi u_1 + sum_d a_d x_d); cols [u_1, a_0..a_{dim-1}]
template <>
struct Body<FORM_GENZ_OSC> {
  static ZMC_HD float init(const float* p) { return 6.2831855f * p[0]; }
  static ZMC_HD float step(float acc, float x, const float* p, int d) {
    return acc + p[1 + d] * x;
  }
  static ZMC_HD float fin(float acc, const float*, int) { return cosf(acc); }
};

// Genz corner peak (1 + sum_d a_d x_d)^-(dim+1) as exp(-(dim+1) log(.));
// cols [a_0..a_{dim-1}]
template <>
struct Body<FORM_GENZ_CORNER> {
  static ZMC_HD float init(const float*) { return 1.0f; }
  static ZMC_HD float step(float acc, float x, const float* p, int d) {
    return acc + p[d] * x;
  }
  static ZMC_HD float fin(float acc, const float*, int dim) {
    return expf(-(float)(dim + 1) * logf(acc));
  }
};

// One body on one point x[0..dim-1]: the host check's entry, and a
// reference for how the kernel composes init/step/fin.
template <int FORM>
ZMC_HD float eval_point(const float* p, const float* x, int dim) {
  float acc = Body<FORM>::init(p);
  for (int d = 0; d < dim; ++d) acc = Body<FORM>::step(acc, x[d], p, d);
  return Body<FORM>::fin(acc, p, dim);
}

ZMC_HD float eval_point_form(int form, const float* p, const float* x, int dim) {
  switch (form) {
    case FORM_HARMONIC: return eval_point<FORM_HARMONIC>(p, x, dim);
    case FORM_ABS_SUM: return eval_point<FORM_ABS_SUM>(p, x, dim);
    case FORM_GAUSSIAN: return eval_point<FORM_GAUSSIAN>(p, x, dim);
    case FORM_GENZ_OSC: return eval_point<FORM_GENZ_OSC>(p, x, dim);
    case FORM_GENZ_CORNER: return eval_point<FORM_GENZ_CORNER>(p, x, dim);
    default: return quiet_nan();
  }
}

// A compactified row: p holds the form's columns, then [kind_0..kind_{dim-1},
// shift_0..shift_{dim-1}] from column tcol.  Maps x through each axis'
// transform and multiplies the body's value by the Jacobian product, as the
// kernel's compactified blocks do.  x holds at most 256 dims (DIM_STRIDE).
ZMC_HD float eval_point_compact(int form, const float* p, int tcol, const float* x,
                                int dim) {
  float xs[256];
  float jac = 1.0f;
  for (int d = 0; d < dim; ++d) {
    float j;
    xs[d] = apply_transform(x[d], p[tcol + d], p[tcol + dim + d], &j);
    jac *= j;
  }
  return eval_point_form(form, p, xs, dim) * jac;
}

// An adapted row: p holds the form's columns, the grid edges from column
// acol (dim * (n_bins + 1), axis-major) and, when tcol >= 0, the transform
// columns.  Maps each u through the grid, then through the axis' transform,
// and multiplies the body's value by the transform's Jacobian product, then
// by the grid's, as the kernel's adapted blocks do.
ZMC_HD float eval_point_adapted(int form, const float* p, int acol, int n_bins, int tcol,
                                const float* u, int dim) {
  float xs[256];
  float jac_t = 1.0f, jac_a = 1.0f;
  for (int d = 0; d < dim; ++d) {
    float w;
    float x = apply_map_axis(u[d], p + acol + d * (n_bins + 1), n_bins, &w);
    jac_a *= w;
    if (tcol >= 0) {
      float j;
      x = apply_transform(x, p[tcol + d], p[tcol + dim + d], &j);
      jac_t *= j;
    }
    xs[d] = x;
  }
  return eval_point_form(form, p, xs, dim) * jac_t * jac_a;
}

}  // namespace zmc
