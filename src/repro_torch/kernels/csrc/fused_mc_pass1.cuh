// Pass 1 of the fused multi-family Monte-Carlo kernel for Hopper (sm_90a):
// the per-block sample loops and their launch, shared by the sources that
// each build some of its instantiations (fused_mc.cu and
// fused_mc_{compact,adapted,sobol,sobol_compact,sobol_adapted}.cu, compiled
// in parallel and linked into one library).  What the kernel computes, what
// bounds it and why it is deterministic: fused_mc.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "zmc_device.cuh"

namespace zmc {

// The arguments of one pass-1 launch (see fused_mc_pass1 and zmc_fused_mc).
struct Pass1Args {
  uint32_t k0, k1, sample_offset, n_valid, round_stride;
  int n_rounds;
  const uint32_t* round_base;
  const uint32_t* fn_ids;
  const int32_t* block_meta;
  int n_sweep;
  const uint32_t* sobol_dirs;
  const float* packed;
  int n_cols;
  const float* lo;
  const float* hi;
  int dim, n_fn_pad, n_chunks;
  float* scratch;
};

// One launcher per pass-1 instantiation <STAGES, SOBOL, SWEPT>, each
// defined in the source that builds it.
cudaError_t launch_pass1_plain(const Pass1Args&, unsigned, size_t, cudaStream_t);    // <0, false, false>
cudaError_t launch_pass1_swept(const Pass1Args&, unsigned, size_t, cudaStream_t);    // <0, false, true>
cudaError_t launch_pass1_compact(const Pass1Args&, unsigned, size_t, cudaStream_t);  // <1, false, true>
cudaError_t launch_pass1_adapted(const Pass1Args&, unsigned, size_t, cudaStream_t);  // <2, false, true>
cudaError_t launch_pass1_sobol(const Pass1Args&, unsigned, size_t, cudaStream_t);    // <0, true, true>
cudaError_t launch_pass1_sobol_compact(const Pass1Args&, unsigned, size_t, cudaStream_t);  // <1, true, true>
cudaError_t launch_pass1_sobol_adapted(const Pass1Args&, unsigned, size_t, cudaStream_t);  // <2, true, true>

}  // namespace zmc

namespace {


constexpr int F_BLK = 16;
constexpr int S_BLK = 2048;
constexpr int CHUNK_BLOCKS = 8;
constexpr int CHUNK_SAMPLES = CHUNK_BLOCKS * S_BLK;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// One axis of a compactified block, as a call: the Sobol transform loop
// unrolls its 16 functions, and inlined there the precise tanf/cosf would
// be copied into each of them.  Returns (x, dx/du) in registers.
__device__ __noinline__ float2 transform_axis(float x, float kind, float shift) {
  float jac;
  const float y = zmc::apply_transform(x, kind, shift, &jac);
  return make_float2(y, jac);
}

// The wrapper stages of a block, STAGE: 0 none; 1 the compactification
// (the transform of every axis, at column tcol); 2 the importance grid (the
// map of every axis through its edges from column acol), then the
// compactification where tcol >= 0 (a test uniform across the CUDA block,
// so it never diverges).  Each stage's Jacobian product is folded into the
// value after the body, the transform's first, as repro composes them.
// INLINE: the transform inlined (the MC loop, one function at a time), or
// the call above (the Sobol loop).
template <int STAGE, bool INLINE>
__device__ __forceinline__ float stage_axis(float x, const float* __restrict__ p, int tcol,
                                            int acol, int n_bins, int d, int dim,
                                            float& jac_t, float& jac_a) {
  if (STAGE == 2) {
    float w;
    x = zmc::apply_map_axis(x, p + acol + d * (n_bins + 1), n_bins, &w);
    jac_a *= w;
  }
  if (STAGE == 1 || (STAGE == 2 && tcol >= 0)) {
    float j;
    if constexpr (INLINE) {
      x = zmc::apply_transform(x, p[tcol + d], p[tcol + dim + d], &j);
    } else {
      const float2 xj = transform_axis(x, p[tcol + d], p[tcol + dim + d]);
      x = xj.x;
      j = xj.y;
    }
    jac_t *= j;
  }
  return x;
}

template <int STAGE>
__device__ __forceinline__ float staged_value(float v, float jac_t, float jac_a) {
  if (STAGE == 1) return v * jac_t;
  if (STAGE == 2) return v * jac_t * jac_a;
  return v;
}

// s1 += v and s2 += v * v for one value, each sum rounded as the compiler
// rounded it in the loop order with the 16 functions inside each sample,
// where it chose per site whether to fuse v * v + s2 into one FMA: it did
// for every form and stage of the MC draws, and for every form and stage
// of the Sobol draws except the forms whose value ends in expf (the
// Gaussian and the Genz corner peak) without a grid (STAGE 0 or 1); it
// never fused v's own last multiply into s1 += v (measured on every form
// and loop with `kernel_ab`'s every_form variants).  Each loop order gives
// the compiler other sites, so each sum's rounding is pinned here with the
// _rn intrinsics, which it never contracts, and every loop gives the same
// bits.
template <int FORM, int STAGE, bool SOBOL>
__device__ __forceinline__ void add_sums(float& s1, float& s2, float v) {
  s1 = __fadd_rn(s1, v);
  if constexpr (SOBOL && (FORM == zmc::FORM_GAUSSIAN || FORM == zmc::FORM_GENZ_CORNER) &&
                STAGE < 2)
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  else
    s2 = __fmaf_rn(v, v, s2);
}

// One function's sums over a warp's 32 lanes into red[warp][f]: a shuffle
// tree in a fixed order, lane 0 ending with the warp's sums.
__device__ __forceinline__ void warp_partial(float (&red)[WARPS][F_BLK][2], int f, float a,
                                             float b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][f][0] = a;
    red[threadIdx.x >> 5][f][1] = b;
  }
}

// The MC draw of a compactified block (STAGE 1, or 2: after the grid): one
// function at a time, each the thread's whole run of samples (c0, c0 + 256,
// ...) with its dims inside, its sums in two registers, reduced over the
// warp into red when the run ends.  A thread's sums take the same values
// in the same sample order as with the 16 functions inside each sample, so
// the bits do not depend on the loop order.  No 16-wide arrays stay live
// through the loop (it needs 40 registers alone), and the function loop is
// not unrolled, so the transform (its precise tanf, cosf and divisions) is
// inlined once per form instead of called: no call barrier, no registers
// saved around it, and the draws, the transform and the body of one sample
// schedule together.
template <int FORM, int STAGE>
__device__ __forceinline__ void eval_chunk(const float* __restrict__ p_s,
                                           const uint4* __restrict__ tab,
                                           int n_cols, int tcol, int acol, int n_bins,
                                           int dim, uint32_t k0, uint32_t k1,
                                           uint32_t window, uint32_t begin, uint64_t end,
                                           float (&red)[WARPS][F_BLK][2]) {
#pragma unroll 1
  for (int f = 0; f < F_BLK; ++f) {
    const float* p = p_s + f * n_cols;
    float s1 = 0.0f, s2 = 0.0f;
    for (uint64_t local = (uint64_t)begin + threadIdx.x; local < end; local += THREADS) {
      const uint32_t c0 = window + (uint32_t)local;
      float acc = zmc::Body<FORM>::init(p);
      float jac = 1.0f, jac_a = 1.0f;
      for (int d = 0; d < dim; ++d) {
        const uint4 a = tab[d * F_BLK + f];
        float x = zmc::affine(__uint_as_float(a.x), __uint_as_float(a.y),
                              zmc::bits_to_uniform(zmc::random_bits(k0, k1, c0, a.z)));
        x = stage_axis<STAGE, true>(x, p, tcol, acol, n_bins, d, dim, jac, jac_a);
        acc = zmc::Body<FORM>::step(acc, x, p, d);
      }
      const float v = staged_value<STAGE>(zmc::Body<FORM>::fin(acc, p, dim), jac, jac_a);
      add_sums<FORM, STAGE, false>(s1, s2, v);
    }
    warp_partial(red, f, s1, s2);
  }
}

static_assert(THREADS == 256, "SobolRun and zmc::sobol_walk step 256 indices");

// One thread's Sobol points along its run of samples c0, c0 + 256, ...
// (local = begin + tid + k * 256: THREADS must be 256): one register per
// dim (top 24 bits; v holds the direction vectors' top 24 bits,
// u32[dim][32]), built in full at the run's first sample and walked in
// Gray-code order after each (zmc::sobol_walk: two XORs per dim, in place
// of the 32 of a rebuild).  dim is a runtime value, so each dim loop here
// is unrolled to SOBOL_MAX_DIM behind a d < dim test, and `at` selects a
// dim's register by value: the points never leave registers.
struct SobolRun {
  uint32_t pt[zmc::SOBOL_MAX_DIM];

  __device__ __forceinline__ void start(const uint32_t* __restrict__ v, int dim, uint32_t c0) {
#pragma unroll
    for (int d = 0; d < zmc::SOBOL_MAX_DIM; ++d)
      pt[d] = d < dim ? zmc::sobol_point(v + 32 * d, c0) : 0u;
  }

  // From the run's sample next - 256 to sample next.
  __device__ __forceinline__ void step(const uint32_t* __restrict__ v, int dim, uint32_t next) {
#pragma unroll
    for (int d = 0; d < zmc::SOBOL_MAX_DIM; ++d)
      if (d < dim) pt[d] = zmc::sobol_walk(v + 32 * d, pt[d], next);
  }

  __device__ __forceinline__ uint32_t at(int d) const {
    uint32_t r = pt[0];
#pragma unroll
    for (int k = 1; k < zmc::SOBOL_MAX_DIM; ++k) r = d == k ? pt[k] : r;
    return r;
  }
};

// A block's loop dim by dim, the 16 functions inside each dim: for the MC
// and Sobol launches without stages (the main path's among them), and for
// the blocks of either sampler with an importance grid and no
// compactification (ADAPT).  The 16 functions' chains are independent, so
// a dim's shared-memory loads (its row of tab: lo, hi - lo and the shift
// or c1 of each function; the grid edges) and its draws (16 Threefry
// chains, or the shifted point) overlap across functions instead of
// waiting one function at a time.  Each function's float operations are
// those of eval_chunk and stage_axis, in the same order, and add_sums
// rounds its sums as the loops it replaced did, so they are bit-identical.
template <int FORM, bool SOBOL, bool ADAPT>
__device__ __forceinline__ void eval_chunk_dims(const float* __restrict__ p_s,
                                                const uint4* __restrict__ tab,
                                                const uint32_t* __restrict__ v_s, int n_cols,
                                                int acol, int n_bins, int dim, uint32_t k0,
                                                uint32_t k1, uint32_t window, uint32_t begin,
                                                uint64_t end, float (&s1)[F_BLK],
                                                float (&s2)[F_BLK]) {
  SobolRun run;
  if constexpr (SOBOL) run.start(v_s, dim, window + begin + threadIdx.x);
  for (uint64_t local = (uint64_t)begin + threadIdx.x; local < end; local += THREADS) {
    const uint32_t c0 = window + (uint32_t)local;
    float acc[F_BLK], jac_a[F_BLK];
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) {
      acc[f] = zmc::Body<FORM>::init(p_s + f * n_cols);
      jac_a[f] = 1.0f;
    }
    for (int d = 0; d < dim; ++d) {
      const uint4* t = tab + d * F_BLK;
      const uint32_t pd = SOBOL ? run.at(d) : 0u;
#pragma unroll
      for (int f = 0; f < F_BLK; ++f) {
        const uint4 a = t[f];
        const float* p = p_s + f * n_cols;
        const float u = SOBOL ? zmc::sobol_uniform(pd, a.z)
                              : zmc::bits_to_uniform(zmc::random_bits(k0, k1, c0, a.z));
        float x = zmc::affine(__uint_as_float(a.x), __uint_as_float(a.y), u);
        if constexpr (ADAPT) {
          float w;
          x = zmc::apply_map_axis(x, p + acol + d * (n_bins + 1), n_bins, &w);
          jac_a[f] *= w;
        }
        acc[f] = zmc::Body<FORM>::step(acc[f], x, p, d);
      }
    }
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) {
      float v = zmc::Body<FORM>::fin(acc[f], p_s + f * n_cols, dim);
      if constexpr (ADAPT) v = staged_value<2>(v, 1.0f, jac_a[f]);
      add_sums<FORM, ADAPT ? 2 : 0, SOBOL>(s1[f], s2[f], v);
    }
    if constexpr (SOBOL) run.step(v_s, dim, c0 + THREADS);
  }
}

// The Sobol draw through a compactified block's transform (STAGE 1, or 2:
// after the grid): the function loop outside, the dim loop inside, as in
// eval_chunk (the transform is a call, and 16 functions' chains kept live
// across it would spill); the point from the run's registers.
template <int FORM, int STAGE>
__device__ __forceinline__ void eval_chunk_sobol(const float* __restrict__ p_s,
                                                 const uint4* __restrict__ tab,
                                                 const uint32_t* __restrict__ v_s,
                                                 int n_cols, int tcol, int acol, int n_bins,
                                                 int dim, uint32_t window, uint32_t begin,
                                                 uint64_t end, float (&s1)[F_BLK],
                                                 float (&s2)[F_BLK]) {
  SobolRun run;
  run.start(v_s, dim, window + begin + threadIdx.x);
  for (uint64_t local = (uint64_t)begin + threadIdx.x; local < end; local += THREADS) {
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) {
      const float* p = p_s + f * n_cols;
      float acc = zmc::Body<FORM>::init(p);
      float jac = 1.0f, jac_a = 1.0f;
      for (int d = 0; d < dim; ++d) {
        const uint4 a = tab[d * F_BLK + f];
        float x = zmc::affine(__uint_as_float(a.x), __uint_as_float(a.y),
                              zmc::sobol_uniform(run.at(d), a.z));
        x = stage_axis<STAGE, false>(x, p, tcol, acol, n_bins, d, dim, jac, jac_a);
        acc = zmc::Body<FORM>::step(acc, x, p, d);
      }
      const float v = staged_value<STAGE>(zmc::Body<FORM>::fin(acc, p, dim), jac, jac_a);
      add_sums<FORM, STAGE, true>(s1[f], s2[f], v);
    }
    run.step(v_s, dim, window + (uint32_t)local + THREADS);
  }
}

// Pass 1.  Block b handles function block fb, round r and sample chunk c,
// b = (fb * n_rounds + r) * n_chunks + c.  block_meta is
// i32[4 + 2 * n_sweep, n_fn_pad / 16]: row 0 the block's form id, row 1 -1
// for a plain block or the first of a compactified block's 2 * dim
// transform columns, rows 2 + 2j and 3 + 2j the j-th (base column, table
// column) pair of a swept block (-1: none), row 2 + 2 n_sweep -1 for an
// unadapted block or the first of an adapted block's dim * (n_bins + 1)
// grid-edge columns, and row 3 + 2 n_sweep its n_bins.  Dynamic shared
// memory: first the table every loop reads, u32x4[dim, 16] (lo, hi - lo,
// and the shift's top 24 bits or c1 of each (dim, function)); then the
// packed rows f32[16, n_cols]; and for SOBOL the direction vectors' top 24
// bits u32[dim, 32].
// Every block without a transform column runs eval_chunk_dims (with the
// grid where acol >= 0); a block with one runs eval_chunk (MC) or
// eval_chunk_sobol.  SWEPT compiles the sweep pairs' copy in (taken when
// n_sweep > 0 and the block is swept); STAGES 1 adds the compactified
// blocks' loop (taken where tcol >= 0), STAGES 2 the adapted blocks' loops
// too (taken where acol >= 0).  Seven instantiations, built from six
// sources in parallel (launch_pass1 below): the MC launch without staged or
// swept blocks (<0, false, false>, the main path) runs code and a register
// allocation that neither the stages, the Sobol point nor the copy shape
// (the copy alone, in the load phase, cost it 0.35%); MC swept launches
// have <0, false, true>; MC launches with compactified blocks
// <1, false, true> and with adapted ones <2, false, true> (sharing one
// instantiation cost the compactified blocks 1.0%); Sobol launches
// <0|1|2, true, true>, each with the copy in.  The adapted and the Sobol
// instantiations are held to two blocks per SM (128 registers); the others
// name no minimum (0): a minimum of 3 for the main path's 96 registers
// spilled and cost it 1.3%.  A swept block differs from its per-point
// families only in that copy: the sample loop does the same float
// operations on the same values.
template <int STAGES, bool SOBOL, bool SWEPT>
__global__ void __launch_bounds__(THREADS, (SOBOL || STAGES == 2) ? 2 : 0)
fused_mc_pass1(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
               uint32_t round_stride, int n_rounds, const uint32_t* __restrict__ round_base,
               const uint32_t* __restrict__ fn_ids, const int32_t* __restrict__ block_meta,
               int n_sweep, const uint32_t* __restrict__ sobol_dirs,
               const float* __restrict__ packed, int n_cols, const float* __restrict__ lo,
               const float* __restrict__ hi, int dim, int n_fn_pad, int n_chunks,
               float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[WARPS][F_BLK][2];
  uint4* tab = reinterpret_cast<uint4*>(smem);
  float* p_s = smem + 4 * F_BLK * dim;
  uint32_t* v_s = reinterpret_cast<uint32_t*>(p_s + F_BLK * n_cols);

  const int chunk = blockIdx.x % n_chunks;
  const int fr = blockIdx.x / n_chunks;
  const int r = fr % n_rounds;
  const int fb = fr / n_rounds;
  const int row0 = fb * F_BLK;
  const int n_fblocks = n_fn_pad / F_BLK;
  for (int i = threadIdx.x; i < F_BLK * n_cols; i += THREADS)
    p_s[i] = packed[(size_t)row0 * n_cols + i];
  if constexpr (SOBOL) {
    for (int i = threadIdx.x; i < 32 * dim; i += THREADS) v_s[i] = sobol_dirs[i] >> 8;
  }
  for (int i = threadIdx.x; i < F_BLK * dim; i += THREADS) {
    const int d = i / F_BLK, f = i % F_BLK;
    const size_t j = (size_t)(row0 + f) * dim + d;
    const float l = lo[j];
    const uint32_t c1 = fn_ids[row0 + f] * zmc::DIM_STRIDE + (uint32_t)d;
    tab[i] = make_uint4(__float_as_uint(l), __float_as_uint(hi[j] - l),
                        SOBOL ? zmc::sobol_shift(k0, k1, c1) >> 8 : c1, 0u);
  }
  __syncthreads();
  // a swept block: each table column over the base column it overrides
  // (a base column sits before every table column, so no copy reads a
  // column another one writes)
  if (SWEPT && n_sweep > 0 && block_meta[2 * n_fblocks + fb] >= 0) {
    for (int i = threadIdx.x; i < F_BLK * n_sweep; i += THREADS) {
      const int f = i / n_sweep, j = i % n_sweep;
      const int dst = block_meta[(2 + 2 * j) * n_fblocks + fb];
      if (dst >= 0)
        p_s[f * n_cols + dst] = p_s[f * n_cols + block_meta[(3 + 2 * j) * n_fblocks + fb]];
    }
    __syncthreads();
  }

  // the dim-outer loops' sums; eval_chunk reduces its own into red
  float s1[F_BLK], s2[F_BLK];
#pragma unroll
  for (int f = 0; f < F_BLK; ++f) s1[f] = s2[f] = 0.0f;
  bool in_red = false;

  // round r's window, in u32 arithmetic that wraps as the TPU kernel's does
  const uint32_t window = sample_offset + (round_base != nullptr ? round_base[fb] : 0u) +
                          (uint32_t)r * round_stride;
  const uint32_t begin = (uint32_t)chunk * CHUNK_SAMPLES;
  const uint64_t chunk_end = (uint64_t)begin + CHUNK_SAMPLES;
  const uint64_t end = chunk_end < n_valid ? chunk_end : (uint64_t)n_valid;
  const int tcol = block_meta[n_fblocks + fb];
  int acol = -1, n_bins = 0;
  if constexpr (STAGES == 2) {
    acol = block_meta[(2 + 2 * n_sweep) * n_fblocks + fb];
    n_bins = block_meta[(3 + 2 * n_sweep) * n_fblocks + fb];
  }
  // form, tcol and acol are uniform across the block, so this switch never
  // diverges
#define ZMC_DIMS(FORM, ADAPT)                                                            \
  eval_chunk_dims<FORM, SOBOL, ADAPT>(p_s, tab, v_s, n_cols, acol, n_bins, dim, k0, k1,  \
                                      window, begin, end, s1, s2);
#define ZMC_RUN(FORM, S)                                                                 \
  if constexpr (S == 0) {                                                                \
    ZMC_DIMS(FORM, false)                                                                \
  } else if constexpr (SOBOL) {                                                          \
    eval_chunk_sobol<FORM, S>(p_s, tab, v_s, n_cols, tcol, S == 2 ? acol : -1,           \
                              S == 2 ? n_bins : 0, dim, window, begin, end, s1, s2);     \
  } else {                                                                               \
    eval_chunk<FORM, S>(p_s, tab, n_cols, tcol, S == 2 ? acol : -1, S == 2 ? n_bins : 0,  \
                        dim, k0, k1, window, begin, end, red);                           \
    in_red = true;                                                                       \
  }
#define ZMC_EVAL(FORM)          \
  if constexpr (STAGES == 2) {  \
    if (acol >= 0) {            \
      if (tcol >= 0) {          \
        ZMC_RUN(FORM, 2)        \
      } else {                  \
        ZMC_DIMS(FORM, true)    \
      }                         \
      break;                    \
    }                           \
  }                             \
  if constexpr (STAGES >= 1) {  \
    if (tcol >= 0) {            \
      ZMC_RUN(FORM, 1)          \
      break;                    \
    }                           \
  }                             \
  ZMC_RUN(FORM, 0)              \
  break;
  switch (block_meta[fb]) {
    case zmc::FORM_HARMONIC: ZMC_EVAL(zmc::FORM_HARMONIC)
    case zmc::FORM_ABS_SUM: ZMC_EVAL(zmc::FORM_ABS_SUM)
    case zmc::FORM_GAUSSIAN: ZMC_EVAL(zmc::FORM_GAUSSIAN)
    case zmc::FORM_GENZ_OSC: ZMC_EVAL(zmc::FORM_GENZ_OSC)
    case zmc::FORM_GENZ_CORNER: ZMC_EVAL(zmc::FORM_GENZ_CORNER)
    default:  // unknown form id: poison the block's sums rather than guess
#pragma unroll
      for (int f = 0; f < F_BLK; ++f) s1[f] = s2[f] = zmc::quiet_nan();
  }
#undef ZMC_EVAL
#undef ZMC_RUN
#undef ZMC_DIMS

  if (!in_red) {
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) warp_partial(red, f, s1[f], s2[f]);
  }
  __syncthreads();
  if (threadIdx.x < F_BLK * 2) {
    const int f = threadIdx.x >> 1, comp = threadIdx.x & 1;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red[w][f][comp];
    scratch[(((size_t)r * n_fn_pad + row0 + f) * n_chunks + chunk) * 2 + comp] = acc;
  }
}

// One pass-1 launch of an instantiation, and the CUDA error it reports.
template <int STAGES, bool SOBOL, bool SWEPT>
cudaError_t launch_pass1(const zmc::Pass1Args& a, unsigned n_blocks, size_t smem,
                         cudaStream_t s) {
  const auto kernel = fused_mc_pass1<STAGES, SOBOL, SWEPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_blocks, THREADS, smem, s>>>(a.k0, a.k1, a.sample_offset, a.n_valid,
                                         a.round_stride, a.n_rounds, a.round_base, a.fn_ids,
                                         a.block_meta, a.n_sweep, a.sobol_dirs, a.packed,
                                         a.n_cols, a.lo, a.hi, a.dim, a.n_fn_pad, a.n_chunks,
                                         a.scratch);
  return cudaGetLastError();
}

}  // namespace
