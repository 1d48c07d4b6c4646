// Fused multi-family Monte-Carlo kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/template.py:_fused_kernel (launched by
// fused_mc_pallas) with the five eval bodies of
// repro/kernels/mc_eval/{kernel,ops}.py selected per 16-function block,
// both samplers (MC, and Sobol: sobol_tiles and the shifted draw of
// :468 and :480-485), the round axis (n_rounds > 1, scalars[4] =
// round_stride, per-block round_base) and two wrapper stages,
// compactified_body and swept_body.  Per function f, round r, sample s
// and dim d it takes
//   c0 = sample_offset + round_base[block] + r * round_stride + s (u32 wrap),
//   c1 = fn_id * 256 + d (u32 wrap),
//   u  = (Threefry-2x32(k, c0, c1)[0] >> 8) * 2^-24                 (MC), or
//   u  = ((sobol_point(V[d], c0) ^ Threefry(k, 0x50B01, c1)[0]) >> 8) * 2^-24
//                                                                (Sobol),
//   x  = lo + u * (hi - lo),
// and, in a compactified block, x -> apply_transform(x, kind, shift) with
// the Jacobian product folded into the value; it evaluates the block's
// body, drops samples past n_valid, and writes (sum f, sum f^2) per round
// and function.  A swept block's rows hold the template's base columns,
// then one table column per swept parameter column: the kernel copies
// each table column over the base column it overrides (the block's sweep
// pairs) as it loads the rows into shared memory, so the body reads the
// point's parameters where it reads a per-point family's, and a swept
// point and the same point launched as its own family run the same
// instructions on the same values: bit-identical sums.
//
// What bounds it: 32-bit integer throughput.  Each draw is one Threefry
// block: at least 63 integer operations (20 rounds of add, rotate, xor and
// the key schedule, less what is the same for every sample of a function
// and dim), of which 38 rotates, xors and shifts can issue only on the
// 64-lane-per-SM ALU pipe; against that stand a few float operations and
// 8 bytes of parameters per (function, dim) for the whole launch.  A
// compactified axis adds a tanf and a cosf (or a division) per draw.  The
// design keeps all of it in registers: no random bit ever touches memory,
// the packed rows and boxes sit in shared memory, each rotate is one funnel
// shift, and the grid (16-function block x round x 16384-sample chunk)
// gives every SM several blocks at the paper's Fig.-1 size.
//
// The Sobol draw has no Threefry: each thread builds the sample's point
// for every dim once (32 XORs of direction vectors picked by gray(c0),
// read from shared memory, into the thread's column of a shared-memory
// table) and shares it among the block's 16 functions;
// a function's draw is one XOR with its shift (computed once per CUDA
// block into shared memory), one u32 -> f32 conversion and the affine
// map.  What bounds it: issue slots, for those few operations per draw
// plus two ALU operations per direction bit of each (sample, block, dim)
// point, which 16 functions share: about a quarter of an MC draw's work.
//
// Determinism: no float atomics.  Pass 1 reduces each block's per-thread
// partials in a fixed order (warp shuffles, then shared memory across
// warps) into scratch[n_rounds, n_fn_pad, n_chunks, 2]; pass 2 sums each
// (round, function)'s chunk partials in index order.  Chunks start at 0
// within each round's window, so round r of an R-round launch runs the
// same instructions and fold as a single-round launch at that round's
// offset: the two are bit-identical, and so are repeated launches.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (repro_torch/kernels/build.py), never
// with --use_fast_math: the harmonic phase reaches hundreds of radians,
// and the compactified maps reach u = 1e-7 from a pole, where the fast
// cosf/sinf/tanf are wrong.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zmc_device.cuh"

namespace {

constexpr int F_BLK = 16;
constexpr int S_BLK = 2048;
constexpr int CHUNK_BLOCKS = 8;
constexpr int CHUNK_SAMPLES = CHUNK_BLOCKS * S_BLK;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// One axis of a compactified block.  Not inlined: the precise tanf/cosf
// would otherwise be copied into each of the 16 unrolled functions of
// every form's loop.  Returns (x, dx/du) in registers.
__device__ __noinline__ float2 transform_axis(float x, float kind, float shift) {
  float jac;
  const float y = zmc::apply_transform(x, kind, shift, &jac);
  return make_float2(y, jac);
}

template <int FORM, bool COMPACT>
__device__ __forceinline__ void eval_chunk(const float* __restrict__ p_s,
                                           const float* __restrict__ lo_s,
                                           const float* __restrict__ w_s,
                                           const uint32_t* __restrict__ c1_s,
                                           int n_cols, int tcol, int dim, uint32_t k0,
                                           uint32_t k1, uint32_t window,
                                           uint32_t begin, uint64_t end,
                                           float (&s1)[F_BLK], float (&s2)[F_BLK]) {
  for (uint64_t local = (uint64_t)begin + threadIdx.x; local < end; local += THREADS) {
    const uint32_t c0 = window + (uint32_t)local;
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) {
      const float* p = p_s + f * n_cols;
      float acc = zmc::Body<FORM>::init(p);
      float jac = 1.0f;
      for (int d = 0; d < dim; ++d) {
        const uint32_t bits = zmc::random_bits(k0, k1, c0, c1_s[f] + (uint32_t)d);
        float x = zmc::affine(lo_s[f * dim + d], w_s[f * dim + d],
                              zmc::bits_to_uniform(bits));
        if (COMPACT) {
          const float2 xj = transform_axis(x, p[tcol + d], p[tcol + dim + d]);
          x = xj.x;
          jac *= xj.y;
        }
        acc = zmc::Body<FORM>::step(acc, x, p, d);
      }
      float v = zmc::Body<FORM>::fin(acc, p, dim);
      if (COMPACT) v *= jac;
      s1[f] += v;
      s2[f] += v * v;
    }
  }
}

// The Sobol draw: the point of sample c0 (top 24 bits per dim) is built
// once per sample, outside the function loop, into the thread's own
// column of pt_s (u32[dim, THREADS] in shared memory: a register array
// indexed by the runtime dim would go to local memory); v_s holds the
// direction vectors u32[dim][32], sh_s the top 24 bits of each
// (function, dim)'s shift.  The function and dim loops are the MC loop's.
template <int FORM, bool COMPACT>
__device__ __forceinline__ void eval_chunk_sobol(const float* __restrict__ p_s,
                                                 const float* __restrict__ lo_s,
                                                 const float* __restrict__ w_s,
                                                 const uint32_t* __restrict__ v_s,
                                                 const uint32_t* __restrict__ sh_s,
                                                 uint32_t* __restrict__ pt_s,
                                                 int n_cols, int tcol, int dim,
                                                 uint32_t window, uint32_t begin,
                                                 uint64_t end, float (&s1)[F_BLK],
                                                 float (&s2)[F_BLK]) {
  uint32_t* pt = pt_s + threadIdx.x;
  for (uint64_t local = (uint64_t)begin + threadIdx.x; local < end; local += THREADS) {
    const uint32_t c0 = window + (uint32_t)local;
    for (int d = 0; d < dim; ++d) pt[d * THREADS] = zmc::sobol_point(v_s + 32 * d, c0) >> 8;
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) {
      const float* p = p_s + f * n_cols;
      float acc = zmc::Body<FORM>::init(p);
      float jac = 1.0f;
      for (int d = 0; d < dim; ++d) {
        float x = zmc::affine(lo_s[f * dim + d], w_s[f * dim + d],
                              zmc::sobol_uniform(pt[d * THREADS], sh_s[f * dim + d]));
        if (COMPACT) {
          const float2 xj = transform_axis(x, p[tcol + d], p[tcol + dim + d]);
          x = xj.x;
          jac *= xj.y;
        }
        acc = zmc::Body<FORM>::step(acc, x, p, d);
      }
      float v = zmc::Body<FORM>::fin(acc, p, dim);
      if (COMPACT) v *= jac;
      s1[f] += v;
      s2[f] += v * v;
    }
  }
}

// Pass 1.  Block b handles function block fb, round r and sample chunk c,
// b = (fb * n_rounds + r) * n_chunks + c.  block_meta is
// i32[2 + 2 * n_sweep, n_fn_pad / 16]: row 0 the block's form id, row 1 -1
// for a plain block or the first of a compactified block's 2 * dim
// transform columns, rows 2 + 2j and 3 + 2j the j-th (base column, table
// column) pair of a swept block (-1: none).  Dynamic shared memory: c1
// base u32[16], packed rows f32[16, n_cols], lo and hi - lo f32[16, dim]
// each, and for SOBOL the direction vectors u32[dim, 32], the shifts' top
// 24 bits u32[16, dim] and the threads' points u32[dim, 256].  SWEPT
// compiles the sweep pairs' copy in (taken when n_sweep > 0 and the block
// is swept).  Five instantiations: the MC launch without compactified or
// swept blocks (<false, false, false>, the main path) runs code and a
// register allocation that neither the transform's call, the Sobol point
// nor the copy shape (the copy alone, in the load phase, cost it 0.35%),
// and MC swept launches have <false, false, true>; compactified and Sobol
// launches, swept or not, share one instantiation each with the copy in.
// A swept block differs from its per-point families only in that copy:
// the sample loop does the same float operations on the same values.
template <bool HAS_COMPACT, bool SOBOL, bool SWEPT>
__global__ void __launch_bounds__(THREADS)
fused_mc_pass1(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
               uint32_t round_stride, int n_rounds, const uint32_t* __restrict__ round_base,
               const uint32_t* __restrict__ fn_ids, const int32_t* __restrict__ block_meta,
               int n_sweep, const uint32_t* __restrict__ sobol_dirs,
               const float* __restrict__ packed, int n_cols, const float* __restrict__ lo,
               const float* __restrict__ hi, int dim, int n_fn_pad, int n_chunks,
               float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS][F_BLK][2];
  uint32_t* c1_s = reinterpret_cast<uint32_t*>(smem);
  float* p_s = smem + F_BLK;
  float* lo_s = p_s + F_BLK * n_cols;
  float* w_s = lo_s + F_BLK * dim;
  uint32_t* v_s = reinterpret_cast<uint32_t*>(w_s + F_BLK * dim);
  uint32_t* sh_s = v_s + 32 * dim;
  uint32_t* pt_s = sh_s + F_BLK * dim;

  const int chunk = blockIdx.x % n_chunks;
  const int fr = blockIdx.x / n_chunks;
  const int r = fr % n_rounds;
  const int fb = fr / n_rounds;
  const int row0 = fb * F_BLK;
  const int n_fblocks = n_fn_pad / F_BLK;
  for (int i = threadIdx.x; i < F_BLK; i += THREADS)
    c1_s[i] = fn_ids[row0 + i] * zmc::DIM_STRIDE;
  for (int i = threadIdx.x; i < F_BLK * n_cols; i += THREADS)
    p_s[i] = packed[(size_t)row0 * n_cols + i];
  for (int i = threadIdx.x; i < F_BLK * dim; i += THREADS) {
    const float l = lo[(size_t)row0 * dim + i];
    lo_s[i] = l;
    w_s[i] = hi[(size_t)row0 * dim + i] - l;
  }
  if (SOBOL) {
    for (int i = threadIdx.x; i < 32 * dim; i += THREADS) v_s[i] = sobol_dirs[i];
    for (int i = threadIdx.x; i < F_BLK * dim; i += THREADS) {
      const int f = i / dim, d = i % dim;
      sh_s[i] = zmc::sobol_shift(k0, k1, fn_ids[row0 + f] * zmc::DIM_STRIDE + (uint32_t)d) >> 8;
    }
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

  float s1[F_BLK], s2[F_BLK];
#pragma unroll
  for (int f = 0; f < F_BLK; ++f) s1[f] = s2[f] = 0.0f;

  // round r's window, in u32 arithmetic that wraps as the TPU kernel's does
  const uint32_t window = sample_offset + (round_base != nullptr ? round_base[fb] : 0u) +
                          (uint32_t)r * round_stride;
  const uint32_t begin = (uint32_t)chunk * CHUNK_SAMPLES;
  const uint64_t chunk_end = (uint64_t)begin + CHUNK_SAMPLES;
  const uint64_t end = chunk_end < n_valid ? chunk_end : (uint64_t)n_valid;
  const int tcol = block_meta[n_fblocks + fb];
  // form and tcol are uniform across the block, so this switch never diverges
#define ZMC_RUN(FORM, C)                                                                 \
  if constexpr (SOBOL) {                                                                 \
    eval_chunk_sobol<FORM, C>(p_s, lo_s, w_s, v_s, sh_s, pt_s, n_cols, C ? tcol : 0, dim,      \
                              window, begin, end, s1, s2);                               \
  } else {                                                                               \
    eval_chunk<FORM, C>(p_s, lo_s, w_s, c1_s, n_cols, C ? tcol : 0, dim, k0, k1, window, \
                        begin, end, s1, s2);                                             \
  }
#define ZMC_EVAL(FORM)        \
  if constexpr (HAS_COMPACT) { \
    if (tcol >= 0) {          \
      ZMC_RUN(FORM, true)     \
      break;                  \
    }                         \
  }                           \
  ZMC_RUN(FORM, false)        \
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

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < F_BLK; ++f) {
    float a = s1[f], b = s2[f];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      red[warp][f][0] = a;
      red[warp][f][1] = b;
    }
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

// Pass 2: out[round, row, comp] = sum over chunks, in chunk order.
__global__ void fused_mc_pass2(const float* __restrict__ scratch, int n_chunks, int n_out,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  // (i >> 1) indexes (round, row) pairs, which scratch and out lay out alike
  const float* src = scratch + (size_t)(i >> 1) * n_chunks * 2 + (i & 1);
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) acc += src[2 * c];
  out[i] = acc;
}

// Test-only: the Sobol points and shifts as the kernel computes them,
// pt[i * dim + d] = sobol_point(v + 32 d, idx[i]) and sh[i * dim + d] =
// sobol_shift(k0, k1, fn_ids[i] * 256 + d).
__global__ void sobol_kernel(const uint32_t* __restrict__ v, int dim, uint32_t k0, uint32_t k1,
                             const uint32_t* __restrict__ idx,
                             const uint32_t* __restrict__ fn_ids, uint32_t* __restrict__ pt,
                             uint32_t* __restrict__ sh, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    for (int d = 0; d < dim; ++d) {
      pt[i * dim + d] = zmc::sobol_point(v + 32 * d, idx[i]);
      sh[i * dim + d] = zmc::sobol_shift(k0, k1, fn_ids[i] * zmc::DIM_STRIDE + (uint32_t)d);
    }
  }
}

// Test-only: out[i] = random_bits(k0, k1, c0[i], c1[i]).
__global__ void random_bits_kernel(uint32_t k0, uint32_t k1, const uint32_t* __restrict__ c0,
                                   const uint32_t* __restrict__ c1, uint32_t* __restrict__ out,
                                   long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = zmc::random_bits(k0, k1, c0[i], c1[i]);
}

}  // namespace

extern "C" {

int zmc_chunk_samples(void) { return CHUNK_SAMPLES; }

// Launch both passes on `stream`.  n_valid is the number of samples per
// function and round (samples at local index >= n_valid are not drawn);
// n_chunks must be max(1, ceil(n_valid / zmc_chunk_samples())).  Round r of
// function block fb starts at sample_offset + round_base[fb] + r *
// round_stride (u32 wrap); round_base may be null (all 0).  block_meta is
// i32[2 + 2 * n_sweep, n_fn_pad / 16] (see fused_mc_pass1); has_compact must
// be nonzero when any block is compactified (0 runs the kernel without the
// compactified path), n_sweep 0 when no block is swept (the kernel then
// skips the sweep pairs).  sobol_dirs is null for MC draws, or the direction
// vectors u32[dim, 32] (dim <= 8) for Sobol draws.  scratch is
// f32[n_rounds, n_fn_pad, n_chunks, 2], out f32[n_rounds, n_fn_pad, 2].
// Returns the CUDA error of the launches (0 on success).
int zmc_fused_mc(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
                 uint32_t round_stride, int n_rounds, const uint32_t* round_base,
                 const uint32_t* fn_ids, const int32_t* block_meta, int n_sweep,
                 int has_compact, const uint32_t* sobol_dirs, const float* packed,
                 int n_cols, const float* lo, const float* hi, int dim, int n_fn_pad,
                 int n_chunks, float* scratch, float* out, void* stream) {
  const bool sobol = sobol_dirs != nullptr;
  if (n_fn_pad <= 0 || n_fn_pad % F_BLK != 0 || n_chunks <= 0 || n_rounds <= 0 ||
      dim <= 0 || n_cols < 0 || n_sweep < 0 || (sobol && dim > zmc::SOBOL_MAX_DIM))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)(n_fn_pad / F_BLK) * n_rounds * n_chunks;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)F_BLK * (1 + n_cols + 2 * dim) +
                                       (sobol ? (size_t)(32 + F_BLK + THREADS) * dim : 0));
  using Pass1 = decltype(&fused_mc_pass1<false, false, false>);
  static const Pass1 instantiations[4] = {
      fused_mc_pass1<false, false, true>, fused_mc_pass1<true, false, true>,
      fused_mc_pass1<false, true, true>, fused_mc_pass1<true, true, true>};
  const Pass1 pass1 = (has_compact || sobol || n_sweep > 0)
                          ? instantiations[(has_compact ? 1 : 0) | (sobol ? 2 : 0)]
                          : fused_mc_pass1<false, false, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pass1<<<(unsigned)n_blocks, THREADS, smem, s>>>(
      k0, k1, sample_offset, n_valid, round_stride, n_rounds, round_base, fn_ids, block_meta,
      n_sweep, sobol_dirs, packed, n_cols, lo, hi, dim, n_fn_pad, n_chunks, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_out = (long long)n_rounds * n_fn_pad * 2;
  fused_mc_pass2<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(scratch, n_chunks,
                                                                 (int)n_out, out);
  return (int)cudaGetLastError();
}

int zmc_sobol(const uint32_t* v, int dim, uint32_t k0, uint32_t k1, const uint32_t* idx,
              const uint32_t* fn_ids, uint32_t* pt, uint32_t* sh, long long n, void* stream) {
  if (n <= 0) return 0;
  if (dim <= 0 || dim > zmc::SOBOL_MAX_DIM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 65536 ? want : 65536);
  sobol_kernel<<<blocks, 256, 0, s>>>(v, dim, k0, k1, idx, fn_ids, pt, sh, n);
  return (int)cudaGetLastError();
}

int zmc_random_bits(uint32_t k0, uint32_t k1, const uint32_t* c0, const uint32_t* c1,
                    uint32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 65536 ? want : 65536);
  random_bits_kernel<<<blocks, 256, 0, s>>>(k0, k1, c0, c1, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
