// Fused multi-family Monte-Carlo kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/template.py:_fused_kernel (launched by
// fused_mc_pallas), in its MC form with the five eval bodies of
// repro/kernels/mc_eval/{kernel,ops}.py selected per 16-function block,
// the round axis (n_rounds > 1, scalars[4] = round_stride, per-block
// round_base) and the compactified_body wrapper stage.  Per function f,
// round r, sample s and dim d it draws
//   c0 = sample_offset + round_base[block] + r * round_stride + s (u32 wrap),
//   c1 = fn_id * 256 + d (u32 wrap),
//   u  = (Threefry-2x32(k, c0, c1)[0] >> 8) * 2^-24,
//   x  = lo + u * (hi - lo),
// and, in a compactified block, x -> apply_transform(x, kind, shift) with
// the Jacobian product folded into the value; it evaluates the block's
// body, drops samples past n_valid, and writes (sum f, sum f^2) per round
// and function.
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

// Pass 1.  Block b handles function block fb, round r and sample chunk c,
// b = (fb * n_rounds + r) * n_chunks + c.  Dynamic shared memory: c1 base
// u32[16], packed rows f32[16, n_cols], lo and hi - lo f32[16, dim] each.
// block_tcols[fb] is -1 for a plain block, else the first of the block's
// 2 * dim transform columns (a compactified block).  HAS_COMPACT = false
// leaves the compactified path out of the kernel, so a launch without
// compactified blocks runs code (and a register allocation) that the
// transform's call does not shape.
template <bool HAS_COMPACT>
__global__ void __launch_bounds__(THREADS)
fused_mc_pass1(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
               uint32_t round_stride, int n_rounds, const uint32_t* __restrict__ round_base,
               const uint32_t* __restrict__ fn_ids, const int32_t* __restrict__ block_forms,
               const int32_t* __restrict__ block_tcols,
               const float* __restrict__ packed, int n_cols, const float* __restrict__ lo,
               const float* __restrict__ hi, int dim, int n_fn_pad, int n_chunks,
               float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS][F_BLK][2];
  uint32_t* c1_s = reinterpret_cast<uint32_t*>(smem);
  float* p_s = smem + F_BLK;
  float* lo_s = p_s + F_BLK * n_cols;
  float* w_s = lo_s + F_BLK * dim;

  const int chunk = blockIdx.x % n_chunks;
  const int fr = blockIdx.x / n_chunks;
  const int r = fr % n_rounds;
  const int fb = fr / n_rounds;
  const int row0 = fb * F_BLK;
  for (int i = threadIdx.x; i < F_BLK; i += THREADS)
    c1_s[i] = fn_ids[row0 + i] * zmc::DIM_STRIDE;
  for (int i = threadIdx.x; i < F_BLK * n_cols; i += THREADS)
    p_s[i] = packed[(size_t)row0 * n_cols + i];
  for (int i = threadIdx.x; i < F_BLK * dim; i += THREADS) {
    const float l = lo[(size_t)row0 * dim + i];
    lo_s[i] = l;
    w_s[i] = hi[(size_t)row0 * dim + i] - l;
  }
  __syncthreads();

  float s1[F_BLK], s2[F_BLK];
#pragma unroll
  for (int f = 0; f < F_BLK; ++f) s1[f] = s2[f] = 0.0f;

  // round r's window, in u32 arithmetic that wraps as the TPU kernel's does
  const uint32_t window = sample_offset + (round_base != nullptr ? round_base[fb] : 0u) +
                          (uint32_t)r * round_stride;
  const uint32_t begin = (uint32_t)chunk * CHUNK_SAMPLES;
  const uint64_t chunk_end = (uint64_t)begin + CHUNK_SAMPLES;
  const uint64_t end = chunk_end < n_valid ? chunk_end : (uint64_t)n_valid;
  const int tcol = block_tcols[fb];
  // form and tcol are uniform across the block, so this switch never diverges
#define ZMC_EVAL(FORM)                                                                \
  if constexpr (HAS_COMPACT) {                                                        \
    if (tcol >= 0) {                                                                  \
      eval_chunk<FORM, true>(p_s, lo_s, w_s, c1_s, n_cols, tcol, dim, k0, k1, window, \
                             begin, end, s1, s2);                                     \
      break;                                                                          \
    }                                                                                 \
  }                                                                                   \
  eval_chunk<FORM, false>(p_s, lo_s, w_s, c1_s, n_cols, 0, dim, k0, k1, window,       \
                          begin, end, s1, s2);                                        \
  break;
  switch (block_forms[fb]) {
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
// round_stride (u32 wrap); round_base may be null (all 0).  block_tcols is
// i32[n_fn_pad / 16]: -1, or the first transform column of a compactified
// block; has_compact must be nonzero when any block is compactified (0
// runs the kernel without the compactified path).  scratch is
// f32[n_rounds, n_fn_pad, n_chunks, 2], out f32[n_rounds, n_fn_pad, 2].
// Returns the CUDA error of the launches (0 on success).
int zmc_fused_mc(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
                 uint32_t round_stride, int n_rounds, const uint32_t* round_base,
                 const uint32_t* fn_ids, const int32_t* block_forms,
                 const int32_t* block_tcols, int has_compact, const float* packed,
                 int n_cols, const float* lo, const float* hi, int dim, int n_fn_pad,
                 int n_chunks, float* scratch, float* out, void* stream) {
  if (n_fn_pad <= 0 || n_fn_pad % F_BLK != 0 || n_chunks <= 0 || n_rounds <= 0 ||
      dim <= 0 || n_cols < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)(n_fn_pad / F_BLK) * n_rounds * n_chunks;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)F_BLK * (1 + n_cols + 2 * dim);
  auto pass1 = has_compact ? fused_mc_pass1<true> : fused_mc_pass1<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pass1<<<(unsigned)n_blocks, THREADS, smem, s>>>(
      k0, k1, sample_offset, n_valid, round_stride, n_rounds, round_base, fn_ids,
      block_forms, block_tcols, packed, n_cols, lo, hi, dim, n_fn_pad, n_chunks, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_out = (long long)n_rounds * n_fn_pad * 2;
  fused_mc_pass2<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(scratch, n_chunks,
                                                                 (int)n_out, out);
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
