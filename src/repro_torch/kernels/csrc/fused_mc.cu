// Fused multi-family Monte-Carlo kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/template.py:_fused_kernel (launched by
// fused_mc_pallas), in its single-round MC form with the five eval bodies
// of repro/kernels/mc_eval/{kernel,ops}.py selected per 16-function block.
// Per function f, sample s and dim d it draws
//   c0 = sample_offset + s (u32 wrap), c1 = fn_id * 256 + d (u32 wrap),
//   u  = (Threefry-2x32(k, c0, c1)[0] >> 8) * 2^-24,
//   x  = lo + u * (hi - lo),
// evaluates the block's body, drops samples past n_valid, and writes
// (sum f, sum f^2) per function.
//
// What bounds it: 32-bit integer throughput.  Each draw is one Threefry
// block: at least 63 integer operations (20 rounds of add, rotate, xor and
// the key schedule, less what is the same for every sample of a function
// and dim), of which 38 rotates, xors and shifts can issue only on the
// 64-lane-per-SM ALU pipe; against that stand a few float operations and
// 8 bytes of parameters per (function, dim) for the whole launch.  The design keeps
// all of it in registers: no random bit ever touches memory, the packed
// rows and boxes sit in shared memory, each rotate is one funnel shift,
// and the grid (16-function block x 16384-sample chunk) gives every SM
// several blocks at the paper's Fig.-1 size.
//
// Determinism: no float atomics.  Pass 1 reduces each block's per-thread
// partials in a fixed order (warp shuffles, then shared memory across
// warps) into scratch[n_fn_pad, n_chunks, 2]; pass 2 sums each function's
// chunk partials in index order.  Repeated launches are bit-identical.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (repro_torch/kernels/build.py), never
// with --use_fast_math: the harmonic phase reaches hundreds of radians,
// where the fast cosf/sinf are wrong.

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

template <int FORM>
__device__ __forceinline__ void eval_chunk(const float* __restrict__ p_s,
                                           const float* __restrict__ lo_s,
                                           const float* __restrict__ w_s,
                                           const uint32_t* __restrict__ c1_s,
                                           int n_cols, int dim, uint32_t k0,
                                           uint32_t k1, uint32_t sample_offset,
                                           uint32_t begin, uint64_t end,
                                           float (&s1)[F_BLK], float (&s2)[F_BLK]) {
  for (uint64_t local = (uint64_t)begin + threadIdx.x; local < end; local += THREADS) {
    const uint32_t c0 = sample_offset + (uint32_t)local;
#pragma unroll
    for (int f = 0; f < F_BLK; ++f) {
      const float* p = p_s + f * n_cols;
      float acc = zmc::Body<FORM>::init(p);
      for (int d = 0; d < dim; ++d) {
        const uint32_t bits = zmc::random_bits(k0, k1, c0, c1_s[f] + (uint32_t)d);
        const float x = zmc::affine(lo_s[f * dim + d], w_s[f * dim + d],
                                    zmc::bits_to_uniform(bits));
        acc = zmc::Body<FORM>::step(acc, x, p, d);
      }
      const float v = zmc::Body<FORM>::fin(acc, p, dim);
      s1[f] += v;
      s2[f] += v * v;
    }
  }
}

// Pass 1.  Block b handles function block b / n_chunks and sample chunk
// b % n_chunks.  Dynamic shared memory: c1 base u32[16], packed rows
// f32[16, n_cols], lo and hi - lo f32[16, dim] each.
__global__ void __launch_bounds__(THREADS)
fused_mc_pass1(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
               const uint32_t* __restrict__ fn_ids, const int32_t* __restrict__ block_forms,
               const float* __restrict__ packed, int n_cols, const float* __restrict__ lo,
               const float* __restrict__ hi, int dim, int n_chunks,
               float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS][F_BLK][2];
  uint32_t* c1_s = reinterpret_cast<uint32_t*>(smem);
  float* p_s = smem + F_BLK;
  float* lo_s = p_s + F_BLK * n_cols;
  float* w_s = lo_s + F_BLK * dim;

  const int fb = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
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

  const uint32_t begin = (uint32_t)chunk * CHUNK_SAMPLES;
  const uint64_t chunk_end = (uint64_t)begin + CHUNK_SAMPLES;
  const uint64_t end = chunk_end < n_valid ? chunk_end : (uint64_t)n_valid;
  // the form is uniform across the block, so this switch never diverges
  switch (block_forms[fb]) {
    case zmc::FORM_HARMONIC:
      eval_chunk<zmc::FORM_HARMONIC>(p_s, lo_s, w_s, c1_s, n_cols, dim, k0, k1,
                                     sample_offset, begin, end, s1, s2);
      break;
    case zmc::FORM_ABS_SUM:
      eval_chunk<zmc::FORM_ABS_SUM>(p_s, lo_s, w_s, c1_s, n_cols, dim, k0, k1,
                                    sample_offset, begin, end, s1, s2);
      break;
    case zmc::FORM_GAUSSIAN:
      eval_chunk<zmc::FORM_GAUSSIAN>(p_s, lo_s, w_s, c1_s, n_cols, dim, k0, k1,
                                     sample_offset, begin, end, s1, s2);
      break;
    case zmc::FORM_GENZ_OSC:
      eval_chunk<zmc::FORM_GENZ_OSC>(p_s, lo_s, w_s, c1_s, n_cols, dim, k0, k1,
                                     sample_offset, begin, end, s1, s2);
      break;
    case zmc::FORM_GENZ_CORNER:
      eval_chunk<zmc::FORM_GENZ_CORNER>(p_s, lo_s, w_s, c1_s, n_cols, dim, k0, k1,
                                        sample_offset, begin, end, s1, s2);
      break;
    default:  // unknown form id: poison the block's sums rather than guess
#pragma unroll
      for (int f = 0; f < F_BLK; ++f) s1[f] = s2[f] = zmc::quiet_nan();
  }

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
    scratch[((size_t)(row0 + f) * n_chunks + chunk) * 2 + comp] = acc;
  }
}

// Pass 2: out[row, comp] = sum over chunks, in chunk order.
__global__ void fused_mc_pass2(const float* __restrict__ scratch, int n_chunks, int n_out,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
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
// function (samples at local index >= n_valid are not drawn); n_chunks must
// be max(1, ceil(n_valid / zmc_chunk_samples())).  scratch is
// f32[n_fn_pad, n_chunks, 2], out f32[n_fn_pad, 2].  Returns the CUDA error
// of the launches (0 on success).
int zmc_fused_mc(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
                 const uint32_t* fn_ids, const int32_t* block_forms, const float* packed,
                 int n_cols, const float* lo, const float* hi, int dim, int n_fn_pad,
                 int n_chunks, float* scratch, float* out, void* stream) {
  if (n_fn_pad <= 0 || n_fn_pad % F_BLK != 0 || n_chunks <= 0 || dim <= 0 || n_cols < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)(n_fn_pad / F_BLK) * n_chunks;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)F_BLK * (1 + n_cols + 2 * dim);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mc_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_mc_pass1<<<(unsigned)n_blocks, THREADS, smem, s>>>(
      k0, k1, sample_offset, n_valid, fn_ids, block_forms, packed, n_cols, lo, hi, dim,
      n_chunks, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_out = n_fn_pad * 2;
  fused_mc_pass2<<<(n_out + 255) / 256, 256, 0, s>>>(scratch, n_chunks, n_out, out);
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
