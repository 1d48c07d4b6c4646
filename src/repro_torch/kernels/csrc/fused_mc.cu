// Fused multi-family Monte-Carlo kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/template.py:_fused_kernel (launched by
// fused_mc_pallas) with the five eval bodies of
// repro/kernels/mc_eval/{kernel,ops}.py selected per 16-function block,
// both samplers (MC, and Sobol: sobol_tiles and the shifted draw of
// :468 and :480-485), the round axis (n_rounds > 1, scalars[4] =
// round_stride, per-block round_base) and three wrapper stages,
// compactified_body, swept_body and adapted_body (:318, with
// adapt_grid_cols, :365).  Per function f, round r, sample s and dim d it
// takes
//   c0 = sample_offset + round_base[block] + r * round_stride + s (u32 wrap),
//   c1 = fn_id * 256 + d (u32 wrap),
//   u  = (Threefry-2x32(k, c0, c1)[0] >> 8) * 2^-24                 (MC), or
//   u  = ((sobol_point(V[d], c0) ^ Threefry(k, 0x50B01, c1)[0]) >> 8) * 2^-24
//                                                                (Sobol),
//   x  = lo + u * (hi - lo),
// and, in an adapted block (its box the unit cube, so x = u), x ->
// apply_map_axis(x, the axis' grid edges) with the grid's Jacobian product
// folded into the value, then, in a compactified block, x ->
// apply_transform(x, kind, shift) with its Jacobian product folded in too;
// the edges and transform columns ride in the packed row after the form's
// (and sweep's) columns, [base][sweep][adapt][transform].  It evaluates the block's
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
// compactified axis adds the precise tanf, cosf and divisions of its map
// (about 28 float operations, 2 reciprocals and 13 ALU operations for the
// tan map), an adapted axis a bin select, two shared-memory loads of its
// edges and an interpolation (about 10 operations).  The design keeps all
// of it in registers: no random bit ever touches memory, the packed rows
// and boxes sit in shared memory, each rotate is one funnel shift, and the
// grid (16-function block x round x 16384-sample chunk) gives every SM
// several blocks at the paper's Fig.-1 size.  A block without a transform
// column (the main path's, and the adapted blocks') takes the dims outside
// and its 16 functions inside, so 16 independent Threefry chains (or
// points) and their loads are in flight at once, from a per-block table
// u32x4[dim, 16] (lo, hi - lo, c1) read with one 16-byte load per draw.  A
// block with a transform column and MC draws takes one function at a time
// and that function's run of samples inside, its sums in two registers,
// with the transform inlined: without 16-wide arrays the precise
// functions' long chains need no call and no spills.
//
// The Sobol draw has no Threefry: each thread walks its samples' points
// (c0, c0 + 256, ...) in Gray-code order, one register per dim (built in
// full, 32 XORs of direction vectors, at its first sample; after that two
// XORs per dim and sample), and shares them among the block's 16
// functions; a function's draw is one 16-byte table load (lo, hi - lo and
// its shift's top 24 bits), one XOR, one u32 -> f32 conversion and the
// affine map, in the same dim-outer loop as an adapted block's.  What
// bounds it: issue slots, for those few operations per draw and the
// value's finish (a sin and cos, or an exp) per function and sample; the
// three Sobol instantiations run at two blocks per SM.
//
// Determinism: no float atomics.  Each thread sums its samples in sample
// order, whichever loop is outermost, and the rounding of each sum is
// pinned with _rn intrinsics (fused_mc_pass1.cuh add_sums), so every loop
// order gives the same bits.  Pass 1 reduces each block's
// per-thread partials in a fixed order (warp shuffles, then shared memory
// across warps) into scratch[n_rounds, n_fn_pad, n_chunks, 2]; pass 2 sums
// each (round, function)'s chunk partials in index order.  Chunks start at 0
// within each round's window, so round r of an R-round launch runs the
// same instructions and fold as a single-round launch at that round's
// offset: the two are bit-identical, and so are repeated launches.
//
// Pass 1 lives in fused_mc_pass1.cuh.  This source builds its two
// instantiations without stages (the main path's among them) and five more
// sources build one each; all are compiled in parallel and linked into one
// shared library with a plain C interface (repro_torch/kernels/build.py),
// with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and never with
// --use_fast_math: the harmonic phase reaches hundreds of radians, and the
// compactified maps reach u = 1e-7 from a pole, where the fast
// cosf/sinf/tanf are wrong.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_mc_pass1.cuh"

cudaError_t zmc::launch_pass1_plain(const Pass1Args& a, unsigned n, size_t smem,
                                    cudaStream_t s) {
  return launch_pass1<0, false, false>(a, n, smem, s);
}

cudaError_t zmc::launch_pass1_swept(const Pass1Args& a, unsigned n, size_t smem,
                                    cudaStream_t s) {
  return launch_pass1<0, false, true>(a, n, smem, s);
}

namespace {

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

// Test-only: the Sobol points of indices start + i (u32 wrap), i < n, as
// pass 1 walks them: one block of THREADS threads, thread t building the
// point of start + t and walking its run start + t + k * THREADS (SobolRun,
// with v the full direction vectors u32[dim, 32]); pt[i * dim + d].
__global__ void sobol_walk_kernel(const uint32_t* __restrict__ v, int dim, uint32_t start,
                                  long long n, uint32_t* __restrict__ pt) {
  SobolRun run;
  run.start(v, dim, start + threadIdx.x);
  for (long long i = threadIdx.x; i < n; i += THREADS) {
    for (int d = 0; d < dim; ++d) pt[i * dim + d] = run.at(d);
    run.step(v, dim, start + (uint32_t)i + THREADS);
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
// i32[4 + 2 * n_sweep, n_fn_pad / 16] (see fused_mc_pass1); has_stages is
// a bit mask, 1 when any block is compactified and 2 when any is adapted
// (0 runs the kernel without those stages), n_sweep the number of
// sweep-pair row pairs, 0 when no block is swept (the kernel then skips
// the sweep pairs).  sobol_dirs is null for MC draws, or the direction
// vectors u32[dim, 32] (dim <= 8) for Sobol draws.  scratch is
// f32[n_rounds, n_fn_pad, n_chunks, 2], out f32[n_rounds, n_fn_pad, 2].
// Returns the CUDA error of the launches (0 on success).
int zmc_fused_mc(uint32_t k0, uint32_t k1, uint32_t sample_offset, uint32_t n_valid,
                 uint32_t round_stride, int n_rounds, const uint32_t* round_base,
                 const uint32_t* fn_ids, const int32_t* block_meta, int n_sweep,
                 int has_stages, const uint32_t* sobol_dirs, const float* packed,
                 int n_cols, const float* lo, const float* hi, int dim, int n_fn_pad,
                 int n_chunks, float* scratch, float* out, void* stream) {
  const bool sobol = sobol_dirs != nullptr;
  if (n_fn_pad <= 0 || n_fn_pad % F_BLK != 0 || n_chunks <= 0 || n_rounds <= 0 ||
      dim <= 0 || n_cols < 0 || n_sweep < 0 || (sobol && dim > zmc::SOBOL_MAX_DIM))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)(n_fn_pad / F_BLK) * n_rounds * n_chunks;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stages = (has_stages & 2) ? 2 : (has_stages & 1) ? 1 : 0;
  // see fused_mc_pass1: the table, the packed rows and, for Sobol, the
  // direction vectors
  const size_t smem = sizeof(uint4) * F_BLK * dim +
                      sizeof(float) * ((size_t)F_BLK * n_cols + (sobol ? (size_t)32 * dim : 0));
  const zmc::Pass1Args a{k0,     k1,         sample_offset, n_valid, round_stride, n_rounds,
                         round_base, fn_ids, block_meta, n_sweep, sobol_dirs, packed,
                         n_cols, lo,         hi,            dim,     n_fn_pad,     n_chunks,
                         scratch};
  const unsigned nb = (unsigned)n_blocks;
  cudaError_t e;
  if (sobol)
    e = stages == 2   ? zmc::launch_pass1_sobol_adapted(a, nb, smem, s)
        : stages == 1 ? zmc::launch_pass1_sobol_compact(a, nb, smem, s)
                      : zmc::launch_pass1_sobol(a, nb, smem, s);
  else if (stages == 2)
    e = zmc::launch_pass1_adapted(a, nb, smem, s);
  else if (stages == 1)
    e = zmc::launch_pass1_compact(a, nb, smem, s);
  else if (n_sweep > 0)
    e = zmc::launch_pass1_swept(a, nb, smem, s);
  else
    e = zmc::launch_pass1_plain(a, nb, smem, s);
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

int zmc_sobol_walk(const uint32_t* v, int dim, uint32_t start, long long n, uint32_t* pt,
                   void* stream) {
  if (n <= 0) return 0;
  if (dim <= 0 || dim > zmc::SOBOL_MAX_DIM) return (int)cudaErrorInvalidValue;
  sobol_walk_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(v, dim, start, n, pt);
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
