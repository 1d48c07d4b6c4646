// Per-row streaming moments for Hopper (sm_90a): the stratum-moments kernel.
//
// Replaces repro/kernels/moments/kernel.py:_moments_kernel (launched by
// moments_pallas): for an f32 matrix values[R, C], C a multiple of
// C_BLK = 512, it writes out[r] = (count, mean, M2) of row r.  Within each
// 512-column block the block's mean is its sum / 512 and its M2 the sum of
// squared deviations from that mean (two passes over the block, the values
// held in registers); the blocks fold in column order with the Chan/Welford
// merge of kernel.py:_welford_combine:
//   n = n_a + n_b, delta = mean_b - mean_a,
//   mean = mean_a + delta * (n_b / n),
//   M2 = M2_a + M2_b + delta^2 * (n_a * n_b / n).
//
// What bounds it: bytes.  Each value is read from HBM once and the output
// is 12 bytes per row, so the least time is 4 R C bytes over the card's
// memory rate; the arithmetic (a few float operations per value) is far
// below the float rate.  The design: one warp per row, each lane reading
// 16 values of a block as four 16-byte loads (a warp reads 512 contiguous
// floats, coalesced), the next block's loads issued before the current
// block is reduced, and enough rows in flight (eight warps per CUDA block,
// one CUDA block per eight rows) to keep the memory system busy.
//
// Determinism: no atomics.  Each block sum is reduced across the warp with
// shuffles in a fixed tree and broadcast from lane 0, and the merge runs in
// column order in every lane alike, so repeated launches are bit-identical.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C_BLK = 512;
constexpr int WARPS = 8;                       // rows per CUDA block
constexpr int VEC = C_BLK / 32 / 4;            // float4 loads per lane per block

// Warp sum in a fixed tree, lane 0's result broadcast to every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

__global__ void __launch_bounds__(WARPS * 32)
moments_kernel(const float* __restrict__ values, int rows, int cols, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4* src = reinterpret_cast<const float4*>(values + (size_t)row * cols) + lane;
  const int n_blocks = cols / C_BLK;

  float4 cur[VEC], nxt[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) cur[k] = __ldg(src + 32 * k);
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int j = 0; j < n_blocks; ++j) {
    if (j + 1 < n_blocks) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) nxt[k] = __ldg(src + (j + 1) * (C_BLK / 4) + 32 * k);
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) s += (cur[k].x + cur[k].y) + (cur[k].z + cur[k].w);
    const float mean_b = warp_sum(s) / (float)C_BLK;
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float a = cur[k].x - mean_b, b = cur[k].y - mean_b;
      const float c = cur[k].z - mean_b, d = cur[k].w - mean_b;
      q += (a * a + b * b) + (c * c + d * d);
    }
    const float m2_b = warp_sum(q);
    const float n_b = (float)C_BLK;
    if (j == 0) {
      n = n_b;
      mean = mean_b;
      m2 = m2_b;
    } else {
      const float tot = n + n_b;
      const float delta = mean_b - mean;
      mean = mean + delta * (n_b / tot);
      m2 = m2 + m2_b + delta * delta * (n * n_b / tot);
      n = tot;
    }
    if (j + 1 < n_blocks) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) cur[k] = nxt[k];
    }
  }
  if (lane == 0) {
    out[3 * (size_t)row + 0] = n;
    out[3 * (size_t)row + 1] = mean;
    out[3 * (size_t)row + 2] = m2;
  }
}

}  // namespace

extern "C" {

int zmc_moments_cblk(void) { return C_BLK; }

// out[r] = (count, mean, M2) of values[r, :] for r < rows, on `stream`.
// values is f32[rows, cols] (16-byte aligned, cols a positive multiple of
// zmc_moments_cblk()), out f32[rows, 3].  Returns the CUDA error of the
// launch (0 on success).
int zmc_stratum_moments(const float* values, int rows, int cols, float* out, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % C_BLK != 0 ||
      (reinterpret_cast<uintptr_t>(values) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + WARPS - 1) / WARPS;
  moments_kernel<<<blocks, WARPS * 32, 0, s>>>(values, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
