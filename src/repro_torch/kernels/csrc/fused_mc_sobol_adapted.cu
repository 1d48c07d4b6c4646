// Pass 1 of the fused kernel for Sobol launches with adapted blocks:
// fused_mc_pass1<2, true, true>, built from its own source so that the
// instantiations compile in parallel (see fused_mc.cu).
#include "fused_mc_pass1.cuh"

cudaError_t zmc::launch_pass1_sobol_adapted(const Pass1Args& a, unsigned n, size_t smem,
                                            cudaStream_t s) {
  return launch_pass1<2, true, true>(a, n, smem, s);
}
