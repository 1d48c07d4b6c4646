"""The stratum-moments kernel: per-row (count, mean, M2) of a value
matrix (``ops.stratum_moments``; CUDA source ``csrc/moments.cu``)."""
