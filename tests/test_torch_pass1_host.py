"""Pass 1 of the fused CUDA kernel, run on the host.

``src/repro_torch/kernels/csrc/fused_mc_pass1.cuh`` is compiled with g++
against a small stand-in for the CUDA runtime: each CUDA block runs as 256
host threads, ``__syncthreads`` as a barrier, the warp shuffles through a
shared array, ``__shared__`` as static storage.  Every instantiation the
library builds is launched here on plans of every kind (plain, Sobol,
compactified, adapted with and without a transform, swept; windows that
cross 2^32; two rounds) and its chunk partials, summed in chunk order as
pass 2 sums them, are held against the port's plain version within the
card's kernel-vs-plain tolerance (``rtol=1e-4, atol=1e-2``: f32 sums in
another order).  It checks the kernel's indexing, shared-memory layout,
Sobol walk and loop dispatch without a card; the card's float rounding
(FMA contraction) is checked on the card (``tests/test_torch_cuda.py``,
``launch/kernel_ab.py``).
"""

import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import rng
from repro_torch.core.integrand import MultiFunctionSpec, harmonic_family
from repro_torch.kernels import template
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.mc_eval import multi
from repro_torch.launch import kernel_ab

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local Dim3 threadIdx;
extern thread_local Dim3 blockIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
extern std::barrier<>* g_block_bar;
extern std::barrier<>* g_warp_bar[8];
extern float g_warp_val[8][32];
extern float* g_smem;
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline float __shfl_down_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  g_warp_val[w][lane] = v;
  g_warp_bar[w]->arrive_and_wait();
  const float r = lane + off < 32 ? g_warp_val[w][lane + off] : v;
  g_warp_bar[w]->arrive_and_wait();
  return r;
}
"""

LAUNCHER = r"""
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local Dim3 threadIdx;
thread_local Dim3 blockIdx;
std::barrier<>* g_block_bar;
std::barrier<>* g_warp_bar[8];
float g_warp_val[8][32];
float* g_smem;
#include "pass1_host.cuh"

template <int ST, bool SO, bool SW>
static void run(unsigned n_blocks, const zmc::Pass1Args& a) {
  std::barrier<> bb(THREADS);
  g_block_bar = &bb;
  for (int w = 0; w < 8; ++w) g_warp_bar[w] = new std::barrier<>(32);
  std::vector<std::thread> th;
  for (unsigned t = 0; t < THREADS; ++t)
    th.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < n_blocks; ++b) {
        blockIdx.x = b;
        fused_mc_pass1<ST, SO, SW>(a.k0, a.k1, a.sample_offset, a.n_valid, a.round_stride,
                                   a.n_rounds, a.round_base, a.fn_ids, a.block_meta,
                                   a.n_sweep, a.sobol_dirs, a.packed, a.n_cols, a.lo, a.hi,
                                   a.dim, a.n_fn_pad, a.n_chunks, a.scratch);
        g_block_bar->arrive_and_wait();
      }
    });
  for (auto& x : th) x.join();
  for (int w = 0; w < 8; ++w) delete g_warp_bar[w];
}

extern "C" int host_pass1(int stages, int sobol, int swept, uint32_t k0, uint32_t k1,
                          uint32_t sample_offset, uint32_t n_valid, uint32_t round_stride,
                          int n_rounds, const uint32_t* round_base, const uint32_t* fn_ids,
                          const int32_t* block_meta, int n_sweep, const uint32_t* sobol_dirs,
                          const float* packed, int n_cols, const float* lo, const float* hi,
                          int dim, int n_fn_pad, int n_chunks, float* scratch,
                          long smem_bytes) {
  std::vector<float> smem(smem_bytes / 4 + 4);
  g_smem = smem.data();
  const zmc::Pass1Args a{k0, k1, sample_offset, n_valid, round_stride, n_rounds, round_base,
                         fn_ids, block_meta, n_sweep, sobol_dirs, packed, n_cols, lo, hi,
                         dim, n_fn_pad, n_chunks, scratch};
  const unsigned nb = (unsigned)(n_fn_pad / F_BLK) * n_rounds * n_chunks;
  switch (stages * 100 + sobol * 10 + swept) {
    case 0: run<0, false, false>(nb, a); break;
    case 1: run<0, false, true>(nb, a); break;
    case 101: run<1, false, true>(nb, a); break;
    case 201: run<2, false, true>(nb, a); break;
    case 11: run<0, true, true>(nb, a); break;
    case 111: run<1, true, true>(nb, a); break;
    case 211: run<2, true, true>(nb, a); break;
    default: return 1;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pass1_host")
    header = (CSRC / "fused_mc_pass1.cuh").read_text()
    # the launcher (a <<<...>>> launch) is CUDA syntax: keep pass 1 only
    header = header[:header.index("// One pass-1 launch of an instantiation")]
    header += "}  // namespace\n"
    header, n = re.subn(r"extern __shared__ (__align__\(16\) )?float smem\[\];",
                        "float* smem = g_smem;", header)
    assert n == 1, "the kernel's dynamic shared memory declaration moved"
    (d / "pass1_host.cuh").write_text(header)
    (d / "zmc_device.cuh").write_text((CSRC / "zmc_device.cuh").read_text())
    (d / "cuda_runtime.h").write_text(RUNTIME)
    (d / "launch.cpp").write_text(LAUNCHER)
    so = d / "libpass1_host.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-I", str(d), "-o", str(so), str(d / "launch.cpp")],
                   check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(so))
    u32, i32, p = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
    out.host_pass1.argtypes = [i32, i32, i32, u32, u32, u32, u32, u32, i32, p, p, p, i32,
                               p, p, i32, p, p, i32, i32, i32, p, ctypes.c_long]
    out.host_pass1.restype = i32
    return out


# a NaN pattern no float operation returns: marks scratch the kernel left unwritten
UNWRITTEN = 0x7FBADBAD


def host_fused_mc(lib, bucket, sampler, key, offset, n, n_rounds=1, round_base=None,
                  round_stride=0):
    """One launch of the host pass 1 with zmc_fused_mc's arguments and shared
    memory size; returns (out [R, rows, 2] summed over chunks in order as
    pass 2 sums them, the raw chunk partials)."""
    n_pad, n_cols = bucket.packed.shape
    dim = bucket.dim
    n_chunks = max(1, math.ceil(n / template.CHUNK_SAMPLES))
    meta = np.ascontiguousarray(bucket.block_meta.cpu().numpy().astype(np.int32))
    n_sweep = (meta.shape[0] - 4) // 2
    stages = (2 if bool((bucket.block_adapt[0] >= 0).any())
              else 1 if bool((bucket.block_tcols >= 0).any()) else 0)
    sobol = sampler == "sobol"
    swept = int(stages > 0 or sobol or n_sweep > 0)
    dirs = (np.ascontiguousarray(template.sobol_dirvecs(dim).numpy()) if sobol else None)
    fid = rng.u32_bits(rng.as_u32(bucket.fn_ids)).numpy().astype(np.uint32)
    packed = np.ascontiguousarray(bucket.packed.numpy())
    lo = np.ascontiguousarray(bucket.lo.numpy())
    hi = np.ascontiguousarray(bucket.hi.numpy())
    base = (None if round_base is None
            else np.ascontiguousarray(np.asarray(round_base, np.int64).astype(np.uint32)))
    scratch = np.full((n_rounds, n_pad, n_chunks, 2), UNWRITTEN, np.uint32).view(np.float32)
    # zmc_fused_mc's dynamic shared memory, in bytes
    smem = 16 * 16 * dim + 4 * (16 * n_cols + (32 * dim if sobol else 0))

    def ptr(a):
        return None if a is None else a.ctypes.data

    k0, k1 = key
    rc = lib.host_pass1(stages, int(sobol), swept, k0, k1, offset & rng.MASK32, n,
                        round_stride, n_rounds, ptr(base), ptr(fid), ptr(meta), n_sweep,
                        ptr(dirs), ptr(packed), n_cols, ptr(lo), ptr(hi), dim, n_pad,
                        n_chunks, ptr(scratch), smem)
    assert rc == 0
    out = np.zeros((n_rounds, n_pad, 2), np.float32)
    for c in range(n_chunks):
        out += scratch[:, :, c]
    return out, scratch


@pytest.fixture(scope="module")
def specs():
    """Plans of every kind from ``kernel_ab.every_form_spec`` (each form
    finite, compactified, adapted, compactified then adapted, at dim 3),
    less the compactified harmonic and oscillatory families: a cosine of
    x ~ 1e7 is ill-conditioned, so no f32 tolerance holds them against
    the plain version."""
    every = kernel_ab.every_form_spec(torch.device("cpu"), n=16).families
    fams = [f for f in every
            if not (f.kernel in ("mc_eval_harmonic", "mc_eval_genz_osc") and ":inf" in f.name)]
    finite = [f for f in fams if ":inf" not in f.name and not f.adapt_bins]
    a, b = np.meshgrid(np.linspace(0.5, 2, 8), np.linspace(-1, 1, 4), indexing="ij")
    sweep = harmonic_family(1, 3).swept_over({"a": a.ravel().astype(np.float32),
                                              "b": b.ravel().astype(np.float32)})
    return {"plain": MultiFunctionSpec.from_families(finite),
            "compactified": MultiFunctionSpec.from_families(
                [f for f in fams if not f.adapt_bins]),
            "adapted": MultiFunctionSpec.from_families(fams),
            "swept": MultiFunctionSpec.from_families([sweep])}


def _plain(bucket, sampler, key, offset, n, round_stride=0, **kw):
    return template.fused_mc_plain(
        template.pack_scalars(key, offset, n, round_stride=round_stride),
        bucket.fn_ids, bucket.packed, bucket.lo, bucket.hi, bucket.block_forms,
        dim=bucket.dim, n_sample_blocks=math.ceil(n / template.S_BLK),
        block_tcols=bucket.block_tcols, block_sweep=bucket.block_sweep,
        block_adapt=bucket.block_adapt, sampler=sampler, **kw).numpy()


def _real_rows(bucket):
    return np.concatenate([np.arange(s.row_start, s.row_start + s.n_fn)
                           for s in bucket.slices])


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
@pytest.mark.parametrize("kind", ["plain", "compactified", "adapted", "swept"])
def test_host_pass1_matches_plain(lib, specs, kind, sampler):
    """Every instantiation on its plans, at a window crossing 2^32 with a
    cut last chunk, against the plain version."""
    (bucket,) = multi.plan_spec(specs[kind], sampler=sampler).buckets
    key = rng.fold_key(15, 3)
    offset, n = 2**32 - 9000, 2048 * 9 + 5
    got, scratch = host_fused_mc(lib, bucket, sampler, key, offset, n)
    assert not (scratch.view(np.uint32) == UNWRITTEN).any()   # every (block, chunk) wrote
    want = _plain(bucket, sampler, key, offset, n)
    rows = _real_rows(bucket)
    np.testing.assert_allclose(got[0, rows], want[0, rows], rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("sampler", ["mc", "sobol"])
@pytest.mark.parametrize("kind", ["plain", "compactified", "adapted"])
def test_host_pass1_rounds_equal_single_rounds(lib, specs, kind, sampler):
    """An R = 2 launch with per-block window starts (one crossing 2^32) on
    each instantiation (<0|1|2, sampler, *>): each round bit-identical to a
    single-round launch at its window, and within tolerance of the plain
    version with the same rounds."""
    (bucket,) = multi.plan_spec(specs[kind], sampler=sampler).buckets
    key = rng.fold_key(15, 4)
    n = 4096
    n_blocks = bucket.fn_ids.shape[0] // template.F_BLK
    base = [(j * 37 * n) % 2**32 for j in range(n_blocks)]
    base[n_blocks // 2] = 2**32 - 3 * n // 2
    both, _ = host_fused_mc(lib, bucket, sampler, key, 0, n, n_rounds=2, round_base=base,
                            round_stride=n)
    for r in range(2):
        one, _ = host_fused_mc(lib, bucket, sampler, key, r * n, n, round_base=base)
        assert both[r].tobytes() == one[0].tobytes()
    want = _plain(bucket, sampler, key, 0, n, n_rounds=2, round_stride=n,
                  round_base=torch.tensor(base, dtype=torch.int64))
    rows = _real_rows(bucket)
    np.testing.assert_allclose(both[:, rows], want[:, rows], rtol=1e-4, atol=1e-2)
