"""Pass 1 of the fused CUDA kernel, run on the host.

``src/repro_torch/kernels/csrc/fused_mc_pass1.cuh`` is compiled with g++
against a small stand-in for the CUDA runtime: each CUDA block runs as 256
lanes taking turns on one host thread, each lane with its own stack and
switched only at a barrier (``__syncthreads``, and the two warp barriers
around each shuffle, which goes through a shared array), ``__shared__`` as
static storage.  Every instantiation the
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
// the lane that runs now: one host thread runs every lane of a block in turn
extern Dim3 threadIdx;
extern Dim3 blockIdx;
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
// a barrier of warp w (0-7) or of the block (8): the lane waits there while
// the other lanes run, until every lane of the group has arrived
void zmc_barrier(int group);
extern float g_warp_val[8][32];
extern float* g_smem;
inline void __syncthreads() { zmc_barrier(8); }
inline float __shfl_down_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  g_warp_val[w][lane] = v;
  zmc_barrier(w);
  const float r = lane + off < 32 ? g_warp_val[w][lane + off] : v;
  zmc_barrier(w);
  return r;
}
"""

# The block's 256 lanes are fibers on one host thread, each with its own
# stack, switched at barriers only: a lane runs until it reaches a barrier,
# then the next runnable lane runs; the last lane to arrive releases the
# others and goes on.  The same lanes meet at the same barriers as on the
# card, and a barrier that some lane never reaches fails the launch instead
# of hanging it.
LAUNCHER = r"""
#include <memory>
#include <vector>
#include "cuda_runtime.h"
Dim3 threadIdx;
Dim3 blockIdx;
float g_warp_val[8][32];
float* g_smem;
#include "pass1_host.cuh"

enum { RUNNABLE = -1, DONE = -2 };  // else: the group the lane waits at
struct Lane { void* sp; int state; };
static Lane g_lane[THREADS];
static void* g_sched_sp;
static int g_arrived[9];
static void (*g_body)();
static const zmc::Pass1Args* g_args;

// Saves the callee-saved registers and the stack pointer into *from and
// resumes the context saved at to.
extern "C" void zmc_swap(void** from, void* to);
#if defined(__x86_64__)
asm(R"(
.text
.globl zmc_swap
.type zmc_swap, @function
zmc_swap:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size zmc_swap, .-zmc_swap
)");
#elif defined(__aarch64__)
asm(R"(
.text
.globl zmc_swap
.type zmc_swap, %function
zmc_swap:
  sub sp, sp, #176
  stp x19, x20, [sp, #0]
  stp x21, x22, [sp, #16]
  stp x23, x24, [sp, #32]
  stp x25, x26, [sp, #48]
  stp x27, x28, [sp, #64]
  stp x29, x30, [sp, #80]
  stp d8, d9, [sp, #96]
  stp d10, d11, [sp, #112]
  stp d12, d13, [sp, #128]
  stp d14, d15, [sp, #144]
  mov x9, sp
  str x9, [x0]
  mov sp, x1
  ldp x19, x20, [sp, #0]
  ldp x21, x22, [sp, #16]
  ldp x23, x24, [sp, #32]
  ldp x25, x26, [sp, #48]
  ldp x27, x28, [sp, #64]
  ldp x29, x30, [sp, #80]
  ldp d8, d9, [sp, #96]
  ldp d10, d11, [sp, #112]
  ldp d12, d13, [sp, #128]
  ldp d14, d15, [sp, #144]
  add sp, sp, #176
  ret
.size zmc_swap, .-zmc_swap
)");
#else
#error "the host pass 1 switches lanes on x86-64 and aarch64 only"
#endif

static void lane_main() {
  g_body();
  g_lane[threadIdx.x].state = DONE;
  zmc_swap(&g_lane[threadIdx.x].sp, g_sched_sp);  // never resumed
  __builtin_trap();
}

// A fresh lane's saved context: zmc_swap's restore returns into lane_main.
static void* new_lane(char* stack_top) {
  auto* sp = reinterpret_cast<uintptr_t*>(reinterpret_cast<uintptr_t>(stack_top) & ~uintptr_t(15));
#if defined(__x86_64__)
  *--sp = 0;                                        // lane_main's return address
  *--sp = reinterpret_cast<uintptr_t>(&lane_main);  // zmc_swap's
  for (int i = 0; i < 6; ++i) *--sp = 0;            // rbp, rbx, r12-r15
#else
  sp -= 22;
  for (int i = 0; i < 22; ++i) sp[i] = 0;
  sp[11] = reinterpret_cast<uintptr_t>(&lane_main);  // x30, the link register
#endif
  return sp;
}

void zmc_barrier(int group) {
  const unsigned size = group == 8 ? THREADS : 32;
  const unsigned first = group == 8 ? 0 : 32 * group;
  const unsigned t = threadIdx.x;
  if (++g_arrived[group] < (int)size) {
    g_lane[t].state = group;
    zmc_swap(&g_lane[t].sp, g_sched_sp);
    threadIdx.x = t;
    return;
  }
  g_arrived[group] = 0;
  for (unsigned i = first; i < first + size; ++i)
    if (g_lane[i].state == group) g_lane[i].state = RUNNABLE;
}

template <int ST, bool SO, bool SW>
static void body() {
  const zmc::Pass1Args& a = *g_args;
  fused_mc_pass1<ST, SO, SW>(a.k0, a.k1, a.sample_offset, a.n_valid, a.round_stride,
                             a.n_rounds, a.round_base, a.fn_ids, a.block_meta, a.n_sweep,
                             a.sobol_dirs, a.packed, a.n_cols, a.lo, a.hi, a.dim, a.n_fn_pad,
                             a.n_chunks, a.scratch);
}

// Runs the blocks one after another; 2 if some lane waits at a barrier
// that the others never reach.
template <int ST, bool SO, bool SW>
static int run(unsigned n_blocks, const zmc::Pass1Args& a) {
  constexpr size_t STACK = 128 * 1024;
  std::unique_ptr<char[]> stacks(new char[STACK * THREADS]);
  g_body = body<ST, SO, SW>;
  g_args = &a;
  for (unsigned b = 0; b < n_blocks; ++b) {
    blockIdx.x = b;
    for (int g = 0; g < 9; ++g) g_arrived[g] = 0;
    for (unsigned t = 0; t < THREADS; ++t)
      g_lane[t] = {new_lane(stacks.get() + STACK * (t + 1)), RUNNABLE};
    for (unsigned done = 0; done < THREADS;) {
      bool ran = false;
      done = 0;
      for (unsigned t = 0; t < THREADS; ++t) {
        if (g_lane[t].state == RUNNABLE) {
          threadIdx.x = t;
          zmc_swap(&g_sched_sp, g_lane[t].sp);
          ran = true;
        }
        done += g_lane[t].state == DONE;
      }
      if (!ran && done < THREADS) return 2;
    }
  }
  return 0;
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
    case 0: return run<0, false, false>(nb, a);
    case 1: return run<0, false, true>(nb, a);
    case 101: return run<1, false, true>(nb, a);
    case 201: return run<2, false, true>(nb, a);
    case 11: return run<0, true, true>(nb, a);
    case 111: return run<1, true, true>(nb, a);
    case 211: return run<2, true, true>(nb, a);
    default: return 1;
  }
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
                    "-I", str(d), "-o", str(so), str(d / "launch.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
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
