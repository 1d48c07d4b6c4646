"""Host build of the CUDA kernel's device header.

``src/repro_torch/kernels/csrc/zmc_device.cuh`` holds the per-sample
arithmetic of the fused kernel (Threefry, the uniform, the affine map,
the five eval bodies, the compactification's per-axis map, the
importance grid's per-axis map and the Sobol point, its walk, shift and
uniform)
as host/device inline functions.  This
test
compiles it with g++ through a small C shim into a shared library, loads
it with ctypes, and holds it against the port's plain PyTorch versions:
Threefry bit for bit, the bodies within 1e-5 relative (plus an absolute
floor of 1e-6 for values near zero; libm's and PyTorch's cosf/expf/logf
may differ by an ulp).  It catches arithmetic errors in the CUDA code
without a card.  The Sobol functions are held bit for bit against
``repro.core.sobol`` itself.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import rng
from repro_torch.kernels import registry
from repro_torch.kernels.build import CSRC

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

SHIM = r"""
#include <stdint.h>
#include "zmc_device.cuh"
extern "C" {
void host_random_bits(uint32_t k0, uint32_t k1, const uint32_t* c0,
                      const uint32_t* c1, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = zmc::random_bits(k0, k1, c0[i], c1[i]);
}
void host_uniform(const uint32_t* bits, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = zmc::bits_to_uniform(bits[i]);
}
// row i: params p[i, :n_cols], point x[i, :dim]
void host_body(int form, int dim, const float* p, int n_cols, const float* x,
               long n, float* out) {
  for (long i = 0; i < n; ++i)
    out[i] = zmc::eval_point_form(form, p + i * n_cols, x + i * dim, dim);
}
void host_transform(const float* u, const float* kind, const float* shift,
                    long n, float* x, float* jac) {
  for (long i = 0; i < n; ++i) x[i] = zmc::apply_transform(u[i], kind[i], shift[i], jac + i);
}
// the Sobol point of idx[i] on each of dim dims (v: u32[dim][32]), and
// the shift of (fn_ids[i], d)
void host_sobol(const uint32_t* v, int dim, uint32_t k0, uint32_t k1,
                const uint32_t* idx, const uint32_t* fn_ids, long n, uint32_t* pt,
                uint32_t* sh) {
  for (long i = 0; i < n; ++i)
    for (int d = 0; d < dim; ++d) {
      pt[i * dim + d] = zmc::sobol_point(v + 32 * d, idx[i]);
      sh[i * dim + d] = zmc::sobol_shift(k0, k1, fn_ids[i] * zmc::DIM_STRIDE + d);
    }
}
// one thread's run of indices start + 256 k (u32 wrap), k < n, as the
// kernel walks it: the point built at k = 0, then stepped by sobol_walk
void host_sobol_walk(const uint32_t* v, int dim, uint32_t start, long n, uint32_t* pt) {
  for (int d = 0; d < dim; ++d) pt[d] = zmc::sobol_point(v + 32 * d, start);
  for (long k = 1; k < n; ++k)
    for (int d = 0; d < dim; ++d)
      pt[k * dim + d] = zmc::sobol_walk(v + 32 * d, pt[(k - 1) * dim + d],
                                        start + (uint32_t)(256 * k));
}
void host_sobol_uniform(const uint32_t* pt, const uint32_t* sh, long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = zmc::sobol_uniform(pt[i] >> 8, sh[i] >> 8);
}
// the grid map of u[i] through the edges e[i, :n_bins + 1]: the mapped
// point and the Jacobian factor
void host_apply_map(const float* u, const float* e, int n_bins, long n, float* x,
                    float* w) {
  for (long i = 0; i < n; ++i) x[i] = zmc::apply_map_axis(u[i], e + i * (n_bins + 1), n_bins, w + i);
}
// an adapted row: grid edges from acol, transform columns from tcol (or -1)
void host_body_adapted(int form, int dim, const float* p, int n_cols, int acol,
                       int n_bins, int tcol, const float* u, long n, float* out) {
  for (long i = 0; i < n; ++i)
    out[i] = zmc::eval_point_adapted(form, p + i * n_cols, acol, n_bins, tcol,
                                     u + i * dim, dim);
}
// a compactified row: transform columns from tcol
void host_body_compact(int form, int dim, const float* p, int n_cols, int tcol,
                       const float* x, long n, float* out) {
  for (long i = 0; i < n; ++i)
    out[i] = zmc::eval_point_compact(form, p + i * n_cols, tcol, x + i * dim, dim);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("zmc_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libzmc_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-I", str(CSRC),
                    "-o", str(so), str(d / "shim.cpp")], check=True,
                   capture_output=True, text=True, timeout=300)
    out = ctypes.CDLL(str(so))
    ptr, u32 = ctypes.c_void_p, ctypes.c_uint32
    out.host_random_bits.argtypes = [u32, u32, ptr, ptr, ptr, ctypes.c_long]
    out.host_uniform.argtypes = [ptr, ptr, ctypes.c_long]
    out.host_body.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ctypes.c_int,
                              ptr, ctypes.c_long, ptr]
    out.host_transform.argtypes = [ptr, ptr, ptr, ctypes.c_long, ptr, ptr]
    out.host_body_compact.argtypes = [ctypes.c_int, ctypes.c_int, ptr,
                                      ctypes.c_int, ctypes.c_int, ptr,
                                      ctypes.c_long, ptr]
    out.host_sobol.argtypes = [ptr, ctypes.c_int, u32, u32, ptr, ptr,
                               ctypes.c_long, ptr, ptr]
    out.host_sobol_uniform.argtypes = [ptr, ptr, ctypes.c_long, ptr]
    out.host_sobol_walk.argtypes = [ptr, ctypes.c_int, u32, ctypes.c_long, ptr]
    out.host_apply_map.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_long, ptr,
                                   ptr]
    out.host_body_adapted.argtypes = [ctypes.c_int, ctypes.c_int, ptr,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ptr, ctypes.c_long, ptr]
    for f in (out.host_random_bits, out.host_uniform, out.host_body,
              out.host_transform, out.host_body_compact, out.host_sobol,
              out.host_sobol_uniform, out.host_sobol_walk, out.host_apply_map,
              out.host_body_adapted):
        f.restype = None
    return out


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_threefry_and_uniform_bit_exact(lib):
    r = np.random.default_rng(0)
    n = 10_000
    c0 = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    c0[:64] = (2**32 - 32 + np.arange(64)) % 2**32           # c0 wrap
    fn = r.integers(0, 2**24, n, dtype=np.uint64)
    fn[:8] = 2**24 - 1
    c1 = ((fn * rng.DIM_STRIDE + r.integers(0, 256, n)) % 2**32).astype(np.uint32)
    k0, k1 = rng.fold_key(1234, 5)
    got = np.empty(n, np.uint32)
    lib.host_random_bits(k0, k1, _ptr(c0), _ptr(c1), _ptr(got), n)
    want = rng.random_bits(k0, k1, c0, c1).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)

    u = np.empty(n, np.float32)
    lib.host_uniform(_ptr(got), _ptr(u), n)
    np.testing.assert_array_equal(u, rng.bits_to_uniform(torch.from_numpy(
        want.astype(np.int64))).numpy())


@pytest.mark.parametrize("form_name", [
    "mc_eval_harmonic", "mc_eval_abs_sum", "mc_eval_gaussian",
    "mc_eval_genz_osc", "mc_eval_genz_corner"])
@pytest.mark.parametrize("dim", [1, 4])
def test_body_matches_plain(lib, form_name, dim):
    form = registry.form(form_name)
    r = np.random.default_rng(form.form_id * 10 + dim)
    n = 2_500
    n_cols = form.n_cols(dim)
    p = r.uniform(0.2, 2.0, (n, n_cols)).astype(np.float32)
    if form_name == "mc_eval_harmonic":
        p[:, 2:] *= 60.0                   # Fig.-1 phases reach ~350 rad
    if form_name == "mc_eval_abs_sum":
        p[:, 1:] *= np.where(r.random((n, dim)) < 0.5, -1.0, 1.0)
    x = r.uniform(0.0, 1.0, (n, dim)).astype(np.float32)
    got = np.empty(n, np.float32)
    lib.host_body(form.form_id, dim, _ptr(p), n_cols, _ptr(x), n, _ptr(got))
    xt = torch.from_numpy(x)[:, None, :]
    want = form.body(lambda d: xt[:, :, d], torch.from_numpy(p), dim)[:, 0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_unknown_form_is_nan(lib):
    p = np.ones((1, 4), np.float32)
    x = np.full((1, 2), 0.5, np.float32)
    got = np.zeros(1, np.float32)
    lib.host_body(registry.N_DEVICE_FORMS, 2, _ptr(p), 4, _ptr(x), 1, _ptr(got))
    assert np.isnan(got[0])


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_apply_transform_matches_plain(lib, kind):
    from repro_torch.core import domains
    r = np.random.default_rng(kind + 40)
    n = 4_000
    u = r.uniform(0.0, 1.0, n).astype(np.float32)
    u[:5] = [0.0, 1e-9, 0.5, 1 - 1e-7, 0.99999994]        # the clamp edges
    k = np.full(n, kind, np.float32)                        # f32, as packed
    shift = r.uniform(-3.0, 3.0, n).astype(np.float32)
    x, jac = np.empty(n, np.float32), np.empty(n, np.float32)
    lib.host_transform(_ptr(u), _ptr(k), _ptr(shift), n, _ptr(x), _ptr(jac))
    wx, wj = domains.apply_transform(torch.from_numpy(u), torch.from_numpy(k),
                                     torch.from_numpy(shift))
    # near the poles the Jacobian reaches ~1e14, so compare relatively
    np.testing.assert_allclose(x, wx.numpy(), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(jac, wj.numpy(), rtol=2e-6, atol=1e-6)


# (a harmonic of a compactified axis takes cos of x up to ~1e7, where one
# ulp of x is a different phase: ill-conditioned, as repro's own tests note)
@pytest.mark.parametrize("form_name", ["mc_eval_gaussian", "mc_eval_abs_sum"])
def test_compactified_body_matches_plain(lib, form_name):
    from repro_torch.kernels import template
    form = registry.form(form_name)
    dim = 3
    r = np.random.default_rng(7)
    n = 2_000
    base = form.n_cols(dim)
    p = np.concatenate([
        r.uniform(0.5, 2.0, (n, base)),
        r.integers(0, 4, (n, dim)),                         # kinds
        r.uniform(-1.0, 1.0, (n, dim))], axis=1).astype(np.float32)
    x = r.uniform(0.0, 1.0, (n, dim)).astype(np.float32)
    got = np.empty(n, np.float32)
    lib.host_body_compact(form.form_id, dim, _ptr(p), p.shape[1], base,
                          _ptr(x), n, _ptr(got))
    xt = torch.from_numpy(x)[:, None, :]
    body = template.compactified_body(form.body, base)
    want = body(lambda d: xt[:, :, d], torch.from_numpy(p), dim)[:, 0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [1, 5, 8])
def test_sobol_point_shift_and_uniform_bit_exact(lib, dim):
    """The header's Gray-code point and digital shift against repro's
    sobol_bits and shifts_for, indices on both sides of 2^32; the uniform
    of point ^ shift from their top 24 bits against sobol_uniforms_for."""
    from repro.core import sobol as jsobol
    r = np.random.default_rng(dim)
    n = 4_000
    idx = np.concatenate([np.arange(n // 2), 2**32 - n // 4 + np.arange(n // 2)])
    idx = (idx % 2**32).astype(np.uint32)
    fn = r.integers(0, 2**24, n, dtype=np.uint64).astype(np.uint32)
    k0, k1 = rng.fold_key(99, dim)
    v = np.ascontiguousarray(jsobol.direction_vectors(dim))
    pt = np.empty((n, dim), np.uint32)
    sh = np.empty((n, dim), np.uint32)
    lib.host_sobol(_ptr(v), dim, k0, k1, _ptr(idx), _ptr(fn), n, _ptr(pt), _ptr(sh))
    np.testing.assert_array_equal(pt, np.asarray(jsobol.sobol_bits(idx, dim)))
    np.testing.assert_array_equal(sh, np.asarray(jsobol.shifts_for(k0, k1, fn, dim)))
    u = np.empty(n * dim, np.float32)
    lib.host_sobol_uniform(_ptr(pt), _ptr(sh), n * dim, _ptr(u))
    sub = slice(None, None, 97)        # (function, sample) pairs on the diagonal
    want_u = np.asarray(jsobol.sobol_uniforms_for(k0, k1, fn[sub], idx[sub], dim))
    np.testing.assert_array_equal(u.reshape(n, dim)[sub],
                                  np.einsum("iid->id", want_u))


@pytest.mark.parametrize("dim", range(1, 9))
def test_sobol_walk_bit_exact(lib, dim):
    """The header's Gray-code walk along one kernel thread's run of indices
    (start, start + 256, ...), from a start near 2^32 across the wrap,
    against sobol_bits of the port and of repro at every index."""
    from repro.core import sobol as jsobol
    from repro_torch.core import sobol
    n = 300
    for start in (2**32 - 256 * 120 - 77, 2**32 - 256 * 3 + 255, 2**32 - 256):
        v = np.ascontiguousarray(jsobol.direction_vectors(dim))
        pt = np.empty((n, dim), np.uint32)
        lib.host_sobol_walk(_ptr(v), dim, start, n, _ptr(pt))
        idx = ((start + 256 * np.arange(n, dtype=np.int64)) % 2**32).astype(np.uint32)
        assert idx[-1] < idx[0]                            # the run crosses 2^32
        np.testing.assert_array_equal(pt, np.asarray(jsobol.sobol_bits(idx, dim)))
        want = sobol.sobol_bits(torch.from_numpy(idx.astype(np.int64)), dim)
        np.testing.assert_array_equal(pt, want.numpy().astype(np.uint32))


@pytest.mark.parametrize("n_bins", [1, 4, 16])
def test_apply_map_axis_matches_plain(lib, n_bins):
    """The header's per-axis grid map against the port's apply_map: the
    bin exactly (the Jacobian factor is n_bins times the width of the bin
    ``min(int(u * n_bins), n_bins - 1)``, bit for bit), the point within
    1e-6 (the card may contract e0 + frac * width into one FMA)."""
    from repro_torch.core import adaptive
    r = np.random.default_rng(n_bins)
    n = 5_000
    widths = r.uniform(0.01, 3.0, (n, n_bins))
    e = (r.uniform(-5, 5, (n, 1)) + np.concatenate(
        [np.zeros((n, 1)), np.cumsum(widths, 1)], 1)).astype(np.float32)
    u = r.integers(0, 1 << 24, n).astype(np.float32) * np.float32(2.0**-24)
    u[:3] = [0.0, 0.5, 1 - 2.0**-24]
    x, w = np.empty(n, np.float32), np.empty(n, np.float32)
    lib.host_apply_map(_ptr(u), _ptr(e), n_bins, n, _ptr(x), _ptr(w))
    idx = np.minimum((u * np.float32(n_bins)).astype(np.int64), n_bins - 1)
    rows = np.arange(n)
    width = e[rows, idx + 1] - e[rows, idx]
    np.testing.assert_array_equal(w, width * np.float32(n_bins))
    wx, wj = adaptive.apply_map(torch.from_numpy(u)[:, None],
                                torch.from_numpy(e)[:, None, :])
    np.testing.assert_array_equal(w, wj.numpy())
    np.testing.assert_allclose(x, wx[:, 0].numpy(), rtol=1e-6, atol=1e-6)
    assert np.all((e[rows, idx] <= x) & (x <= e[rows, idx + 1]))


@pytest.mark.parametrize("form_name", ["mc_eval_genz_corner", "mc_eval_gaussian"])
@pytest.mark.parametrize("compact", [False, True])
def test_adapted_body_matches_plain(lib, form_name, compact):
    """An adapted row (grid edges after the form's columns, transform
    columns after the edges when compactified) through the header against
    template.adapted_body(compactified_body(body))."""
    from repro_torch.kernels import template
    form = registry.form(form_name)
    dim, n_bins = 3, 8
    r = np.random.default_rng(11 + compact)
    n = 2_000
    base = form.n_cols(dim)
    widths = r.uniform(0.05, 1.0, (n, dim, n_bins))
    edges = np.concatenate([np.zeros((n, dim, 1)), np.cumsum(widths, -1)], -1)
    edges /= edges[..., -1:]                               # span [0, 1]
    cols = [r.uniform(0.5, 2.0, (n, base)), edges.reshape(n, -1)]
    if compact:
        cols += [r.integers(0, 4, (n, dim)), r.uniform(-1.0, 1.0, (n, dim))]
    p = np.concatenate(cols, axis=1).astype(np.float32)
    acol, tcol = base, (base + dim * (n_bins + 1) if compact else -1)
    u = r.integers(0, 1 << 24, (n, dim)).astype(np.float32) * np.float32(2.0**-24)
    got = np.empty(n, np.float32)
    lib.host_body_adapted(form.form_id, dim, _ptr(p), p.shape[1], acol, n_bins,
                          tcol, _ptr(u), n, _ptr(got))
    body = form.body
    if compact:
        body = template.compactified_body(body, tcol)
    body = template.adapted_body(body, acol, n_bins)
    ut = torch.from_numpy(u)[:, None, :]
    want = body(lambda d: ut[:, :, d], torch.from_numpy(p), dim)[:, 0]
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=1e-6)
