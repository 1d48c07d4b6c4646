"""The port's int8 compression against ``repro.distributed.compression``:
quantize, dequantize, error feedback and the tree helpers bit-equal on
seeded inputs, and ``compressed_psum`` on two gloo ranks within the bound
``repro``'s distributed check uses (tests/distributed/progs/
prog_sharded_mc.py: shards x max|x| / 127 plus 1e-5).  The ranks import
only torch and the port (``repro`` is imported inside the tests)."""

import numpy as np
import pytest
import torch

from repro_torch.distributed import compression
from repro_torch.launch import multihost

torch.set_num_threads(1)

SHAPES = [(7,), (8, 4), (3, 5, 2)]


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 250.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_dequantize_bit_equal(shape, scale):
    from repro.distributed import compression as jcomp
    x = _x(shape, 1, scale)
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(x)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(js)))
    np.testing.assert_array_equal(_bits(compression.dequantize(q, s).numpy()),
                                  _bits(jcomp.dequantize(jq, js)))


def test_quantize_of_zeros_keeps_the_floor_scale():
    q, s = compression.quantize(torch.zeros(5))
    assert float(s) == pytest.approx(1e-12) and not q.any()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ef_compress_bit_equal(shape):
    from repro.distributed import compression as jcomp
    g, err = _x(shape, 2), _x(shape, 3, 1e-2)
    ghat, new_err = compression.ef_compress(torch.from_numpy(g), torch.from_numpy(err))
    jghat, jerr = jcomp.ef_compress(g, err)
    np.testing.assert_array_equal(_bits(ghat.numpy()), _bits(jghat))
    np.testing.assert_array_equal(_bits(new_err.numpy()), _bits(jerr))


def test_compress_tree_bit_equal_and_feeds_back():
    """A nested dict and a list, two error-feedback steps each: the port
    equals repro's tree map, and the residual carries into the next step."""
    from repro.distributed import compression as jcomp
    tree = {"w": _x((4, 3), 4), "inner": {"b": _x((3,), 5), "a": _x((2, 2), 6)}}
    for grads in (tree, [tree["w"], tree["inner"]["b"]]):
        as_t = ({k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                 for k, v in grads.items()} if isinstance(grads, dict)
                else [torch.from_numpy(g) for g in grads])
        err, jerr = compression.init_error_tree(as_t), jcomp.init_error_tree(grads)
        for _ in range(2):
            ghat, err = compression.compress_tree(as_t, err)
            jghat, jerr = jcomp.compress_tree(grads, jerr)
            got = _leaves(ghat) + _leaves(err)
            want = _leaves(jghat) + _leaves(jerr)
            assert len(got) == len(want) == 2 * len(_leaves(as_t))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(_bits(a), _bits(b))
        assert any(np.abs(e).max() > 0 for e in _leaves(err))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)]


def _psum_rank():
    """Each rank holds its half of prog_sharded_mc.py's x; returns the
    int8 psum over "data" and the float psum_fixed beside it on a (2, 1)
    mesh, and the halves' rows gathered on a (1, 2) mesh."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_mesh_for
    mesh = make_mesh_for(model_parallel=1, device="cpu")
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4) / 7.0
    local = x.reshape(2, 4, 4)[dist.get_rank()]
    rows = collectives.gather_rows(local, make_mesh_for(model_parallel=2, device="cpu"),
                                   "model")
    return (compression.compressed_psum(local, mesh, "data").numpy(),
            collectives.psum_fixed(local, mesh, ("data",)).numpy(), rows.numpy())


def test_compressed_psum_within_its_bound(tmp_path):
    got = multihost.spawn(_psum_rank, 2, init_file=str(tmp_path / "rendezvous"),
                          timeout=120)
    x = np.arange(32, dtype=np.float32).reshape(8, 4) / 7.0
    want = x.reshape(2, 4, 4).sum(0)
    tol = float(np.abs(x).max()) / 127 * 2 + 1e-5
    for comp, exact, rows in got:
        np.testing.assert_array_equal(comp, got[0][0])
        assert np.abs(comp - want).max() <= tol
        assert 0 < np.abs(comp - want).max()        # it did quantise
        np.testing.assert_array_equal(exact, x[:4] + x[4:])
        np.testing.assert_array_equal(rows, x)      # (1, 2): rows in rank order
