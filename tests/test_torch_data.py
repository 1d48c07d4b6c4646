"""The port's token pipeline (repro_torch.data) against repro's: the cases
of tests/data/test_pipeline.py, and the port's batches bit-equal to the
reference's (tokens, labels, audio frames, vision embeddings, M-RoPE
positions) for three steps, a row subset and a stream restored from a
snapshot."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.pipeline import TokenStream as JTokenStream
from repro_torch.configs import get_config, reduced
from repro_torch.data import StreamState, TokenStream

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _cfg(name="stablelm_3b"):
    return reduced(get_config(name))


def _stream(batch, seq, seed, name="stablelm_3b"):
    return TokenStream(_cfg(name), batch, seq, seed=seed, device="cpu")


def test_deterministic_across_instances():
    a = _stream(8, 32, 3).next_batch()
    b = _stream(8, 32, 3).next_batch()
    assert torch.equal(a["tokens"], b["tokens"])


def test_steps_differ():
    s = _stream(4, 16, 0)
    assert not torch.equal(s.next_batch()["tokens"], s.next_batch()["tokens"])


def test_snapshot_restore_resumes_stream():
    s = _stream(4, 16, 1)
    s.next_batch()
    snap = s.snapshot()
    b_next = s.next_batch()
    s2 = _stream(4, 16, 1)
    s2.restore(snap)
    assert torch.equal(b_next["tokens"], s2.next_batch()["tokens"])
    assert s2.state == StreamState(step=2)


def test_row_sharding_consistent():
    """A host holding rows [2,3] sees exactly those rows of the global batch."""
    full = _stream(8, 16, 2).next_batch()
    part = _stream(8, 16, 2).next_batch(rows=np.array([2, 3]))
    assert torch.equal(full["tokens"][2:4], part["tokens"])


def test_tokens_in_vocab():
    cfg = _cfg()
    t = TokenStream(cfg, 4, 64, seed=5, device="cpu").next_batch()["tokens"]
    assert t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size


def test_modalities():
    enc = _stream(2, 16, 0, "hubert_xlarge").next_batch()
    assert set(enc) == {"frames", "labels"}
    assert enc["frames"].shape == (2, 16, 32) and enc["frames"].dtype == torch.float32
    vlm = _stream(2, 16, 0, "qwen2_vl_7b").next_batch()
    assert {"tokens", "labels", "vision_embeds", "positions"} <= set(vlm)
    assert vlm["positions"].shape == (3, 2, 16)
    assert vlm["vision_embeds"].shape == (2, 2, 32)


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(_cfg(), 2, 8)


@pytest.mark.parametrize("name", ["stablelm_3b", "mamba2_130m", "hubert_xlarge",
                                  "qwen2_vl_7b"])
def test_batches_bit_equal_to_reference(name):
    """Three steps of the whole batch, then a row subset, then a stream
    restored at step 5 from a snapshot (a step count past the u32 wrap of
    c0 = step * batch + row is checked in test_counters_wrap_as_u32)."""
    jcfg, cfg = jreduced(jget_config(name)), reduced(get_config(name))
    ref = JTokenStream(jcfg, 8, 40, seed=11)
    got = TokenStream(cfg, 8, 40, seed=11, device="cpu")
    rows = [None, None, None, np.array([6, 1, 3])]
    for r in rows:
        _assert_batch_equal(got.next_batch(r), ref.next_batch(r))
    ref.restore({"step": 5})
    got.restore({"step": 5})
    _assert_batch_equal(got.next_batch(), ref.next_batch())


def test_counters_wrap_as_u32():
    jcfg, cfg = jreduced(jget_config("qwen2_vl_7b")), reduced(get_config("qwen2_vl_7b"))
    step = (1 << 32) // 8 + 3                         # step * batch wraps c0
    ref = JTokenStream(jcfg, 8, 24, seed=2)
    got = TokenStream(cfg, 8, 24, seed=2, device="cpu")
    ref.restore({"step": step})
    got.restore({"step": step})
    _assert_batch_equal(got.next_batch(np.array([0, 7])), ref.next_batch(np.array([0, 7])))


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), k   # bit for bit
