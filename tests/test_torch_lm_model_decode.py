"""The port's prefill and decode (repro_torch.models.model) against repro's
on the same weights (test_torch_lm_model.py's pair: the port's seeded init
handed to the reference as its tree): for every decodable dense
configuration, both DeepSeek (MLA and MoE) configurations and the ssm and
hybrid ones under reduced(), prefill logits and caches (mapped onto the
reference's cache tree, leaf by leaf) and three decode steps, in f32 at
the reference's decode-consistency atol=2e-4
(tests/models/test_decode_consistency.py); and the port's decode against
its own prefill over the longer prompt.  In a file of its own so that
each file's reference compiles stay near a minute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_model import (ATOL, B, CAP, DECODABLE, MOE, S, SSM, _batch, _leaves, _logits,
                                 _pair, _ref_logits)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", DECODABLE + MOE + SSM)
def test_prefill_and_three_decode_steps_match_reference(arch):
    jm, params, model = _pair(arch)
    cfg = model.cfg
    jb, tb = _batch(cfg)
    jlog, jcache = jax.jit(jm.prefill, static_argnames="seq_cap")(params, jb, seq_cap=CAP)
    log, cache = model.prefill(tb, CAP)
    np.testing.assert_allclose(_logits(log, cfg), _ref_logits(jlog, cfg), atol=ATOL)
    assert len(cache) == len(model.plan) == len(model.cache_slots)

    def check_cache():
        got = model.reference_cache(cache)
        want = model.cache_defs(B, CAP)
        assert got.keys() == jcache.keys() == want.keys()
        assert got["stages"].keys() == jcache["stages"].keys()
        for path, ref_leaf in _leaves(jcache):
            got_leaf, spec = _at(got, path), _at(want, path)
            ref_leaf = np.asarray(ref_leaf)
            assert tuple(got_leaf.shape) == ref_leaf.shape == spec.shape, path
            # K/V reach |x| ~ 20 (the fan-in init): the decode bound per
            # unit of the largest magnitude
            np.testing.assert_allclose(got_leaf.numpy(), ref_leaf, rtol=0,
                                       atol=ATOL * max(1.0, float(np.abs(ref_leaf).max())),
                                       err_msg="/".join(path))

    check_cache()
    rng = np.random.default_rng(2)
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
        jlog, jcache = decode(params, jcache, jnp.asarray(tok), jnp.int32(S + i))
        log, cache = model.decode_step(cache, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(_logits(log, cfg), _ref_logits(jlog, cfg), atol=ATOL)
    check_cache()


@pytest.mark.parametrize("arch", ["stablelm_3b", "chatglm3_6b", "minitron_4b",
                                  "deepseek_v2_lite_16b"] + SSM)
def test_decode_matches_extended_prefill(arch):
    """Three decode steps equal a prefill over the prompt and the three
    tokens (the port alone, as repro's test_multi_step_decode; the SSM
    families too within its 2e-4, where repro allows them 5e-4 after three
    steps)."""
    _, _, model = _pair(arch)
    _, tb = _batch(model.cfg)
    extra = torch.tensor([[3, 9, 11], [5, 7, 13]], dtype=torch.int32)
    _, cache = model.prefill(tb, CAP)
    for i in range(3):
        dec, cache = model.decode_step(cache, extra[:, i:i + 1], S + i)
        full, _ = model.prefill({"tokens": torch.cat([tb["tokens"], extra[:, :i + 1]], 1)}, CAP)
        np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)
    logits = model.forward({"tokens": torch.cat([tb["tokens"], extra], 1)})
    np.testing.assert_allclose(dec.numpy(), logits[:, -1].detach().numpy(), atol=ATOL)
