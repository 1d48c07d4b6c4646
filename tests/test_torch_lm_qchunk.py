"""The q-chunked q-sequence case on a ``model`` degree that does not divide
``Q_CHUNK``: reduced qwen2.5 (4 heads on 2 KV heads: neither the KV heads,
the group of 2 nor the heads split 3 ways) served on (1, 3) gloo ranks with
its q-chunk threshold lowered to 8, so that both prompts take the q-chunked
path with the real ``Q_CHUNK`` of 1024 rows:

* 1000 tokens, one ragged block, padded to 1002 rows (334 a rank);
* 1100 tokens, an interior block of 1024 rows that 3 does not divide,
  padded to 1026 (its 2 dummy rows before the next block's), and a ragged
  block of 76 padded to 78.

Each prompt's prefill and two greedy decode steps on the mesh equal one
device's (the same seeded weights) and the reference's (those weights
carried across), and the collectives each rank counts equal
``dryrun.serve_collectives``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, multihost
from repro_torch.launch.serve import Server
from repro_torch.models import layers
from repro_torch.models.convert import reference_params

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ARCH, OVER, M = "qwen2_5_32b", {"attn_q_chunk_threshold": 8}, 3
PROMPTS = (1000, 1100)
B, NEW = 1, 2
LOGIT_TOL = 1e-4              # of the largest |logit| (tests/test_torch_lm_cp.py's)


def _cfg():
    return reduced(get_config(ARCH)).with_overrides(**OVER)


def _tokens(s: int) -> np.ndarray:
    return np.random.default_rng(s).integers(0, 256, (B, s)).astype(np.int32)


def _logits(server, s: int):
    """Prefill and NEW greedy decode steps of the prompt of ``s`` tokens:
    the logits of each (whole over the vocab), and the collectives of each
    with its greedy pick."""
    from repro_torch.distributed import collectives
    prompt = {"tokens": torch.from_numpy(_tokens(s))}
    local, _ = server.local(prompt)
    cap, logits, counted = s + NEW, [], []
    step = lambda: server.compute.prefill(local, cap)
    with server.context(B, B), torch.no_grad():
        for i in range(NEW + 1):
            collectives.reset_counters()
            lg, cache = step()
            tok = server._sample(lg, 0.0, None)
            c = collectives.counters()
            counted.append({k: c[k] for k in dryrun._empty()})
            if lg.shape[-1] != server.cfg.vocab_padded:
                lg = torch.cat(collectives.all_gather_axes(lg, server.mesh, ("model",)), -1)
            logits.append(lg)
            step = functools.partial(server.compute.decode_step, cache, tok, s + i, cap)
    return torch.stack(logits).float().numpy()[..., :server.cfg.vocab_size], counted


def _ranks():
    from repro_torch.launch.mesh import make_mesh_for
    torch.set_num_threads(1)
    cfg = _cfg()
    mesh = make_mesh_for(model_parallel=M, device="cpu")
    server = Server(cfg, mesh=mesh, device="cpu")
    out = {}
    for s in PROMPTS:
        logits, counted = _logits(server, s)
        derived = [dryrun.serve_collectives(cfg, mesh, B, n, s + NEW) for n in (s, 1)]
        out[s] = {"logits": logits, "counted": counted[:2],
                  "derived": [{k: v for k, v in d.items() if k != "total_bytes"}
                              for d in derived]}
    return out


@pytest.fixture(scope="module")
def served():
    port = multihost.spawn(_ranks, M, device="cpu", timeout=300)
    cfg = _cfg()
    one = Server(cfg, device="cpu")
    jm = JModel(jreduced(jget_config(ARCH)).with_overrides(**OVER))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), reference_params(one.model))
    ref = {}
    for s in PROMPTS:
        lg, cache = jm.prefill(params, {"tokens": jnp.asarray(_tokens(s))}, seq_cap=s + NEW)
        steps = [np.asarray(lg)]
        for i in range(NEW):
            tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
            lg, cache = jm.decode_step(params, cache, tok, jnp.int32(s + i))
            steps.append(np.asarray(lg))
        ref[s] = np.stack(steps).astype(np.float32)[..., :cfg.vocab_size]
    return port, {s: _logits(one, s)[0] for s in PROMPTS}, ref


def test_chunks_of_the_two_prompts():
    """The first prompt is one padded block; the second an interior block
    padded past Q_CHUNK and a padded ragged one, no slot of one block
    holding a row of the next."""
    threshold = OVER["attn_q_chunk_threshold"]
    assert layers.cp_chunks(1000, M, threshold) == [(0, 1002)]
    chunks = layers.cp_chunks(1100, M, threshold)
    assert chunks == [(0, 1026), (1024, 78)]
    pos = layers.cp_positions(chunks, 1100)
    assert pos[1023:1027] == [1023, -1, -1, 1024] and pos[-3:] == [1099, -1, -1]
    assert [len(layers.cp_rows(chunks, M, r)) for r in range(M)] == [368] * M


@pytest.mark.parametrize("s", PROMPTS)
def test_mesh_matches_one_device_and_reference(served, s):
    port, one, ref = served
    scale = np.abs(ref[s]).max()
    assert np.abs(one[s] - ref[s]).max() <= LOGIT_TOL * scale
    for rank in port:
        got = rank[s]["logits"]
        assert got.shape == one[s].shape == (NEW + 1, B, _cfg().vocab_size)
        assert np.isfinite(got).all()
        assert np.abs(got - one[s]).max() <= LOGIT_TOL * scale
        assert np.abs(got - ref[s]).max() <= LOGIT_TOL * scale


@pytest.mark.parametrize("s", PROMPTS)
def test_collectives_equal_the_dry_run(served, s):
    port, _, _ = served
    for rank in port:
        res = rank[s]
        assert res["counted"] == res["derived"]       # the prefill, a decode step
        assert res["counted"][0]["all-gather"]["count"] > 0
