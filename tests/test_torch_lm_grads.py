"""The port's training loss and gradients (repro_torch.models.model.Model.loss)
against jax.value_and_grad of repro's Model.loss, for every architecture
under reduced(), in f32, with the reference's weights carried across by
params_from_reference.  This covers the encoder's same-position loss
(shift 0), the VLM's vision splice and M-RoPE positions, DeepSeek-V3's
multi-token-prediction loss (and its bf16 optimizer moments, in the train
state's layout), MLA and the MoE feed-forward, the Mamba-2 block, and the
hybrid's shared block, whose one set of weights sums its gradient over its
invocations."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import train as jtrain
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.checkpoint import leaf_paths
from repro_torch.launch import train
from repro_torch.models.convert import params_from_reference, reference_params, stack_tree
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import is_stacked, map_leaves

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

B, S = 2, 16
# The loss: f32 sums in another order, ~1e-7 of it.  Gradients, leaf by
# leaf: the largest |diff| within GRAD_REL of the leaf's largest |g|.  The
# reference's fan-in init makes attention near one-hot (|q.k| / sqrt(hd)
# large), which multiplies f32 rounding in the score gradients; the worst
# leaf measured on this host was stablelm-3b's wk at 5.4e-4
LOSS_RTOL, GRAD_REL = 1e-5, 2e-3


def _grads(model):
    """The port's gradients as the reference's tree (a parameter the batch
    does not reach, such as the encoder's token table, as zeros)."""
    def one(p):
        ps = p if is_stacked(p) else [p]
        gs = [q.grad if q.grad is not None else torch.zeros_like(q) for q in ps]
        return gs if is_stacked(p) else gs[0]
    return stack_tree(map_leaves(one, model.param_tree()))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(0))
    model = params_from_reference(jax.tree.map(np.asarray, params), Model(cfg, device="cpu"))
    # the way back: the port's parameters as the reference's tree, bit for bit
    back = dict(leaf_paths(reference_params(model)))
    for path, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert np.array_equal(back["/".join(str(k.key) for k in path)].numpy(), np.asarray(w))
    jb = jconcrete_batch(jcfg, B, S, train=True, seed=1)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    loss, metrics = model.loss(tb)
    loss.backward()
    assert set(metrics) == set(jmetrics) == ({"ce", "mtp", "loss"} if cfg.mtp_depth
                                             else {"ce", "loss"})
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=LOSS_RTOL)
    got = dict(leaf_paths(_grads(model)))
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    assert sorted(got) == sorted("/".join(str(k.key) for k in p) for p, _ in want)
    for path, w in want:
        name = "/".join(str(k.key) for k in path)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=name)
    if cfg.family == "hybrid":    # one set of shared weights, reached by every invocation
        assert float(torch.abs(model.shared_attn["attn"]["wq"].grad).max()) > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_layout_matches_reference(arch, optimizer):
    """make_train_state: the reference's leaves, shapes and dtypes (v3's
    bf16 moments; Adafactor's factored leaves), the int32 step, and the
    compression residuals."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    hp = dataclasses.replace(jtrain.TrainHParams(), optimizer=optimizer, grad_compression=True)
    want = jtrain.abstract_train_state(JModel(jcfg), hp)
    model = Model(cfg, device="cpu")
    got = dict(leaf_paths(stack_tree(train.make_train_state(
        model, train.TrainHParams(**dataclasses.asdict(hp))))))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sorted(got) == sorted("/".join(str(k.key) for k in p) for p, _ in flat)
    for path, w in flat:
        name = "/".join(str(k.key) for k in path)
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype), name
    if arch == "deepseek_v3_671b" and optimizer == "adamw":
        assert got["opt/mu/stages/moe_layers/ffn/wg"].dtype == torch.bfloat16


@pytest.mark.parametrize("chunk", [6, 15])
def test_ce_chunks_and_tail_match_reference(monkeypatch, chunk):
    """The chunked cross-entropy with CE_CHUNK cut in both packages: 15
    predicted positions in chunks of 6 and a tail of 3, and in one chunk;
    the loss and the head's gradient against the reference's."""
    import repro.models.model as jmodel_mod
    from repro_torch.models import model as model_mod
    monkeypatch.setattr(jmodel_mod, "CE_CHUNK", chunk)
    monkeypatch.setattr(model_mod, "CE_CHUNK", chunk)
    jcfg, cfg = jreduced(jget_config("stablelm_3b")), reduced(get_config("stablelm_3b"))
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(0))
    model = params_from_reference(jax.tree.map(np.asarray, params), Model(cfg, device="cpu"))
    jb = jconcrete_batch(jcfg, B, S, train=True, seed=5)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    loss, _ = model.loss({k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    want = np.asarray(jgrads["head"]["out"])
    np.testing.assert_allclose(model.head["out"].grad.numpy(), want, rtol=0,
                               atol=GRAD_REL * float(np.abs(want).max()))
