"""The port's training loss and gradients (repro_torch.models.model.Model.loss)
against jax.value_and_grad of repro's Model.loss, for every architecture
under reduced(), in f32, from the same weights.  This covers the encoder's same-position loss
(shift 0), the VLM's vision splice and M-RoPE positions, DeepSeek-V3's
multi-token-prediction loss (and its bf16 optimizer moments, in the train
state's layout), MLA and the MoE feed-forward, the Mamba-2 block, and the
hybrid's shared block, whose one set of weights sums its gradient over its
invocations.

The weights are the port's seeded init handed to the reference as its
parameter tree (test_torch_lm_model.port_weights); the reference's own init
carried across is held by test_torch_lm_model.py's
test_reference_init_carried_across.  The deep encoder's norms keep the
reference's own init: f32 rounding amplified through 48 layers depends on
the draw, and DEEP_NORM_RTOL was set on that one (from the port's seeded
weights the reference's f32 norm lay 37% from the f64 one, the port's
f64 norm 58% from it)."""

import dataclasses

import jax
import jax.numpy as jnp
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
from test_torch_lm_model import port_weights

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


# the moe, ssm and hybrid configurations' cases run in
# test_torch_lm_grads_families.py (each file's reference compiles stay near
# a minute)
ELSEWHERE = ("deepseek_v2_lite_16b", "deepseek_v3_671b", "mamba2_130m", "zamba2_7b")


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a not in ELSEWHERE])
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


def check_loss_and_grads(arch):
    """The loss, its metrics and every leaf's gradient against
    jax.value_and_grad of the reference's loss; the parameters' way back to
    the reference's tree bit for bit."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jm = JModel(jcfg)
    weights = port_weights(arch)
    params = jax.tree.map(jnp.asarray, weights)
    model = params_from_reference(weights, Model(cfg, device="cpu"))
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


# deepseek-v3 cut to its dense layers (n_layers = first_dense_layers): a
# moe_layers stage of no layer, each leaf of shape (0, *per-layer shape)
DENSE_CUT = "deepseek_v3_671b:dense"


@pytest.mark.parametrize("arch", list(ARCH_NAMES) + [DENSE_CUT])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_layout_matches_reference(arch, optimizer):
    """make_train_state: the reference's leaves, shapes and dtypes (v3's
    bf16 moments; Adafactor's factored leaves), the int32 step, and the
    compression residuals; for a stage of no layers too."""
    arch, _, cut = arch.partition(":")
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    if cut:
        jcfg = jcfg.with_overrides(n_layers=jcfg.first_dense_layers)
        cfg = cfg.with_overrides(n_layers=cfg.first_dense_layers)
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
    if cut:
        assert got["params/stages/moe_layers/ffn/wg"].shape == (
            0, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)


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
    weights = port_weights("stablelm_3b")
    params = jax.tree.map(jnp.asarray, weights)
    model = params_from_reference(weights, Model(cfg, device="cpu"))
    jb = jconcrete_batch(jcfg, B, S, train=True, seed=5)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    loss, _ = model.loss({k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    want = np.asarray(jgrads["head"]["out"])
    np.testing.assert_allclose(model.head["out"].grad.numpy(), want, rtol=0,
                               atol=GRAD_REL * float(np.abs(want).max()))


# hubert-xlarge at its full depth, reduced width: the seeded model's
# gradient norm grows with depth (the fan-in init has no depth scaling; at
# full width and 48 layers the norm passes the f32 sum of squares' range).
# The port's norm in f64 (parameters, compute, every f32 upcast) against the
# reference's in f32: at 2 layers within GNORM_RTOL; at 48, where f32
# rounding amplified through the layers moves the reference's norm by ~11%
# from the f64 one (the port's f32 by ~23%; measured on an 8-core x86
# host), within DEEP_NORM_RTOL, against a growth of ~10^5 from 2 layers
DEEP_ENC_LAYERS, GNORM_RTOL, DEEP_NORM_RTOL = 48, 1e-3, 0.5


def test_deep_encoder_gradient_norm_matches_reference(monkeypatch):
    """hubert-xlarge at 2 and 48 layers: the port's f64 gradient norm
    grows with depth as the reference's does."""
    plain = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t, *a, **k: t if t.dtype == torch.float64 else plain(t, *a, **k))
    norms = {}
    for layers in (2, DEEP_ENC_LAYERS):
        jcfg = jreduced(jget_config("hubert_xlarge")).with_overrides(n_layers=layers)
        cfg = reduced(get_config("hubert_xlarge")).with_overrides(
            n_layers=layers, param_dtype="float64", compute_dtype="float64")
        jm = JModel(jcfg)
        params = jm.init(jax.random.key(0))
        model = params_from_reference(jax.tree.map(np.asarray, params), Model(cfg, device="cpu"))
        jb = jconcrete_batch(jcfg, B, S, train=True, seed=1)
        _, jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        tb["frames"] = tb["frames"].double()
        loss, _ = model.loss(tb)
        loss.backward()
        got = float(torch.sqrt(sum(torch.sum(torch.square(g)) for _, g in
                                   leaf_paths(_grads(model)))))
        want = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                                 for g in jax.tree.leaves(jgrads))))
        norms[layers] = got, want
    (got2, want2), (got, want) = norms[2], norms[DEEP_ENC_LAYERS]
    np.testing.assert_allclose(got2, want2, rtol=GNORM_RTOL)
    np.testing.assert_allclose(got, want, rtol=DEEP_NORM_RTOL)
    assert got / got2 > 1e4 and want / want2 > 1e4, norms
