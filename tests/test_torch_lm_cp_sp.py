"""Context parallelism and Megatron-SP residual saves on the (2, 2) mesh
against the reference's own mesh runs: reduced deepseek-v3 with its own
``sp_activations`` and 3 heads (MLA's expanded attention in the q-sequence
case beside the expert-parallel island and SP, the MTP block's S - 1 rows
padded to a multiple of ``model``) and reduced stablelm with
``sp_activations=True``, both with remat "full".  test_torch_lm_cp.py's
checks (its docstring says what each holds) on their own four gloo ranks
and two reference processes, so that each file's fixture stays near a
minute; and the SP carry that remat saves, 1/m of the whole."""

import pytest
import torch

from test_torch_lm_cp import B, HP, S, _cfg, start_runs
from test_torch_lm_cp import test_collectives_equal_the_derivation as _collectives
from test_torch_lm_cp import test_gradients_match_reference_per_leaf as _gradients
from test_torch_lm_cp import test_server_matches_reference_mesh_run as _server
from test_torch_lm_cp import test_the_carry_and_score_constraints_are_checked as _constraints
from test_torch_lm_cp import test_training_matches_reference_mesh_run as _training

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

HERE = ("dsv3", "stablelm")
REF_GROUPS = (("dsv3",), ("stablelm",))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_cp_sp")
    port, refout = start_runs(root, HERE, REF_GROUPS)
    return port, refout, root


@pytest.mark.parametrize("name", sorted(HERE))
def test_server_matches_reference_mesh_run(runs, name):
    _server(runs, name)


@pytest.mark.parametrize("name", sorted(HERE))
def test_gradients_match_reference_per_leaf(runs, name):
    _gradients(runs, name)


@pytest.mark.parametrize("name", sorted(HERE))
def test_training_matches_reference_mesh_run(runs, name):
    _training(runs, name)


@pytest.mark.parametrize("name", sorted(HERE))
def test_collectives_equal_the_derivation(runs, name):
    _collectives(runs, name)


@pytest.mark.parametrize("name", ["dsv3", "stablelm"])
def test_sp_saves_one_mth_of_the_carry(runs, name):
    """Each entry's remat saves this rank's sequence block of the carry:
    its rows (a microbatch of B/2 over data = 2) x S/2 positions x d."""
    port, _, _ = runs
    cfg = _cfg(name)
    rows = B // HP["grad_accum"] // 2
    for p in port:
        saved = p[name]["saved"]
        assert len(saved) == p[name]["n_entries"] * HP["grad_accum"]
        assert set(saved) == {rows * (S // 2) * cfg.d_model * 4}, saved


@pytest.mark.parametrize("name", sorted(HERE))
def test_the_carry_and_score_constraints_are_checked(runs, name):
    _constraints(runs, name)
