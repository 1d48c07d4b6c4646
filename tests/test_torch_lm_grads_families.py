"""The training loss and every leaf's gradient against jax.value_and_grad of
repro's Model.loss (test_torch_lm_grads.py's check, at its tolerances) for
the moe (MLA and the MoE feed-forward, DeepSeek-V3's multi-token-prediction
loss), ssm (the Mamba-2 block) and hybrid (the shared block, whose one set
of weights sums its gradient over its invocations) configurations under
reduced().  In a file of its own so that each file's reference compiles
stay near a minute."""

import pytest
import torch

from test_torch_lm_grads import ELSEWHERE, check_loss_and_grads

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ELSEWHERE)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)
