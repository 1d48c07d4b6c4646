"""Adapted sums through the port's fused plain version against repro's
fused kernel in interpret mode, Sobol (test_torch_adaptive.py's check, in a
file of its own: the interpret-mode run takes ~45 s under the suite's
load)."""

import pytest
import torch

from test_torch_adaptive import check_adapted_sums_vs_reference_fused_interpret

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


@pytest.mark.parametrize("sampler", ["sobol"])
def test_adapted_sums_vs_reference_fused_interpret(sampler):
    check_adapted_sums_vs_reference_fused_interpret(sampler)
