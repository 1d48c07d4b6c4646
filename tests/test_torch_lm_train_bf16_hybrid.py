"""One train step in the configurations' own dtypes (bf16 parameters and
gradients) against repro's, for the hybrid family (the shared block's gradient summed in bf16 over its invocations):
test_torch_lm_train_bf16.py's checks (a) and (b), in a file of their own
so that each file's reference compiles stay under a minute."""

import pytest
from test_torch_lm_train_bf16 import CASES, check_bf16_compute, check_f32_compute

HERE = [c for c in CASES if c.id in ("zamba2_7b",)]


@pytest.mark.parametrize("arch,opt", HERE)
def test_bf16_parameters_f32_compute_match_reference(arch, opt):
    check_f32_compute(arch, opt)


@pytest.mark.parametrize("arch,opt", HERE)
def test_bf16_compute_matches_reference(arch, opt):
    check_bf16_compute(arch, opt)
