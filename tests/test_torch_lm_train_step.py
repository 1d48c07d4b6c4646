"""One train step against the reference's (test_torch_lm_train.py's
check_train_step, at its tolerances) for the moe (MLA, routed and shared
experts), hybrid (the shared block's summed gradient) and deepseek-v3
cases: v3's own recipe (Adafactor, 4 microbatches, the MTP loss) and v3
cut to its dense layers under either optimizer.  In a file of their own so
that each file's reference compiles stay under a minute or so."""

import pytest
import torch

from test_torch_lm_train import HERE, STEP_CASES, check_train_step

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


@pytest.mark.parametrize("arch,cfg_over,hp_over", [c for c in STEP_CASES if c.id not in HERE])
def test_train_step_matches_reference(arch, cfg_over, hp_over):
    check_train_step(arch, cfg_over, hp_over)
