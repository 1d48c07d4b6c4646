"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw, make_optimizer,
                                          opt_state_specs)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer", "opt_state_specs",
           "warmup_cosine", "constant"]
