"""Optimizers and learning-rate schedules (port of ``repro.optim``).

``opt_state_specs`` (the optimizer state's sharding axes) comes with the
LM multi-device path (ROADMAP queue 1, item 1.2).
"""

from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, make_optimizer
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer", "warmup_cosine",
           "constant"]
