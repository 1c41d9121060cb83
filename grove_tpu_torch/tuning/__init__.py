"""Offline tuning over recorded journals (grove_tpu/tuning counterpart): the
batched config sweep, successive halving over a grid, and `recommend` with
its bitwise-replay and exact-audit gates."""

from grove_tpu_torch.tuning.search import recommend, successive_halving  # noqa: F401
from grove_tpu_torch.tuning.sweep import (  # noqa: F401
    ConfigTally,
    SweepConfig,
    SweepEngine,
    default_grid,
    incumbent_config,
    sweep_journal,
)
