"""Offline tuning over recorded journals (grove_tpu/tuning counterpart):
the batched config sweep. The search on top of it (successive halving,
`recommend`) is a later slice of the port."""

from grove_tpu_torch.tuning.sweep import (  # noqa: F401
    ConfigTally,
    SweepConfig,
    SweepEngine,
    default_grid,
    incumbent_config,
    sweep_journal,
)
