"""Solving one wave under several weight variants, and the device mesh the
solve runs over (grove_tpu/parallel counterpart): the (portfolio, node)
mesh of a portfolio solve and the node-sharded layout of the
single-variant solve, both SolveLayouts over mesh_devices() (virtual
devices of the solve's one device: the card, or the CPU in tests)."""

from grove_tpu_torch.parallel.mesh import NODE_AXIS, PORTFOLIO_AXIS, solver_mesh_for
from grove_tpu_torch.parallel.portfolio import (
    params_population,
    portfolio_solve,
    portfolio_solve_batch,
    tune_solve_step,
)

__all__ = [
    "NODE_AXIS",
    "PORTFOLIO_AXIS",
    "solver_mesh_for",
    "params_population",
    "portfolio_solve",
    "portfolio_solve_batch",
    "tune_solve_step",
]
