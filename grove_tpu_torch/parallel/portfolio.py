"""Portfolio gang placement: one wave solved under P weight variants at once,
the best outcome kept (grove_tpu/parallel/portfolio.py counterpart).

The sequential-commit solver is a greedy heuristic whose quality depends on
its score weights (SolverParams). A portfolio solves the wave under P weight
vectors — the base plus log-normal perturbations, odd slots worst-fit — and
keeps the winner: most gangs admitted, then the highest placement quality,
then the lowest slot. On the card the P solves are one stacked launch of the
place_wave kernel, P chain blocks side by side, and the winner is picked on
the card (kernels/place_wave.py `place_wave_stacked`); on the CPU the plain
versions run (solver/reference.py `stacked_solve_ref`,
`portfolio_select_ref`).

Under a (portfolio, node) mesh (parallel/mesh.py `solver_mesh_for`: a
SolveLayout of pa x k virtual devices) the node axis splits into k shards:
the P rows are then one B5 x B7 launch, P * k chain blocks, row p's shards
exchanging domain partials and stage-2 candidates (kernels/place_wave.py
`place_wave_stacked_sharded`; on the CPU `sharded_stacked_solve_ref`), and
the plain B5 when k = 1. On virtual devices the portfolio axis decides
nothing but the blocks' numbering. The callers (solver/core.py `solve`,
the portfolio drain) negotiate the mesh once and pass it to
`portfolio_solve`.

`tune_solve_step` goes one further: solve the portfolio, select the winner,
and emit the next generation of weights (elite + fixed log-normal
mutations).

A weight stack is f32 [P, 5], SolverParams' fields in order, made in numpy
(the same bytes as the JAX package's stack) and uploaded where it is used.
"""

from __future__ import annotations

import numpy as np
import torch

from grove_tpu_torch.solver.core import (
    SolveResult,
    SolverParams,
    resolve_device,
    stack_on,
    stacked_dispatch,
    to_device,
)
from grove_tpu_torch.solver.encode import GangBatch
from grove_tpu_torch.solver.reference import objective_ref

_N_WEIGHTS = len(SolverParams._fields)

# The population is deterministic in (p, base, spread, seed): the escalation
# path would otherwise redraw the same stack on every escalated solve.
_POPULATION_CACHE: dict[tuple, np.ndarray] = {}


def params_population(p: int, base: SolverParams = SolverParams(), spread: float = 0.6,
                      seed: int = 0) -> np.ndarray:
    """Stack P weight vectors (f32 [P, 5], read-only): the base plus
    log-normal perturbations, with packing-polarity diversity — odd slots
    flip w_tight's sign (worst-fit). Slot 0 is the exact base, so a
    portfolio never admits fewer gangs than the base solver. The rng draw
    is row-major, so population(p) extends population(q < p)."""
    key = (p, tuple(float(x) for x in base), spread, seed)
    cached = _POPULATION_CACHE.get(key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(seed)
    factors = np.exp(rng.normal(0.0, spread, size=(p, _N_WEIGHTS))).astype(np.float32)
    factors[0, :] = 1.0  # slot 0 is always the unperturbed base
    base_vec = np.asarray([float(x) for x in base], dtype=np.float32)
    stack = factors * base_vec[None, :]
    tight_i = SolverParams._fields.index("w_tight")
    stack[1::2, tight_i] *= -1.0  # odd slots: worst-fit members
    stack.setflags(write=False)
    if len(_POPULATION_CACHE) > 64:
        _POPULATION_CACHE.clear()  # tiny key space in practice; bound anyway
    _POPULATION_CACHE[key] = stack
    return stack


def _mutation_factors(p: int, spread: float = 0.35, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    factors = np.exp(rng.normal(0.0, spread, size=(p, _N_WEIGHTS))).astype(np.float32)
    factors[0, :] = 1.0  # elitism: slot 0 carries the winner unchanged
    return factors


# (gangs admitted, total placement quality) of one solve, compared
# lexicographically; the quality adds in the JAX package's order.
_objective = objective_ref


def portfolio_solve_batch(free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                          params_stack, ok_global=None, *, device=None, domains=None,
                          mesh=None):
    """Solve the same batch under every weight row; return the winner.

    Returns (best SolveResult, winner i32 [], objectives f32 [P]). The
    winner is the lexicographic best (admitted count, quality), first slot
    on ties — two comparisons, not one packed float; `objectives` =
    admitted * 1e6 + quality is for display. Every member judges its
    cross-wave dependencies against the one `ok_global`; only the winner's
    verdicts enter it.

    Arrays may be numpy arrays or tensors; they are moved to `device` (None =
    the card). On the card the solve is one stacked launch with the select
    on the card, and `free0` and `ok_global` are updated in place by the
    winner (pass copies to keep them); `domains` is the snapshot's
    DomainIndex (built here when not given). `mesh` (a (pa, k) SolveLayout,
    or None) with k > 1 splits the node axis into k shards (B5 x B7;
    `domains` is then the sharded DomainIndex)."""
    *best, winner, objectives = stacked_dispatch(
        free0, capacity, schedulable, node_domain_id, batch, params_stack, ok_global,
        select=True, device=device, domains=domains, layout=mesh,
    )
    return SolveResult(*best), winner, objectives


def tune_solve_step(free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                    params_stack, spread_seed: int = 7, *, device=None, domains=None):
    """One evolutionary step: solve the portfolio, pick the winner, emit
    the next generation — the winner's weights times fixed log-normal
    mutation factors (slot 0 = the elite copy).

    Returns (best SolveResult, next stack f32 [P, 5], objectives [P])."""
    dev = resolve_device(device)
    pstack = stack_on(params_stack, dev)
    best, winner, objectives = portfolio_solve_batch(
        free0, capacity, schedulable, node_domain_id, batch, pstack, device=dev, domains=domains,
    )
    factors = to_device(_mutation_factors(pstack.shape[0], seed=spread_seed), dev)
    next_stack = factors * pstack[winner.long()][None, :]
    return best, next_stack, objectives


def portfolio_solve(free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                    base_params: SolverParams, portfolio: int, ok_global=None, *,
                    pstack=None, device=None, domains=None, mesh=None) -> SolveResult:
    """One-stop portfolio solve: the population of `portfolio` variants
    around `base_params` (or the caller's `pstack`, hoisted once by a wave
    loop), the mesh, then the winner. The one entry the serving solve and
    the drain share, so seeding, layout and selection cannot diverge
    between them.

    `mesh` is the layout solver_mesh_for negotiated for (P, N), or None to
    stay unsharded. `domains` is the DomainIndex for the mesh's node axis
    (sharded when it is over 1; built here when not given)."""
    if pstack is None:
        pstack = params_population(portfolio, base=base_params)
    best, _winner, _objectives = portfolio_solve_batch(
        free0, capacity, schedulable, node_domain_id, batch, pstack, ok_global,
        device=device, domains=domains, mesh=mesh,
    )
    return best
