"""The port's exact reference packer and audit (grove_tpu_torch/quality/
exact.py and audit.py) against the JAX package's on the CPU:

  - exact_pack on every seeded audit instance: the same optimum (admitted
    gangs and count, per-gang scores, mean score, the floor pods' nodes),
    the same states explored and complete placements evaluated;
  - the same budget overrun raises at the same `max_states`, and the same
    oversized or dependent instances are refused;
  - audit_config's document (the port's solve() on its plain versions)
    equals JAX's at the incumbent weights and at a perturbed grid row, at
    portfolio 1 and 4.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.quality import audit as r_audit
from grove_tpu.quality import exact as r_exact
from grove_tpu_torch.quality import audit as p_audit
from grove_tpu_torch.quality import exact as p_exact
from grove_tpu_torch.solver.core import SolverParams
from grove_tpu_torch.solver.warm import WarmPath
from grove_tpu_torch.tuning.sweep import SweepConfig, default_grid
from torch_jax_programs import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _no_shared_xla_cache():
    """This module's JAX compiles stay out of the suite's persistent XLA
    cache (tests/conftest.py): a worker reading an entry another worker is
    writing in place can crash."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    cc.reset_cache()


def outcome(res):
    return (res.admitted, res.admitted_count, res.scores, res.mean_score, res.assignments,
            res.states_explored, res.solutions)


@pytest.mark.parametrize("seed", p_audit.AUDIT_SEEDS)
def test_exact_pack_equals_jax(seed):
    r_inst = r_audit.audit_instance(seed)
    p_inst = p_audit.audit_instance(seed)
    assert [g.name for g in p_inst[0]] == [g.name for g in r_inst[0]]
    assert list(p_inst[1]) == list(r_inst[1])
    want = r_exact.exact_pack(*r_inst)
    got = p_exact.exact_pack(*p_inst)
    assert outcome(got) == outcome(want)
    assert got.admitted_count >= 3


@pytest.mark.parametrize("max_states", [50, 500, 2175, 2176, 4484, 4485])
def test_budget_overrun_raises_at_the_same_state(max_states):
    for seed in (23, 73):  # 2176 and 4485 states explored
        r_inst, p_inst = r_audit.audit_instance(seed), p_audit.audit_instance(seed)
        try:
            want = outcome(r_exact.exact_pack(*r_inst, max_states=max_states))
        except r_exact.ExactBudgetExceeded as e:
            with pytest.raises(p_exact.ExactBudgetExceeded, match=str(e)):
                p_exact.exact_pack(*p_inst, max_states=max_states)
        else:
            assert outcome(p_exact.exact_pack(*p_inst, max_states=max_states)) == want


def test_oversized_and_dependent_instances_are_refused():
    gangs, pods, snap = p_audit.audit_instance(11)
    with pytest.raises(ValueError, match="gangs >"):
        p_exact.exact_pack(gangs * 5, pods, snap)
    big = p_audit.build_snapshot(p_audit.audit_nodes(11, 3, 4.0),
                                 p_audit.audit_instance(11)[2].topology)
    with pytest.raises(ValueError, match="nodes >"):
        p_exact.exact_pack(gangs, pods, big)
    scaled = gangs[0]
    scaled.base_podgang_name = gangs[1].name
    with pytest.raises(ValueError, match="dependency chains"):
        p_exact.exact_pack(gangs, pods, snap)


INCUMBENT = tuple(float(w) for w in SolverParams())
PERTURBED = default_grid(SweepConfig("incumbent", INCUMBENT), 4)[1].weights


@pytest.mark.parametrize("portfolio", [1, 4])
@pytest.mark.parametrize("weights", [INCUMBENT, PERTURBED], ids=["incumbent", "perturbed"])
def test_audit_config_equals_jax(weights, portfolio):
    want = r_audit.audit_config(weights, portfolio=portfolio).to_doc()
    got = p_audit.audit_config(weights, portfolio=portfolio, warm_path=WarmPath(),
                               device="cpu").to_doc()
    assert got == want
    assert got["instances"] == len(p_audit.AUDIT_SEEDS) and got["exactAdmitted"] > 0
