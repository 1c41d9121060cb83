"""The port's OperatorConfiguration (grove_tpu_torch/runtime/config.py)
against the JAX package's: `parse_operator_config` and
`validate_operator_config` give equal values and equal error lists on the
committed examples/operator-config*.yaml and on mutated invalid documents,
and a SolverConfig's `solver_params()`, `pruning_config()` and the other
section methods the sidecar and the cells read give equal values."""

from __future__ import annotations

import copy
import dataclasses
import pathlib

import pytest
import yaml

from grove_tpu.runtime import config as r_config
from grove_tpu_torch.runtime import config as p_config
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("operator-config*.yaml"))


def plain(x):
    """A config (or any value it holds) as plain data, class names aside."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "value") and type(x).__module__.endswith("types"):  # an Enum
        return x.value
    return x


def parse_both(doc):
    r_cfg, r_err = r_config.parse_operator_config(copy.deepcopy(doc))
    p_cfg, p_err = p_config.parse_operator_config(copy.deepcopy(doc))
    assert p_err == r_err
    assert plain(p_cfg) == plain(r_cfg)
    return p_cfg, p_err


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_parse_and_validate_equal(path):
    doc = yaml.safe_load(path.read_text())
    cfg, errors = parse_both(doc)
    assert errors == []
    assert p_config.validate_operator_config(cfg) == r_config.validate_operator_config(
        r_config.parse_operator_config(copy.deepcopy(doc))[0]) == []
    loaded = p_config.load_operator_config(str(path))
    assert plain(loaded) == plain(r_config.load_operator_config(str(path)))


def _set(doc, dotted, value):
    *head, last = dotted.split(".")
    cur = doc
    for k in head:
        cur = cur.setdefault(k, {})
    cur[last] = value


MUTATIONS = [
    ("log.level", "loud"),
    ("log.format", "xml"),
    ("nosuchsection", {"a": 1}),
    ("solver.noSuchKnob", 3),
    ("solver.portfolio", 0),
    ("solver.portfolioEscalation", -2),
    ("solver.weights", {"wPref": "heavy"}),
    ("solver.weights", {"wUnknown": 1.0}),
    ("solver.pruning", {"enabled": True, "maxCandidates": 0}),
    ("solver.pruning", {"enabled": True, "padLadder": [8, 4]}),
    ("controllers.concurrentSyncs", 0),
    ("cells.count", 0),
    ("cells.shardBy", "hash"),
    ("cells", {"enabled": True, "count": 2, "leaseDurationSeconds": 5,
               "renewDeadlineSeconds": 10}),
    ("faults", {"enabled": True, "sites": {"no.such.site": {"kind": "error"}}}),
    ("faults", {"enabled": True, "sites": {"cell.crash": {"kind": "explode"}}}),
    ("topologyAwareScheduling.levels", [{"domain": "galaxy", "nodeLabelKey": "x"}]),
    ("servers.healthPort", -5),
    ("tenancy", {"enabled": True, "agingMaxBoost": -1}),
    ("resilience", {"enabled": True, "failureThreshold": 0}),
    ("trace", {"enabled": True, "maxFiles": 0}),
]


@pytest.mark.parametrize("key,value", MUTATIONS, ids=[f"{k}={v!r}"[:60] for k, v in MUTATIONS])
def test_invalid_documents_give_equal_errors(key, value):
    doc = yaml.safe_load((REPO / "examples" / "operator-config.yaml").read_text())
    _set(doc, key, value)
    _, errors = parse_both(doc)
    assert errors, (key, value)


@pytest.mark.parametrize("section", [
    {},
    {"weights": {"wPref": 2.0, "wTight": 0.5, "wReuse": 1.0, "wReserve": 4.0, "wSpread": 3.0}},
    {"pruning": {"enabled": True, "maxCandidates": 512, "minPad": 16, "minFleet": 64}},
    {"pruning": {"enabled": True, "padLadder": [64, 256, 1024]}},
    {"pruning": {"enabled": False, "maxCandidates": 8}},
    {"portfolio": 4, "portfolioEscalation": 8, "padGangsTo": 16, "maxGroups": 4,
     "maxSets": 6, "maxPods": 32},
])
def test_solver_section_methods_equal_jax(section):
    doc = {"solver": section}
    r_cfg, r_err = r_config.parse_operator_config(copy.deepcopy(doc))
    p_cfg, p_err = p_config.parse_operator_config(copy.deepcopy(doc))
    assert p_err == r_err == []
    rs, ps = r_cfg.solver, p_cfg.solver
    assert tuple(float(x) for x in ps.solver_params()) == \
        tuple(float(x) for x in rs.solver_params())
    r_pr, p_pr = rs.pruning_config(), ps.pruning_config()
    assert (p_pr is None) == (r_pr is None)
    if p_pr is not None:
        assert plain(p_pr) == plain(r_pr)
    for attr in ("portfolio", "portfolio_escalation", "max_groups", "max_sets", "max_pods",
                 "pad_gangs_to"):
        assert getattr(ps, attr) == getattr(rs, attr)


def test_cells_section_equals_jax():
    doc = {"cells": {"enabled": True, "count": 4, "shardBy": "topology",
                     "topologyLevel": "zone", "crashCheckEvery": 12}}
    cfg, errors = parse_both(doc)
    assert errors == [] and cfg.cells.count == 4 and cfg.cells.crash_check_every == 12
