"""The port's PodCliqueSet validation (grove_tpu_torch/api/validation.py,
which the sidecar's ValidatePodCliqueSet calls) against the JAX package's:
equal error lists on every examples/*.yaml PodCliqueSet and on invalid
probes (a cyclic startsAfter under Explicit startup, a name over 45
characters, minAvailable above replicas, a malformed quantity, an empty
document, bad topology constraints), under the default topology and the
bench topology, and equal `validate_update` lists."""

from __future__ import annotations

import copy
import pathlib

import pytest
import yaml

from grove_tpu import api as r_api
from grove_tpu_torch import api as p_api
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PCS_EXAMPLES = sorted(p for p in (REPO / "examples").glob("*.yaml")
                      if not p.name.startswith("operator-config"))


def errors(api, doc, topology=None):
    """(error strings, or the exception the parse raised) of one document."""
    try:
        pcs = api.default_podcliqueset(api.PodCliqueSet.from_dict(copy.deepcopy(doc)))
    except Exception as e:  # noqa: BLE001 — a parse failure is an outcome to compare
        return ("raised", type(e).__name__, str(e))
    topo = topology(api) if topology else api.DEFAULT_CLUSTER_TOPOLOGY
    return [str(e) for e in api.validate_podcliqueset(pcs, topo)]


def both(doc, topology=None):
    r = errors(r_api, doc, topology)
    p = errors(p_api, doc, topology)
    assert p == r
    return p


def _with_host(api):
    return api.DEFAULT_CLUSTER_TOPOLOGY.with_host_level()


@pytest.mark.parametrize("path", PCS_EXAMPLES, ids=lambda p: p.name)
@pytest.mark.parametrize("topology", [None, _with_host], ids=["default", "with_host"])
def test_examples_validate_equal(path, topology):
    assert both(yaml.safe_load(path.read_text()), topology) == []


def _simple():
    return yaml.safe_load((REPO / "examples" / "simple1.yaml").read_text())


def _cliques(doc):
    return doc["spec"]["template"]["cliques"]


def probe_cyclic_starts_after(doc):
    doc["spec"]["template"]["cliqueStartupType"] = "CliqueStartupTypeExplicit"
    cl = _cliques(doc)
    if len(cl) >= 2:
        cl[0]["spec"]["startsAfter"] = [cl[1]["name"]]
        cl[1]["spec"]["startsAfter"] = [cl[0]["name"]]
    else:
        cl[0]["spec"]["startsAfter"] = [cl[0]["name"]]
    return doc


def probe_long_name(doc):
    doc["metadata"]["name"] = "x" * 46
    return doc


def probe_min_available(doc):
    c = _cliques(doc)[0]["spec"]
    c["minAvailable"] = int(c.get("replicas", 1)) + 5
    return doc


def probe_bad_quantity(doc):
    spec = _cliques(doc)[0]["spec"]["podSpec"]
    spec["containers"][0].setdefault("resources", {})["requests"] = {"cpu": "ten"}
    return doc


def probe_empty(doc):
    return {}


def probe_duplicate_cliques(doc):
    _cliques(doc).append(copy.deepcopy(_cliques(doc)[0]))
    return doc


def probe_bad_topology(doc):
    doc["spec"]["template"]["topologyConstraint"] = {"packDomain": "galaxy"}
    return doc


def probe_negative_replicas(doc):
    _cliques(doc)[0]["spec"]["replicas"] = -1
    return doc


PROBES = [probe_cyclic_starts_after, probe_long_name, probe_min_available, probe_bad_quantity,
          probe_empty, probe_duplicate_cliques, probe_bad_topology, probe_negative_replicas]


@pytest.mark.parametrize("probe", PROBES, ids=lambda f: f.__name__)
def test_invalid_probes_give_equal_errors(probe):
    out = both(probe(_simple()))
    assert out, probe.__name__


def test_update_validation_equals_jax():
    old = _simple()
    new = copy.deepcopy(old)
    _cliques(new)[0]["spec"]["roleName"] = "renamed"
    new["spec"]["replicas"] = 3
    r = [str(e) for e in r_api.validate_update(
        r_api.default_podcliqueset(r_api.PodCliqueSet.from_dict(copy.deepcopy(old))),
        r_api.default_podcliqueset(r_api.PodCliqueSet.from_dict(copy.deepcopy(new))))]
    p = [str(e) for e in p_api.validate_update(
        p_api.default_podcliqueset(p_api.PodCliqueSet.from_dict(copy.deepcopy(old))),
        p_api.default_podcliqueset(p_api.PodCliqueSet.from_dict(copy.deepcopy(new))))]
    assert p == r
