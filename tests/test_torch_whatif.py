"""The port's what-if counterfactuals (grove_tpu_torch/trace/whatif.py,
plain PyTorch versions on the CPU) against the JAX package's, on the
committed JAX stream journal (tests/data/jax_stream_journal.json):

  - add_racks: the recorded fleet plus cloned racks, node for node;
  - whatif_journal(add_rack_count=1): every wave re-solved on the edited
    fleet, the report equal to JAX's but for its seconds;
  - whatif_configs with three variants (one sweep pass): equal to JAX's but
    for its seconds, with 0 replay divergences; single overrides fold into
    one variant;
  - a fleet edit combined with variants is rejected.
"""

from __future__ import annotations

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.solver.warm import WarmPath as RWarmPath
from grove_tpu.trace import whatif as r_whatif
from grove_tpu_torch.solver.core import SolverParams as PParams
from grove_tpu_torch.trace import recorder as p_rec
from grove_tpu_torch.trace import whatif as p_whatif
from test_torch_search import STREAM_JOURNAL, strip_seconds, waves_of

VARIANTS = [
    {"weights": {"wTight": 2.0}, "name": "tight2"},
    {"weights": {"wPref": 0.25, "wReserve": 3.0}},
    {"escalatePortfolio": 1, "name": "noesc"},
]


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


@pytest.fixture(scope="module")
def journal():
    return p_rec.read_journal(str(STREAM_JOURNAL))


@pytest.fixture(scope="module")
def jax_warm():
    return RWarmPath()


@pytest.mark.parametrize("count", [0, 1, 2])
def test_add_racks_equals_jax(journal, count):
    fleet = next(r for r in journal if r["kind"] == "fleet")
    want = r_whatif.add_racks(fleet, count)
    got = p_whatif.add_racks(fleet, count)
    fields = [f.name for f in dataclasses.fields(got[0])]  # the port's Node is cut down
    assert [dataclasses.asdict(n) for n in got] == [
        {f: getattr(n, f) for f in fields} for n in want]
    # The template is every node carrying the last node's rack label (rack
    # r3 of both blocks here: 16 nodes a clone).
    assert len(got) == len(fleet["nodes"]) + 16 * count


def test_whatif_add_rack_equals_jax(journal, jax_warm):
    want = r_whatif.whatif_journal(journal, add_rack_count=1, warm_path=jax_warm).to_doc()
    got = p_whatif.whatif_journal(journal, add_rack_count=1, device="cpu").to_doc()
    assert strip_seconds(got) == strip_seconds(want)
    assert got["waves"] == len(waves_of(journal)) and got["replayDivergences"] is None
    assert got["counterfactual"]["admitted"] >= got["recorded"]["admitted"] > 0


def test_whatif_configs_equals_jax(journal, jax_warm):
    want = r_whatif.whatif_configs(journal, VARIANTS, warm_path=jax_warm).to_doc()
    got = p_whatif.whatif_configs(journal, VARIANTS, device="cpu").to_doc()
    assert strip_seconds(got) == strip_seconds(want)
    assert got["replayDivergences"] == 0 and len(got["variants"]) == 3
    assert {v["config"]["name"] for v in got["variants"]} == {"tight2", "variant-1", "noesc"}


def test_single_overrides_fold_into_one_variant(journal):
    params = (1.0, 2.0, 0.5, 1.0, 0.0)
    got = p_whatif.whatif_journal(journal, params=PParams(*params), escalate_portfolio=1,
                                  device="cpu").to_doc()
    spec = {"weights": dict(zip(PParams._fields, params)), "escalatePortfolio": 1}
    want = p_whatif.whatif_configs(journal, [spec], device="cpu").to_doc()
    assert strip_seconds(got) == strip_seconds(want)
    assert [v["config"]["name"] for v in got["variants"]] == ["variant-0"]


def test_fleet_edit_with_variants_is_rejected(journal):
    with pytest.raises(ValueError, match="cannot combine with fleet edits"):
        p_whatif.whatif_journal(journal, add_rack_count=1, variants=VARIANTS, device="cpu")
    with pytest.raises(ValueError, match="unknown keys"):
        p_whatif.whatif_configs(journal, [{"bogus": 1}], device="cpu")
    with pytest.raises(ValueError, match="unknown weight"):
        p_whatif.whatif_configs(journal, [{"weights": {"wNope": 1.0}}], device="cpu")
