"""grove_tpu_torch imports neither JAX nor anything of the grove_tpu package,
and nothing in it builds or loads a kernel at import."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "grove_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "grove_tpu" or m.startswith("grove_tpu."))
print(json.dumps(bad))
"""


def _imported_forbidden(*modules):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, *modules],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_package_imports_no_jax_and_no_grove_tpu():
    assert _imported_forbidden("grove_tpu_torch") == []


@pytest.mark.parametrize("module", MODULES)
def test_every_module_imports_no_jax_and_no_grove_tpu(module):
    assert _imported_forbidden(module) == []


def test_no_module_is_built_at_import():
    from grove_tpu_torch.kernels import build

    assert build._libs == {}
    assert not hasattr(build, "lib")


def test_bench_refuses_to_run_without_a_card():
    env_probe = (
        "import torch; assert not torch.cuda.is_available();"
        "from grove_tpu_torch.bench import run_bench\n"
        "try:\n    run_bench(0.02)\nexcept RuntimeError as e:\n    print('raised', e)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", env_probe], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert "raised no CUDA device" in out.stdout, out.stdout + out.stderr


def test_warm_path_module_is_checked():
    """The warm path (solver/warm.py) is among the modules probed above."""
    assert "grove_tpu_torch.solver.warm" in MODULES
    assert _imported_forbidden("grove_tpu_torch.solver.warm") == []


def test_streaming_and_tuning_modules_are_checked():
    """The streaming drain, the exact audit, the search and what-if are among
    the modules probed above."""
    new = ("grove_tpu_torch.solver.stream", "grove_tpu_torch.quality.exact",
           "grove_tpu_torch.quality.audit", "grove_tpu_torch.tuning.search",
           "grove_tpu_torch.trace.whatif")
    assert set(new) <= set(MODULES)
    assert _imported_forbidden(*new) == []


@pytest.mark.parametrize("entry", ["drain_stream", "recommend", "audit_config", "whatif_journal"])
def test_streaming_and_tuning_entry_points_need_the_card_unless_asked(entry):
    """Without a card each entry point raises unless the caller asks for the
    CPU: no quiet fallback."""
    import torch

    from grove_tpu_torch.quality.audit import audit_config
    from grove_tpu_torch.solver.core import SolverParams
    from grove_tpu_torch.solver.stream import drain_stream
    from grove_tpu_torch.state import build_snapshot
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_cluster
    from grove_tpu_torch.trace.recorder import read_journal
    from grove_tpu_torch.trace.whatif import whatif_journal
    from grove_tpu_torch.tuning import recommend

    assert not torch.cuda.is_available()
    journal = str(REPO / "tests" / "data" / "jax_stream_journal.json")
    calls = {
        "drain_stream": lambda: drain_stream(
            [], {}, build_snapshot(synthetic_cluster(1, 1, 1, 2), bench_topology())),
        "recommend": lambda: recommend(read_journal(journal), k=2, rungs=1),
        "audit_config": lambda: audit_config(tuple(SolverParams()), seeds=(11,)),
        "whatif_journal": lambda: whatif_journal(read_journal(journal), add_rack_count=1),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


SERVING_MODULES = (
    "grove_tpu_torch.api.constants", "grove_tpu_torch.api.resources",
    "grove_tpu_torch.orchestrator.controller", "grove_tpu_torch.orchestrator.store",
    "grove_tpu_torch.orchestrator.startup", "grove_tpu_torch.orchestrator.status",
    "grove_tpu_torch.orchestrator.queues", "grove_tpu_torch.orchestrator.rollout",
    "grove_tpu_torch.tenancy", "grove_tpu_torch.tenancy.slo", "grove_tpu_torch.tenancy.aging",
    "grove_tpu_torch.tenancy.ledger", "grove_tpu_torch.solver.escalation",
    "grove_tpu_torch.utils.backoff", "grove_tpu_torch.initc.agent",
    "grove_tpu_torch.sim.simulator",
)


def test_serving_path_modules_are_checked():
    """The controller, the simulator and the host model they need are among
    the modules probed above, and together import neither JAX nor
    grove_tpu."""
    assert set(SERVING_MODULES) <= set(MODULES)
    assert _imported_forbidden(*SERVING_MODULES) == []


def test_controller_needs_the_card_unless_asked():
    env_probe = (
        "import torch; assert not torch.cuda.is_available()\n"
        "from grove_tpu_torch.orchestrator.controller import GroveController\n"
        "from grove_tpu_torch.orchestrator.store import Cluster\n"
        "from grove_tpu_torch.sim.workloads import bench_topology\n"
        "try:\n    GroveController(cluster=Cluster(), topology=bench_topology())\n"
        "except RuntimeError as e:\n    print('raised', e)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", env_probe], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert "raised no CUDA device" in out.stdout, out.stdout + out.stderr
