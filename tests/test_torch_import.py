"""grove_tpu_torch imports neither JAX nor anything of the grove_tpu package,
and nothing in it builds or loads a kernel at import."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
from torch_jax_programs import _release_jax_programs  # noqa: F401

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


SIDECAR_AND_CELLS_MODULES = (
    "grove_tpu_torch.backend", "grove_tpu_torch.backend.service",
    "grove_tpu_torch.backend.client", "grove_tpu_torch.backend.proto.scheduler_backend_pb2",
    "grove_tpu_torch.runtime", "grove_tpu_torch.runtime.config", "grove_tpu_torch.runtime.lease",
    "grove_tpu_torch.api.validation", "grove_tpu_torch.utils.metrics",
    "grove_tpu_torch.utils.platform", "grove_tpu_torch.cells", "grove_tpu_torch.cells.cell",
    "grove_tpu_torch.cells.coordinator", "grove_tpu_torch.cells.partition",
)


def test_sidecar_and_cells_modules_are_checked():
    """The sidecar (service, client, the proto module), the runtime config
    and lease, validation, metrics, the CUDA platform probe and the cells are
    among the modules probed above, and together import neither JAX nor
    grove_tpu."""
    assert set(SIDECAR_AND_CELLS_MODULES) <= set(MODULES)
    assert _imported_forbidden(*SIDECAR_AND_CELLS_MODULES) == []


def test_platform_probe_refuses_cuda_without_a_card():
    import torch

    from grove_tpu_torch.utils.platform import describe_device

    assert not torch.cuda.is_available()
    assert describe_device("cpu").startswith("cpu")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            describe_device(device)


OPERATOR_MODULES = (
    "grove_tpu_torch.runtime.manager", "grove_tpu_torch.runtime.__main__",
    "grove_tpu_torch.runtime.flow", "grove_tpu_torch.runtime.persistence",
    "grove_tpu_torch.runtime.certs", "grove_tpu_torch.api.admission",
    "grove_tpu_torch.api.webhook", "grove_tpu_torch.cluster", "grove_tpu_torch.cluster.kwok",
    "grove_tpu_torch.cluster.watch", "grove_tpu_torch.initc", "grove_tpu_torch.initc.__main__",
    "grove_tpu_torch.utils.errors", "grove_tpu_torch.utils.logging",
    "grove_tpu_torch.utils.concurrent", "grove_tpu_torch.version",
)


def test_operator_modules_are_checked():
    """The Manager and its binary, admission and the webhooks, the KWOK and
    watch sources, persistence, the certs, the initc binary and the helpers
    are among the modules probed above, and together import neither JAX nor
    grove_tpu."""
    assert set(OPERATOR_MODULES) <= set(MODULES)
    assert _imported_forbidden(*OPERATOR_MODULES) == []


@pytest.mark.parametrize("module", ["grove_tpu_torch.runtime.manager",
                                    "grove_tpu_torch.api.webhook",
                                    "grove_tpu_torch.cluster.kwok",
                                    "grove_tpu_torch.cluster.kubernetes",
                                    "grove_tpu_torch.client.typed",
                                    "grove_tpu_torch.cli.main",
                                    "grove_tpu_torch.deploy"])
def test_operator_entry_modules_load_no_jax_alone(module):
    assert _imported_forbidden(module) == []


def test_operator_binary_builds_nothing_at_import():
    """Importing the Manager and its binary neither builds nor loads the
    kernels or the C helpers: the Manager builds them at start()."""
    import grove_tpu_torch.runtime.__main__  # noqa: F401
    import grove_tpu_torch.runtime.manager  # noqa: F401
    from grove_tpu_torch.kernels import build

    assert build._libs == {}


_FIXTURE_PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
before = set(sys.modules)
fx = chip_smoke.fixture_apiserver()
api = fx.FixtureApiServer()
api.close()
loaded = sorted(set(sys.modules) - before)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "grove_tpu"))
print(json.dumps({"bad": bad, "repo": [m for m in loaded if m.startswith("grove")]}))
"""


def test_chip_smoke_loads_the_fixture_apiserver_without_jax():
    """chip_smoke.py phase 19 loads tests/fixture_apiserver.py by path: that
    pulls in neither JAX nor the grove_tpu package (nor any module of the
    port)."""
    out = subprocess.run([sys.executable, "-c", _FIXTURE_PROBE, str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": [], "repo": []}


_SHARD_PROBE = """
import json, sys
from grove_tpu_torch.bench import run_shard_bench, run_shard_worker, shard_worker_problem
from grove_tpu_torch.kernels.place_wave import domain_index_sharded, place_wave_sharded
from grove_tpu_torch.parallel.mesh import force_virtual_devices, layout_from_fingerprint
from grove_tpu_torch.solver.core import sharded_solve, sharded_solve_fn
from grove_tpu_torch.solver.reference import sharded_solve_ref
from grove_tpu_torch.kernels import build
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "grove_tpu"))
print(json.dumps({"bad": bad, "built": sorted(build._libs)}))
"""


def test_mesh_the_b7_wrapper_and_the_shard_bench_import_no_jax():
    """parallel/mesh.py, the B7 wrapper (kernels/place_wave.py
    `place_wave_sharded`), its plain version and the shard bench pull in
    neither JAX nor the grove_tpu package, and build no kernel at import."""
    for module in ("grove_tpu_torch.parallel.mesh", "grove_tpu_torch.kernels.place_wave",
                   "grove_tpu_torch.bench"):
        assert module in MODULES
    out = subprocess.run([sys.executable, "-c", _SHARD_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": [], "built": []}
