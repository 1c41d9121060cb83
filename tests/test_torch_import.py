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
