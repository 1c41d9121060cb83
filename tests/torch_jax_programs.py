"""A module fixture for the port's test modules that run the JAX package:
JAX's compiled programs are released when each module starts and ends.

Every XLA program compiled on the CPU keeps a few memory mappings for its
code while it is cached, and a pytest worker process caches every program it
has compiled (JAX's jit caches and the JAX package's process-shared
WarmPath). A worker that runs a few hundred JAX-heavy tests passes the
kernel's per-process limit on mappings (vm.max_map_count, 65530 by default);
the next compile or persistent-cache load then cannot map its code and the
worker dies in native code, so xdist reports the test it was running as
failed. Releasing the programs at module boundaries keeps a worker's
mappings to what one module compiles.

Import the fixture into a test module to use it:

    from torch_jax_programs import _release_jax_programs  # noqa: F401
"""

from __future__ import annotations

import gc

import jax
import pytest


def memory_mappings() -> int:
    """The number of memory mappings this process holds (Linux)."""
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def release_jax_programs() -> None:
    """Drop every compiled JAX program this process caches: the jit caches
    and the JAX package's process-shared WarmPath (its executable cache);
    then collect, so their code mappings are unmapped."""
    import grove_tpu.solver.warm as r_warm

    with r_warm._DEFAULT_LOCK:
        r_warm._DEFAULT_WARM_PATH = None
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    release_jax_programs()
    yield
    release_jax_programs()
