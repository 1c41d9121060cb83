"""Build and load the hand-written CUDA kernels from the sources in this
package.

Each `csrc/*.cu` file is compiled on first use by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface under
`grove_tpu_torch/_build/` and loaded with ctypes. The library's name carries
a digest of the source and the flags, so an edited source rebuilds.
PyTorch's headers are never included: the build takes seconds, not minutes.

Flags: `-O3 -fmad=false` and no fast math — the solve's exactness against
the JAX package rests on correctly rounded division and on no FMA
contraction (see the note at the top of csrc/place_wave.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall seconds, "ptxas": nvcc's -Xptxas -v report}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_source(name: str) -> Path:
    """Compile csrc/<name>.cu into its shared library (no load); returns the
    path. Safe to call from several threads or processes at once: each
    writes a private temporary file and renames it into place."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_info[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": "\n".join(
            line for line in (proc.stdout + proc.stderr).splitlines()
            if "ptxas" in line or "spill" in line
        ),
    }
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            _libs[name] = lib
        return lib
