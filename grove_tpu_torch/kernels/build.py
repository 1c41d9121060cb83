"""Build and load the hand-written CUDA kernels from the sources in this
package.

Each `csrc/*.cu` file is compiled on first use by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface under
`grove_tpu_torch/_build/` and loaded with ctypes. The library's name carries
a digest of the source and the flags, so an edited source rebuilds.
PyTorch's headers are never included: the build takes seconds, not minutes.
The same build makes the port's one C extension for the host
(utils/csrc/serde_render.c, `load_extension`) with the C compiler.

Flags: `-O3 -fmad=false` and no fast math — the solve's exactness against
the JAX package rests on correctly rounded division and on no FMA
contraction (see the note at the top of csrc/place_wave.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
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
_extensions: dict[str, object] = {}  # load_extension's modules
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


def _artifact(src: Path, stem: str, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def _compile(src: Path, out: Path, argv: list[str]):
    """Run `argv` + ["-o", tmp, src] and rename tmp to `out`: the compiler's
    CompletedProcess, or None when `out` is there already. Safe to call from
    several threads or processes at once: each writes a private temporary
    file and renames it into place."""
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*argv, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(argv[0])} failed for {src.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc


def library_path(name: str) -> Path:
    return _artifact(CSRC / f"{name}.cu", f"lib{name}", NVCC_FLAGS)


def compile_source(name: str) -> Path:
    """Compile csrc/<name>.cu into its shared library (no load); returns the
    path."""
    out = library_path(name)
    if out.exists():
        return out
    t0 = time.perf_counter()
    proc = _compile(CSRC / f"{name}.cu", out, [nvcc_path(), *NVCC_FLAGS])
    if proc is None:
        return out
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


def load_extension(name: str, src: Path):
    """The Python extension module `name` built from the C source `src` with
    the C compiler ($CC, else cc) against this interpreter's headers, at
    first use; a failed build raises."""
    with _lock:
        mod = _extensions.get(name)
        if mod is None:
            flags = ("-O2", "-shared", "-fPIC", "-I" + sysconfig.get_paths()["include"])
            # The interpreter's ABI in the digest: another Python builds anew.
            out = _artifact(src, name, (*flags, sysconfig.get_config_var("EXT_SUFFIX") or ""))
            cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
            _compile(src, out, [cc, *flags])
            loader = importlib.machinery.ExtensionFileLoader(name, str(out))
            spec = importlib.util.spec_from_file_location(name, str(out), loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _extensions[name] = mod
        return mod
