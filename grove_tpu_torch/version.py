"""Single-source version + build info (reference: `internal/version/`;
grove_tpu/version.py counterpart).

The reference injects version/commit/date at build time via ldflags
(`operator/internal/version/`); a Python package has no link step, so the
analog is: one VERSION constant here (re-exported as
``grove_tpu_torch.__version__``), plus best-effort build metadata gathered at
call time (git commit read from the working tree if present, interpreter
and torch/CUDA versions). Everything that reports a version — ``--version`` flags,
``/statusz``, the CLI — MUST come through this module; tests pin that the
surfaces agree (tests/test_runtime.py).
"""

from __future__ import annotations

import pathlib
import platform as _platform
import sys

VERSION = "0.4.0"


def _git_commit() -> str | None:
    """Resolve HEAD from the on-disk git metadata (no subprocess: this runs
    inside the operator's /statusz handler and must never block or fail)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    git = root / ".git"
    try:
        head = (git / "HEAD").read_text().strip()
        if head.startswith("ref: "):
            ref = head[5:].strip()
            ref_file = git / ref
            if ref_file.exists():
                return ref_file.read_text().strip()[:12]
            packed = git / "packed-refs"
            if packed.exists():
                for line in packed.read_text().splitlines():
                    if line.endswith(" " + ref):
                        return line.split()[0][:12]
            return None
        return head[:12]
    except OSError:
        return None


def build_info() -> dict:
    """Version + build metadata dict (ldflags-injected build info analog):
    the torch and CUDA versions where the JAX package names jax's."""
    try:
        import torch

        torch_version, cuda_version = torch.__version__, torch.version.cuda
    except Exception:  # a torch import must never break a version query
        torch_version = cuda_version = None
    return {
        "version": VERSION,
        "git_commit": _git_commit(),
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "torch": torch_version,
        "cuda": cuda_version,
    }


def version_string(prog: str = "grove-tpu") -> str:
    """`prog VERSION (commit)`, then the torch and CUDA versions it runs on
    (build_info's; "none" for a torch built without CUDA)."""
    info = build_info()
    suffix = f" ({info['git_commit']})" if info["git_commit"] else ""
    return f"{prog} {VERSION}{suffix} torch {info['torch']} CUDA {info['cuda'] or 'none'}"
