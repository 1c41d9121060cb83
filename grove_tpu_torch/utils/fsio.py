"""Atomic file writes (grove_tpu/utils/fsio.py counterpart)."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def atomic_write_json(path: str, doc: Any) -> None:
    """Write JSON to `path` via temp-file + rename (atomic on POSIX).

    Readers never observe a torn file; on any failure the target is left
    untouched and the temp file removed.
    """
    # One encode, one write: json.dump writes piece by piece, which costs
    # seconds on a journal segment of megabytes.
    atomic_write_chunks(path, [json.dumps(doc).encode()])


def atomic_write_chunks(path: str, chunks) -> None:
    """Write the concatenation of the byte strings `chunks` to `path` via
    temp-file + rename (atomic on POSIX; on any failure the target is left
    untouched and the temp file removed). The chunks go to the file as they
    are, a batch per `os.writev` call (one system call, not one per chunk),
    so a writer that keeps a file's bytes rewrites it without joining or
    encoding them again."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".atomic-")
    try:
        try:
            pending = [memoryview(c) for c in chunks if len(c)]
            i = 0
            while i < len(pending):
                written = os.writev(fd, pending[i:i + _IOV_MAX])
                # Step past what was written; a chunk written in part keeps
                # its tail.
                while written:
                    if written >= len(pending[i]):
                        written -= len(pending[i])
                        i += 1
                    else:
                        pending[i] = pending[i][written:]
                        written = 0
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


_IOV_MAX = os.sysconf("SC_IOV_MAX") if hasattr(os, "sysconf") else 1024
