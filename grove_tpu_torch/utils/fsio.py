"""Atomic file writes (grove_tpu/utils/fsio.py counterpart)."""

from __future__ import annotations

import json
import os
import tempfile
import time
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
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = StagedFile(path)
    try:
        f.commit(chunks)
    finally:
        f.close()


class StagedFile:
    """A file made visible whole, its bytes written ahead: they go to a
    temporary file beside `path` (`write`, as they come), and `commit`
    writes the last of them and renames the file over `path` (atomic on
    POSIX: a reader opens the old file or the new one, never a part of one).
    A failed write or rename removes the temporary file and raises; so does
    `discard`. After `commit` or `discard` the object is spent, and `close`
    releases its descriptor (a writer may do that later, off its caller's
    clock). `steps`, a list of FILE_STEPS floats, gains the seconds of each
    step."""

    def __init__(self, path: str, steps: list | None = None) -> None:
        t0 = time.perf_counter()
        self.path = path
        self.steps = steps
        self.fd, self.tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=TEMP_PREFIX)
        self._took(0, t0)

    def _took(self, step: int, t0: float) -> None:
        if self.steps is not None:
            self.steps[step] += time.perf_counter() - t0

    def write(self, chunks) -> None:
        t0 = time.perf_counter()
        try:
            write_all(self.fd, chunks)
        except BaseException:
            self.discard()
            raise
        self._took(1, t0)

    def commit(self, chunks=()) -> None:
        self.write(chunks)
        t0 = time.perf_counter()
        try:
            os.replace(self.tmp, self.path)
        except BaseException:
            self.discard()
            raise
        self.tmp = None
        self._took(3, t0)

    def discard(self) -> None:
        if self.tmp is not None:
            try:
                os.unlink(self.tmp)
            except OSError:
                pass
            self.tmp = None
        self.close()

    def close(self) -> None:
        if self.fd >= 0:
            t0 = time.perf_counter()
            fd, self.fd = self.fd, -1
            os.close(fd)
            self._took(2, t0)


# The steps of one atomic write, as StagedFile counts them, and the name
# prefix of its temporary files.
FILE_STEPS = ("open", "write", "close", "rename")
TEMP_PREFIX = ".atomic-"


def write_all(fd: int, chunks) -> None:
    """Write the byte strings `chunks` to `fd` in order, a batch per
    `os.writev` call; a chunk written in part keeps its tail."""
    pending = [memoryview(c) for c in chunks if len(c)]
    i = 0
    while i < len(pending):
        written = os.writev(fd, pending[i:i + _IOV_MAX])
        while written:
            if written >= len(pending[i]):
                written -= len(pending[i])
                i += 1
            else:
                pending[i] = pending[i][written:]
                written = 0


_IOV_MAX = os.sysconf("SC_IOV_MAX") if hasattr(os, "sysconf") else 1024
