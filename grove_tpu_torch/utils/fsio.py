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
    atomic_write_text(path, json.dumps(doc))


def atomic_write_text(path: str, text: str) -> None:
    """Write `text` to `path` via temp-file + rename (atomic on POSIX), as
    atomic_write_json does."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".atomic-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
