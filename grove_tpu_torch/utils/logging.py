"""Structured leveled logging — the `operator/internal/logger/logger.go` analog.

The reference builds a zap-backed logr with level {debug,info,error} and
format {json,text} from OperatorConfiguration. Here: stdlib logging with a
JSON or key=value formatter, level/format from the same config surface, and
logr-style key-value pairs (`log.info("msg", pcs="a", replica=2)`).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO, "error": logging.ERROR}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        doc.update(getattr(record, "kv", {}))
        return json.dumps(doc, default=str)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        kv = " ".join(
            f"{k}={v}" for k, v in getattr(record, "kv", {}).items()
        )
        base = f"{ts} {record.levelname[:4]} {record.name}: {record.getMessage()}"
        return f"{base} {kv}" if kv else base


class Logger:
    """logr-flavored wrapper: leveled, structured key-values, named children."""

    def __init__(self, inner: logging.Logger):
        self._inner = inner

    def with_name(self, name: str) -> "Logger":
        # Standalone child (not via the global registry): shares this
        # logger's handlers/level but cannot be reconfigured from outside.
        child = logging.Logger(f"{self._inner.name}.{name}", self._inner.level)
        child.handlers = self._inner.handlers
        child.propagate = False
        return Logger(child)

    def debug(self, msg: str, **kv: Any) -> None:
        self._inner.debug(msg, extra={"kv": kv})

    def info(self, msg: str, **kv: Any) -> None:
        self._inner.info(msg, extra={"kv": kv})

    def error(self, msg: str, **kv: Any) -> None:
        self._inner.error(msg, extra={"kv": kv})


def new_logger(
    level: str = "info", fmt: str = "text", name: str = "grove", stream=None
) -> Logger:
    """MustNewLogger analog. Unknown level/format raise ValueError (the
    reference treats bad log config as a boot failure)."""
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level!r} (want debug|info|error)")
    if fmt not in ("json", "text"):
        raise ValueError(f"unknown log format {fmt!r} (want json|text)")
    # Standalone instance, NOT logging.getLogger(name): two managers in one
    # process must not reconfigure each other's handlers through the global
    # logger registry.
    inner = logging.Logger(name, _LEVELS[level])
    inner.propagate = False
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_JsonFormatter() if fmt == "json" else _TextFormatter())
    inner.handlers = [handler]
    return Logger(inner)
