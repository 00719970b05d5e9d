"""Structured logging (the pkg/log equivalent).

The reference wraps slog with levels, key=value attributes, context
carrying, and ``KObj`` object references (reference pkg/log/logger.go;
SURVEY.md:356 records the role).
This is the same shape on stdlib logging: one process-wide root with
``key=value`` formatting, ``with_values`` child loggers, a ``kobj``
helper rendering ``ns/name`` refs, and a ``-v`` flag mapping
(0=info, 1=debug, 2+=everything including third-party)."""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Any, Optional

__all__ = ["Logger", "get_logger", "setup", "kobj"]

_setup_done = False
_setup_mut = threading.Lock()


def kobj(obj: Optional[dict]) -> str:
    """Render an object reference as ``ns/name`` (pkg/log KObj)."""
    if not obj:
        return "<nil>"
    meta = obj.get("metadata") or {}
    ns = meta.get("namespace") or ""
    name = meta.get("name") or ""
    return f"{ns}/{name}" if ns else name


class _KVFormatter(logging.Formatter):
    """``HH:MM:SS.mmm LEVEL component message key=value ...``"""

    def format(self, record: logging.LogRecord) -> str:
        t = time.strftime("%H:%M:%S", time.localtime(record.created))
        ms = int(record.msecs)
        parts = [
            f"{t}.{ms:03d}",
            record.levelname,
            record.name,
            record.getMessage(),
        ]
        kvs = getattr(record, "kwok_kvs", None)
        if kvs:
            parts.extend(f"{k}={_render(v)}" for k, v in kvs.items())
        if record.exc_info:
            parts.append("\n" + self.formatException(record.exc_info))
        return " ".join(parts)


def _render(v: Any) -> str:
    if isinstance(v, dict) and "metadata" in v:
        return kobj(v)
    s = str(v)
    return f'"{s}"' if " " in s else s


class Logger:
    """Level methods carry trailing ``key=value`` attributes:
    ``log.info("played stage", pod=obj, stage=name)``."""

    def __init__(self, base: logging.Logger, values: Optional[dict] = None):
        self._base = base
        self._values = dict(values or {})

    def with_values(self, **kvs: Any) -> "Logger":
        merged = dict(self._values)
        merged.update(kvs)
        return Logger(self._base, merged)

    def _log(self, level: int, msg: str, kvs: dict, exc_info=None) -> None:
        if not self._base.isEnabledFor(level):
            return
        merged = dict(self._values)
        merged.update(kvs)
        self._base.log(level, msg, extra={"kwok_kvs": merged}, exc_info=exc_info)

    def debug(self, msg: str, **kvs: Any) -> None:
        self._log(logging.DEBUG, msg, kvs)

    def info(self, msg: str, **kvs: Any) -> None:
        self._log(logging.INFO, msg, kvs)

    def warn(self, msg: str, **kvs: Any) -> None:
        self._log(logging.WARNING, msg, kvs)

    def error(self, msg: str, exc_info=None, **kvs: Any) -> None:
        self._log(logging.ERROR, msg, kvs, exc_info=exc_info)


def setup(verbosity: int = 0, stream=None) -> None:
    """Install the kv formatter on the kwok root (idempotent).
    -v mapping mirrors the reference's klog-style levels."""
    global _setup_done
    with _setup_mut:
        root = logging.getLogger("kwok")
        if not _setup_done:
            handler = logging.StreamHandler(stream or sys.stderr)
            handler.setFormatter(_KVFormatter())
            root.addHandler(handler)
            root.propagate = False
            _setup_done = True
        root.setLevel(logging.DEBUG if verbosity >= 1 else logging.INFO)


def get_logger(component: str) -> Logger:
    return Logger(logging.getLogger(f"kwok.{component}"))
