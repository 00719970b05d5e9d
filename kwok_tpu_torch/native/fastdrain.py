"""Loader for the kwok_fastdrain CPython extension.

The accelerator exists because "only dirty rows cross the boundary"
(SURVEY.md:373) leaves the drain's dict-building as the host
bottleneck; the reference has no native analog (CGO is disabled,
hack/releases.sh:186).  Unlike the ctypes-based delay heap
(kwok_tpu/native/__init__.py), the
drain accelerator manipulates Python dicts directly, so it is a real
extension module compiled against Python.h and imported from its build
path.  ``KWOK_TPU_NATIVE=0`` or a missing toolchain falls back to the
pure-Python implementations everywhere it is used.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from typing import Optional

_LIB_NAME = "kwok_fastdrain.so"
_lock = threading.Lock()
_mod = None
_tried = False


def _source_path() -> str:
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo_root, "native", "kwok_fastdrain.c")


def _build(target: str) -> bool:
    src = _source_path()
    if not os.path.exists(src):
        return False
    include = sysconfig.get_paths().get("include")
    if not include:
        return False
    try:
        subprocess.run(
            [
                "g++",
                "-O2",
                "-shared",
                "-fPIC",
                f"-I{include}",
                "-o",
                target,
                "-x",
                "c",
                src,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load():
    """The extension module, building it if necessary; None if
    unavailable or disabled via KWOK_TPU_NATIVE=0."""
    global _mod, _tried
    if os.environ.get("KWOK_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _mod is not None or _tried:
            return _mod
        _tried = True
        here = os.path.dirname(os.path.abspath(__file__))
        cached = os.path.join(here, _LIB_NAME)
        src = _source_path()
        stale = (
            not os.path.exists(cached)
            or (
                os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(cached)
            )
        )
        # the compile runs under the lock on purpose: build-once
        # semantics — concurrent first callers must block until the
        # extension exists rather than race duplicate compiles
        if stale and not _build(cached):  # kwoklint: disable=lock-discipline
            return None
        try:
            loader = importlib.machinery.ExtensionFileLoader(
                "kwok_fastdrain", cached
            )
            spec = importlib.util.spec_from_file_location(
                "kwok_fastdrain", cached, loader=loader
            )
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except (ImportError, OSError):
            return None
        _mod = mod
        return _mod
