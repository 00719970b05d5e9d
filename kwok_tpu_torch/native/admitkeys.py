"""Loader for the kwok_admitkeys CPython extension (``admitkeys.c``).

The extension builds the two admission keys of
``DeviceSimulator._classify`` (the signature key's text and the regions
key) in one pass over the admitted object, byte for byte the texts that
``json.dumps`` writes on the Python path: the reference's signature key
(kwok_tpu/engine/compiler.py:309 ``_signature_key``) after its
JSON-standard walk (kwok_tpu/engine/lifecycle.py:335
``to_json_standard``), and ``engine/behaviour.py``'s ``Regions.key``.  Like ``fastdrain`` it is a
real extension module compiled with g++ against ``Python.h`` and
imported from its build path: ``kwok_tpu_torch/_build/``, under a name
that hashes the source, the flags and the interpreter, so a checkout
builds it once.  ``KWOK_TPU_NATIVE=0`` or a missing toolchain leaves the
Python path everywhere it is used.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

_NAME = "kwok_admitkeys"
_SOURCE = Path(__file__).resolve().parent / "admitkeys.c"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_mod = None
_tried = False


def _command(out: str) -> list:
    include = sysconfig.get_paths().get("include") or ""
    return ["g++", "-O2", "-shared", "-fPIC", f"-I{include}", "-o", out, "-x", "c", str(_SOURCE)]


def _target() -> Path:
    h = hashlib.sha1(" ".join(_command("")).encode())
    h.update(sys.version.encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"{_NAME}-{h.hexdigest()[:12]}.so"


def _build(target: Path) -> bool:
    """Compile into a file of this process and thread, renamed into place
    when the compile succeeds, so builds that race never share a file."""
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(_command(str(tmp)), check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
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
        target = _target()
        # the compile runs under the lock on purpose: build-once
        # semantics — concurrent first callers must block until the
        # extension exists rather than race duplicate compiles
        if not target.exists() and not _build(target):  # kwoklint: disable=lock-discipline
            return None
        try:
            loader = importlib.machinery.ExtensionFileLoader(_NAME, str(target))
            spec = importlib.util.spec_from_file_location(_NAME, str(target), loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except (ImportError, OSError):
            return None
        _mod = mod
        return _mod
