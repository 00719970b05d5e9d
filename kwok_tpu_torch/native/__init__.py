"""ctypes bindings for the C++ runtime core (native/kwok_native.cpp).

The shared library is built on demand with g++ the first time it is
needed (and cached beside this package); when no toolchain is present
everything falls back to the pure-Python implementations, so the
native layer is a transparent accelerator, never a hard dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_LIB_NAME = "libkwok_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _source_dir() -> str:
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo_root, "native")


def _build(target: str) -> bool:
    src = os.path.join(_source_dir(), "kwok_native.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", target, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it if necessary; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        here = os.path.dirname(os.path.abspath(__file__))
        cached = os.path.join(here, _LIB_NAME)
        # the compile runs under _lock on purpose: build-once semantics —
        # concurrent first callers must block until the library exists
        # rather than race duplicate compiler invocations
        if not os.path.exists(cached) and not _build(cached):  # kwoklint: disable=lock-discipline
            return None
        try:
            lib = ctypes.CDLL(cached)
        except OSError:
            return None
        lib.kn_heap_new.restype = ctypes.c_void_p
        lib.kn_heap_free.argtypes = [ctypes.c_void_p]
        lib.kn_heap_add.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_double,
        ]
        lib.kn_heap_cancel.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.kn_heap_cancel.restype = ctypes.c_int
        lib.kn_heap_promote.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.kn_heap_pop_ready.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
        ]
        lib.kn_heap_pop_ready.restype = ctypes.c_int
        lib.kn_heap_next_deadline.argtypes = [ctypes.c_void_p]
        lib.kn_heap_next_deadline.restype = ctypes.c_double
        lib.kn_heap_ready_count.argtypes = [ctypes.c_void_p]
        lib.kn_heap_ready_count.restype = ctypes.c_int
        lib.kn_heap_size.argtypes = [ctypes.c_void_p]
        lib.kn_heap_size.restype = ctypes.c_int
        lib.kn_fnv1a64_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


class NativeDelayHeap:
    """Python face of the C++ delay/weight heap.

    Schedules opaque int64 ids: :meth:`add` (re-add reschedules),
    :meth:`cancel`, :meth:`promote` (move due entries to their weight
    buckets), :meth:`pop_ready` (lowest weight first, FIFO within a
    weight), :meth:`next_deadline`."""

    __slots__ = ("_h", "_lib", "_buf")

    _POP_BATCH = 1024

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("kwok_native library unavailable")
        self._lib = lib
        self._h = lib.kn_heap_new()
        self._buf = (ctypes.c_int64 * self._POP_BATCH)()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.kn_heap_free(h)

    def add(self, id_: int, weight: int, deadline: float) -> None:
        self._lib.kn_heap_add(self._h, id_, weight, deadline)

    def cancel(self, id_: int) -> bool:
        return bool(self._lib.kn_heap_cancel(self._h, id_))

    def promote(self, now: float) -> None:
        self._lib.kn_heap_promote(self._h, now)

    def pop_ready(self, max_items: Optional[int] = None):
        out = []
        budget = max_items if max_items is not None else 1 << 31
        while budget > 0:
            n = self._lib.kn_heap_pop_ready(
                self._h, self._buf, min(budget, self._POP_BATCH)
            )
            if n <= 0:
                break
            out.extend(self._buf[:n])
            budget -= n
        return out

    def next_deadline(self) -> Optional[float]:
        d = self._lib.kn_heap_next_deadline(self._h)
        return None if d < 0 else d

    @property
    def ready_count(self) -> int:
        return self._lib.kn_heap_ready_count(self._h)

    def __len__(self) -> int:
        return self._lib.kn_heap_size(self._h)


def fnv1a64(values) -> list:
    """Batch FNV-1a 64 over a list of str/bytes."""
    lib = load()
    enc = [v.encode() if isinstance(v, str) else bytes(v) for v in values]
    if lib is None:
        out = []
        for b in enc:
            h = 0xCBF29CE484222325
            for byte in b:
                h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
            out.append(h)
        return out
    buf = b"".join(enc)
    n = len(enc)
    offs = (ctypes.c_int64 * n)()
    lens = (ctypes.c_int64 * n)()
    pos = 0
    for i, b in enumerate(enc):
        offs[i] = pos
        lens[i] = len(b)
        pos += len(b)
    out = (ctypes.c_uint64 * n)()
    lib.kn_fnv1a64_batch(buf, offs, lens, n, out)
    return list(out)
