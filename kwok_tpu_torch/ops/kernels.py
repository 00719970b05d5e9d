"""Build, load and launch the CUDA kernels in ``kwok_tpu_torch/csrc``.

Each ``.cu`` source is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``kwok_tpu_torch/_build/`` (named by a hash of the sources and flags,
so an edited source is rebuilt), and loaded with ``ctypes``.  Nothing
here runs at import: the CPU tests import this module on machines with
no ``nvcc`` and no card.

The launchers take tensors that already lie on one CUDA device, check
their dtype, shape and contiguity, launch on PyTorch's current stream
and raise if the C entry returns a CUDA error.  They allocate nothing
but the fresh outputs the caller gets back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("tick.cu", "scatter.cu", "lease.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

MODE_SINGLE, MODE_COLLECT, MODE_COUNT = 0, 1, 2

_libs: Dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` report (registers, shared memory, spills) per source
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc on first use")


def _lib_path(src: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build(sources=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all at
    once; raise on any failure.  Returns the seconds it took."""
    t0 = time.perf_counter()
    todo = [s for s in sources if not _lib_path(s).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs: List[Tuple[str, Path, subprocess.Popen]] = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, tmp, p in procs:
            log, _ = p.communicate()
            build_log[src] = log
            if p.returncode != 0:
                failed.append(f"{src} (exit {p.returncode}):\n{log}")
            else:
                os.replace(tmp, _lib_path(src))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(src: str) -> ctypes.CDLL:
    lib = _libs.get(src)
    if lib is None:
        build((src,))
        lib = ctypes.CDLL(str(_lib_path(src)))
        if src == "tick.cu":
            lib.kwok_tick_rows.argtypes = [ctypes.POINTER(TickArgs), ctypes.c_void_p]
            lib.kwok_tick_rows.restype = ctypes.c_int
            lib.kwok_threefry_draws.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.kwok_threefry_draws.restype = ctypes.c_int
            lib.kwok_tick_smem_bytes.argtypes = [ctypes.c_int32] * 3
            lib.kwok_tick_smem_bytes.restype = ctypes.c_size_t
        elif src == "scatter.cu":
            lib.kwok_scatter_rows.argtypes = [ctypes.POINTER(ScatterArgs), ctypes.c_void_p]
            lib.kwok_scatter_rows.restype = ctypes.c_int
        else:
            lib.kwok_lease_tick.argtypes = [ctypes.POINTER(LeaseArgs), ctypes.c_void_p]
            lib.kwok_lease_tick.restype = ctypes.c_int
        _libs[src] = lib
    return lib


def _struct(name: str, fields) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": fields})


_P = ctypes.c_void_p
#: field for field the ``TickArgs`` struct of csrc/tick.cu
TickArgs = _struct("TickArgs", [
    *[(f, _P) for f in (
        "cond_col", "cond_mask", "cond_neg", "cond_valid", "w_static", "d_static",
        "j_static", "has_jitter", "d_from_del_ts", "j_from_del_ts", "stage_delete",
        "eff_mode", "eff_val", "ov_w", "ov_d", "ov_j",
        "features", "sig", "ovc", "stage", "fire_at", "active", "rematch", "del_ts",
        "now_in", "key_in", "now_out", "key_out", "sched",
        "fired", "fired_stage", "deleted", "stages", "count")],
    ("n", ctypes.c_int64), ("row_offset", ctypes.c_int64),
    *[(f, ctypes.c_int32) for f in (
        "S", "KC", "C", "SIG", "OVC", "dt_ms", "num_ticks", "mode")],
])
#: field for field the ``ScatterArgs`` struct of csrc/scatter.cu
ScatterArgs = _struct("ScatterArgs", [
    *[(f, _P) for f in (
        "features", "sig", "ovc", "stage", "fire_at", "active", "rematch", "del_ts",
        "rows", "src_features", "src_sig", "src_ovc", "src_stage", "src_fire_at",
        "src_active", "src_rematch", "src_del_ts")],
    ("b", ctypes.c_int64), ("C", ctypes.c_int32),
])
#: field for field the ``LeaseArgs`` struct of csrc/lease.cu
LeaseArgs = _struct("LeaseArgs", [
    *[(f, _P) for f in ("fire_in", "key_in", "fire_out", "due", "lag", "key_out")],
    ("n", ctypes.c_int64),
    *[(f, ctypes.c_int32) for f in ("now", "renew_ms", "jitter_ms")],
])


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> int:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def tick_rows(params, soa, dt_ms: int, num_ticks: int, mode: int, row_offset: int = 0):
    """Launch the key schedule and the row kernel of csrc/tick.cu.

    Updates the SoA's row columns in place and returns ``(now, key,
    outs)``: the advanced clock and key as fresh tensors, and ``outs``,
    the mode's outputs (``(fired, fired_stage, deleted, count)``,
    ``stages [K, N] int8`` or ``count``).  ``row_offset`` is the global
    index of the SoA's first row, which the rows' draws count from."""
    dev = soa.features.device
    if dev.type != "cuda":
        raise ValueError(f"tick_rows needs CUDA tensors, got {dev}")
    if num_ticks <= 0:
        raise ValueError("num_ticks must be positive")
    if soa.features.shape[0] == 0:
        raise ValueError("tick_rows needs at least one row")
    if not -(2**31) <= int(dt_ms) < 2**31:
        raise ValueError(f"dt_ms {dt_ms} does not fit int32")
    i32, b = torch.int32, torch.bool
    S, KC = params.cond_col.shape
    N, C = soa.features.shape
    if row_offset < 0 or row_offset + N > 2**32:
        raise ValueError(f"rows [{row_offset}, {row_offset + N}) do not fit uint32 counters")
    SIG, OVC = params.eff_mode.shape[0], params.ov_w.shape[0]
    if SIG * S * C >= 2**31 or OVC * S >= 2**31:
        raise ValueError(f"effect or override tables of {SIG * S * C} and {OVC * S} entries: "
                         "the kernel indexes them with int32")
    a = TickArgs()
    for f in ("cond_col", "cond_mask"):
        setattr(a, f, _check(f, getattr(params, f), i32, (S, KC), dev))
    for f in ("cond_neg", "cond_valid"):
        setattr(a, f, _check(f, getattr(params, f), b, (S, KC), dev))
    for f in ("w_static", "d_static", "j_static"):
        setattr(a, f, _check(f, getattr(params, f), i32, (S,), dev))
    for f in ("has_jitter", "d_from_del_ts", "j_from_del_ts", "stage_delete"):
        setattr(a, f, _check(f, getattr(params, f), b, (S,), dev))
    for f in ("eff_mode", "eff_val"):
        setattr(a, f, _check(f, getattr(params, f), i32, (SIG, S, C), dev))
    for f in ("ov_w", "ov_d", "ov_j"):
        setattr(a, f, _check(f, getattr(params, f), i32, (OVC, S), dev))
    a.features = _check("features", soa.features, i32, (N, C), dev)
    for f in ("sig", "ovc", "stage", "fire_at", "del_ts"):
        setattr(a, f, _check(f, getattr(soa, f), i32, (N,), dev))
    for f in ("active", "rematch"):
        setattr(a, f, _check(f, getattr(soa, f), b, (N,), dev))
    a.now_in = _check("now", soa.now, i32, (), dev)
    a.key_in = _check("key", soa.key, torch.uint32, (2,), dev)
    now = torch.empty((), dtype=i32, device=dev)
    key = torch.empty(2, dtype=torch.uint32, device=dev)
    sched = torch.empty(num_ticks * 4, dtype=torch.uint32, device=dev)
    a.now_out, a.key_out, a.sched = now.data_ptr(), key.data_ptr(), sched.data_ptr()
    if mode == MODE_SINGLE:
        outs = (
            torch.empty(N, dtype=b, device=dev),
            torch.empty(N, dtype=i32, device=dev),
            torch.empty(N, dtype=b, device=dev),
            torch.zeros((), dtype=i32, device=dev),
        )
        a.fired, a.fired_stage, a.deleted, a.count = (t.data_ptr() for t in outs)
    elif mode == MODE_COLLECT:
        outs = torch.empty((num_ticks, N), dtype=torch.int8, device=dev)
        a.stages = outs.data_ptr()
    elif mode == MODE_COUNT:
        outs = torch.zeros((), dtype=i32, device=dev)
        a.count = outs.data_ptr()
    else:
        raise ValueError(f"unknown mode {mode}")
    a.n, a.row_offset, a.S, a.KC, a.C, a.SIG, a.OVC = N, row_offset, S, KC, C, SIG, OVC
    a.dt_ms, a.num_ticks, a.mode = int(dt_ms), int(num_ticks), mode
    lib = _lib("tick.cu")
    with torch.cuda.device(dev):
        _raise_on(lib.kwok_tick_rows(ctypes.byref(a), _stream(dev)), "kwok_tick_rows")
    return now, key, outs


def tick_smem_bytes(S: int, KC: int, C: int) -> int:
    """Dynamic shared memory per block of the row kernel of csrc/tick.cu
    for a stage set of S stages, KC conditions a stage and C columns."""
    return int(_lib("tick.cu").kwok_tick_smem_bytes(S, KC, C))


#: the segments of a packed scatter batch, in order (csrc/scatter.cu)
BATCH_FIELDS = ("rows", "features", "sig", "ovc", "stage", "fire_at", "active", "rematch",
                "del_ts")
#: the one-byte segments; every other one holds int32 words
BATCH_FLAGS = ("active", "rematch")


class BatchLayout(NamedTuple):
    """Where each segment of a packed batch of B rows and C feature
    columns lies in its buffer: ``offsets[i]`` is the byte offset of
    ``BATCH_FIELDS[i]``, each a multiple of 16."""

    B: int
    C: int
    offsets: Tuple[int, ...]
    nbytes: int


def batch_layout(B: int, C: int) -> BatchLayout:
    offsets, at = [], 0
    for f in BATCH_FIELDS:
        offsets.append(at)
        size = B * (C if f == "features" else 1) * (1 if f in BATCH_FLAGS else 4)
        at += -(-size // 16) * 16
    return BatchLayout(B, C, tuple(offsets), at)


def scatter_rows(soa, batch: torch.Tensor, layout: BatchLayout) -> None:
    """Launch csrc/scatter.cu: write a packed batch into the SoA in place.
    ``batch`` is a uint8 tensor on the SoA's card laid out by ``layout``;
    its rows have been checked on the host."""
    dev = soa.features.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_rows needs CUDA tensors, got {dev}")
    i32, b = torch.int32, torch.bool
    N, C = soa.features.shape
    B = layout.B
    if layout.C != C:
        raise ValueError(f"batch of {layout.C} feature columns for a SoA of {C}")
    if B <= 0:
        raise ValueError("scatter_rows needs at least one row")
    if B * C >= 2**31:
        raise ValueError(f"batch of {B} x {C} words: the kernel indexes it with int32")
    a = ScatterArgs()
    a.features = _check("features", soa.features, i32, (N, C), dev)
    for f in ("sig", "ovc", "stage", "fire_at", "del_ts"):
        setattr(a, f, _check(f, getattr(soa, f), i32, (N,), dev))
    for f in ("active", "rematch"):
        setattr(a, f, _check(f, getattr(soa, f), b, (N,), dev))
    base = _check("batch", batch, torch.uint8, (layout.nbytes,), dev)
    if base % 16:
        raise ValueError("batch: not 16-byte aligned")
    for f, off in zip(BATCH_FIELDS, layout.offsets):
        setattr(a, f if f == "rows" else "src_" + f, base + off)
    a.b, a.C = B, C
    lib = _lib("scatter.cu")
    with torch.cuda.device(dev):
        _raise_on(lib.kwok_scatter_rows(ctypes.byref(a), _stream(dev)), "kwok_scatter_rows")


def lease_tick(fire_at, key, now: int, renew_ms: int, jitter_ms: int):
    """Launch csrc/lease.cu.  Returns fresh ``(fire_at, due, lag, key)``;
    the inputs are left as they were."""
    dev = fire_at.device
    if dev.type != "cuda":
        raise ValueError(f"lease_tick needs CUDA tensors, got {dev}")
    n = fire_at.shape[0] if fire_at.dim() == 1 else -1
    a = LeaseArgs()
    a.fire_in = _check("fire_at", fire_at, torch.int32, (n,), dev)
    a.key_in = _check("key", key, torch.uint32, (2,), dev)
    if n == 0:
        raise ValueError("lease_tick needs at least one slot")
    outs = (
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty(n, dtype=torch.bool, device=dev),
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty(2, dtype=torch.uint32, device=dev),
    )
    a.fire_out, a.due, a.lag, a.key_out = (t.data_ptr() for t in outs)
    a.n, a.now, a.renew_ms, a.jitter_ms = n, now, renew_ms, jitter_ms
    lib = _lib("lease.cu")
    with torch.cuda.device(dev):
        _raise_on(lib.kwok_lease_tick(ctypes.byref(a), _stream(dev)), "kwok_lease_tick")
    return outs


def threefry_draws(key: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(split(key, n), uniform(key, n))`` computed on the card by the
    device functions of csrc/threefry.cuh; for checking them."""
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"threefry_draws needs a CUDA key, got {dev}")
    kp = _check("key", key, torch.uint32, (2,), dev)
    pairs = torch.empty((n, 2), dtype=torch.uint32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _lib("tick.cu")
    with torch.cuda.device(dev):
        _raise_on(lib.kwok_threefry_draws(kp, n, pairs.data_ptr(), u.data_ptr(), _stream(dev)),
                  "kwok_threefry_draws")
    return pairs, u
