"""Checksummed, segmented write-ahead log — crash durability *with
integrity* between snapshots.

The reference delegates durability to etcd, whose WAL CRCs every frame
and whose reader refuses to serve a log it cannot verify (reference
kwokctl just snapshots etcd wholesale, pkg/kwokctl/etcd/save.go:1).
The first-generation log here (PR 3) was unchecksummed JSON lines
where *any* undecodable record was skipped as if it were a torn tail —
a single flipped bit mid-log silently lost acknowledged writes, the
exact violation the DST ``no-lost-writes`` invariant
(``kwok_tpu/dst/invariants.py:77``) exists to rule out.  This rewrite
is the etcd-grade seat:

- **framing**: each record is one line ``"<seq> <crc32> <json>"`` —
  a monotonic sequence number plus a CRC32 over ``"<seq> <json>"``.
  A frame that fails the CRC, fails to parse, or breaks sequence
  continuity is *detected*, never silently absorbed.
- **torn tail vs corruption**: only the **final line of the log** may
  be dropped silently (the legal crash-mid-append debris — at most one
  partial line, because appends are single writes of newline-terminated
  text).  Any other bad frame is mid-log corruption:
  :func:`read_records` raises :class:`WalCorruption`, and the tolerant
  recovery path (``ResourceStore.recover_wal``,
  ``kwok_tpu/cluster/store.py:1797``) applies every verifiable frame
  and reports the exact missing resourceVersions instead of guessing.
- **segments**: the active file rotates at ``segment_bytes`` into
  sealed read-only segments (``<path>.seg-NNNNNNNN``).  Snapshot
  compaction archives (or deletes) segments the snapshot fully covers
  — sealed files are only ever renamed whole, so a crash at any point
  mid-compaction leaves a log that still covers everything the last
  durable snapshot does not (provable via :meth:`set_crash_hook`).
- **fsck**: ``python -m kwok_tpu_torch.cluster.wal --fsck PATH`` verifies
  frame integrity, sequence continuity and (with ``--snapshot``) the
  compaction floor offline, exiting nonzero on any integrity failure.
- **resource exhaustion**: every append/fsync/seal site classifies
  ENOSPC/EIO/EDQUOT instead of absorbing it.  A failed *write* is
  retried once on a repaired fresh handle after the preallocated
  **emergency reserve** (``<path>.reserve``) is released — the
  in-flight record still becomes durable on a full disk — and the log
  enters a **degraded** state (:attr:`WriteAheadLog.degraded`) the
  store turns into read-only mode (503 + Retry-After) instead of
  silently acking writes that never hit the disk (the fsyncgate
  failure class).  A failed *fsync* poisons the file handle (the
  kernel may have dropped the dirty pages and consumed the error):
  the active file is sealed whole and a fresh handle opened — the
  poisoned fd is never fsynced again and the unsynced tail is never
  called machine-crash durable; if its pages were in fact lost, the
  CRC framing converts that into *detected* corruption at recovery,
  never silent loss.  :meth:`WriteAheadLog.try_rearm` re-arms writes
  (and the reserve) once space returns.  Seeded exhaustion windows
  inject through the duck-typed pressure-shim seam
  (:meth:`WriteAheadLog.set_pressure`; the shim lives in
  ``kwok_tpu/chaos/fs_pressure.py:1``).
- **snapshot integrity**: :func:`write_state_file` embeds a CRC32 over
  the canonical state JSON so a bit-flipped snapshot is *detected* at
  load instead of silently restoring corrupt objects
  (``read_state_file`` raises :class:`SnapshotCorruption`; boot then
  falls back to the newest verifiable archived snapshot,
  ``kwok_tpu/snapshot/pitr.py:1``).

Record shapes (all carry ``rv``)::

    {"t": "ev", "rv": N, "u": uid_counter, "e": "ADDED|MODIFIED|DELETED", "o": {obj}}
    {"t": "status", "rv": N, "k": kind, "i": [[ns, name, status, rv], ...]}
    {"t": "type", "rv": N, "api_version": ..., "kind": ..., "plural": ..., "namespaced": ...}
    {"t": "reset", "rv": N}          # restore_state wiped the keyspace
    {"t": "txn", "rv": maxN, "recs": [ev, ...]}  # transact(): one frame,
                                     # so the batch is durable (and
                                     # replays) all-or-nothing

Legacy (PR 3) bare-JSON lines are still readable for upgrade, counted
as ``legacy`` frames by the scanner and flagged by fsck.
"""

from __future__ import annotations

import errno
import json
import os
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from kwok_tpu_torch.utils import telemetry as _telemetry

#: observed storage-latency histograms (SLO telemetry; shard is the
#: bounded sharded-store index, 0 for the single-store layout).  The
#: append series covers the whole framed write (encode excluded, policy
#: fsync included); the fsync series isolates the os.fsync syscall.
_H_APPEND = _telemetry.histogram(
    "kwok_wal_append_seconds",
    help="WAL append latency (framed write + flush + policy fsync)",
    labelnames=("shard",),
)
_H_FSYNC = _telemetry.histogram(
    "kwok_wal_fsync_seconds",
    help="WAL fsync syscall latency",
    labelnames=("shard",),
)

__all__ = [
    "WalCorruption",
    "SnapshotCorruption",
    "WalExhausted",
    "StorageDegraded",
    "WalScan",
    "WriteAheadLog",
    "classify_os_error",
    "read_records",
    "record_rvs",
    "scan",
    "scan_files",
    "segment_files",
    "fsck",
    "fsck_sharded",
    "write_state_file",
    "read_state_file",
    "verify_state",
]

#: sealed-segment suffix: ``<active-path>.seg-00000001`` etc.
SEG_INFIX = ".seg-"

#: default rotation threshold for the active segment
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024

#: emergency-reserve suffix: preallocated headroom released on the
#: first ENOSPC so sealing, the retried in-flight append, and lease
#: renewals still complete on a full disk
RESERVE_SUFFIX = ".reserve"

#: default emergency-reserve size (enough for thousands of small
#: records — lease renewals and degraded markers, not bulk traffic)
DEFAULT_RESERVE_BYTES = 256 * 1024


def classify_os_error(exc: OSError) -> str:
    """Exhaustion taxonomy for an append/fsync/seal failure: the three
    errnos the resource-exhaustion layer treats distinctly, plus a
    catch-all.  ``disk-full``/``quota`` mean space may come back (the
    degraded probe re-arms); ``io-error`` means the media itself
    failed (fsyncgate territory: never trust the poisoned handle)."""
    eno = getattr(exc, "errno", None)
    if eno == errno.ENOSPC:
        return "disk-full"
    if eno == getattr(errno, "EDQUOT", -1):
        return "quota"
    # EIO and every other errno: the media failed, space will not help
    return "io-error"


class WalExhausted(OSError):
    """An append could not be made durable even through the emergency
    reserve.  Internal signal: the store rolls the in-memory commit
    back and surfaces :class:`StorageDegraded` instead of acking."""

    def __init__(self, message: str, reason: str = "disk-full"):
        super().__init__(message)
        self.reason = reason


class StorageDegraded(RuntimeError):
    """The storage layer cannot make new writes durable (disk full,
    quota, poisoned fsync).  The apiserver maps this to 503 +
    Retry-After with the machine-readable reason ``StorageDegraded``;
    reads, watches and lease renewals keep working."""

    def __init__(
        self, reason: str, detail: str = "", retry_after: float = 5.0
    ):
        super().__init__(
            f"storage degraded ({reason})" + (f": {detail}" if detail else "")
        )
        self.reason = reason
        # integer seconds: RFC 9110 Retry-After is 1*DIGIT, and stock
        # client stacks drop fractional values — the whole point of the
        # header is that THEY back off
        self.retry_after = max(1, int(round(retry_after)))


class WalCorruption(ValueError):
    """Mid-log corruption: a frame that is provably damaged and is NOT
    the torn tail.  Carries where, and what the scanner could bound."""

    def __init__(self, message: str, corruptions: Optional[List[dict]] = None):
        super().__init__(message)
        self.corruptions = corruptions or []


class SnapshotCorruption(ValueError):
    """A state-file whose embedded integrity checksum does not match."""


# ---------------------------------------------------------------- framing


def _frame(seq: int, payload: str) -> str:
    body = f"{seq} {payload}"
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    return f"{seq} {crc:08x} {payload}\n"


def encode_record(seq: int, record: Dict[str, Any]) -> str:
    """One framed line for ``record`` (compact JSON, seq + CRC32)."""
    return _frame(seq, json.dumps(record, separators=(",", ":")))


def _parse_frame(line: str) -> Tuple[Optional[int], Dict[str, Any], bool]:
    """Returns ``(seq, record, legacy)``; raises ValueError on any
    damaged frame (bad CRC, bad JSON, bad shape)."""
    if line.startswith("{"):
        # legacy PR-3 bare-JSON record: parseable but unchecksummed
        rec = json.loads(line)
        if not isinstance(rec, dict):
            raise ValueError("legacy line is not an object")
        return None, rec, True
    head, _, rest = line.partition(" ")
    crc_hex, _, payload = rest.partition(" ")
    if not head or not crc_hex or not payload:
        raise ValueError("short frame")
    seq = int(head)  # ValueError propagates as damage
    # the writer only ever emits 8 lowercase hex digits ("%08x"), so a
    # non-canonical checksum field IS frame damage.  int(x, 16) alone
    # would read e.g. "Fe06bc6c" as the same value as "fe06bc6c" — a
    # single bit flip on the 0x20 case bit of a hex letter would be
    # silently absorbed (found by the DST coverage-guided fault
    # search's recovery-honesty probe).
    if len(crc_hex) != 8 or any(
        c not in "0123456789abcdef" for c in crc_hex
    ):
        raise ValueError(f"non-canonical checksum field {crc_hex!r}")
    want = int(crc_hex, 16)
    got = zlib.crc32(f"{seq} {payload}".encode("utf-8")) & 0xFFFFFFFF
    if got != want:
        raise ValueError(f"crc mismatch (want {want:08x}, got {got:08x})")
    rec = json.loads(payload)
    if not isinstance(rec, dict):
        raise ValueError("frame payload is not an object")
    return seq, rec, False


#: tolerated-OSError tally by site — helper probes that legitimately
#: stay tolerant (directory listings, size probes) still count and log
#: what they absorbed instead of hiding an EIO behind an ENOENT
IO_TOLERATED: Dict[str, int] = {}


def _note_os_error(site: str, exc: OSError) -> None:
    """Record a tolerated OSError: count it per site, and log anything
    that is not plain absence (a missing archive dir is normal; an EIO
    from ``listdir`` is the disk failing and must be visible)."""
    IO_TOLERATED[site] = IO_TOLERATED.get(site, 0) + 1
    if getattr(exc, "errno", None) in (errno.ENOENT, errno.ENOTDIR):
        return
    from kwok_tpu_torch.utils.log import get_logger

    get_logger("wal").warn(
        "tolerated I/O error", site=site, kind=classify_os_error(exc),
        error=str(exc),
    )


# ---------------------------------------------------------------- scanning


@dataclass
class WalScan:
    """Everything a tolerant pass over a log (or segment set) found."""

    #: verifiable records, in file order
    records: List[Dict[str, Any]] = field(default_factory=list)
    #: per-record sequence numbers aligned with ``records`` (None for
    #: legacy frames)
    seqs: List[Optional[int]] = field(default_factory=list)
    #: mid-log damage: [{"file", "line", "detail", "lost_frames"}]
    corruptions: List[dict] = field(default_factory=list)
    #: 1 when the final line of the final file was dropped as a torn
    #: (crash-mid-append) frame
    torn_tail: int = 0
    #: count of legacy (unchecksummed) frames accepted
    legacy: int = 0
    last_seq: Optional[int] = None
    files: List[str] = field(default_factory=list)
    total_lines: int = 0

    @property
    def clean(self) -> bool:
        return not self.corruptions

    def raise_if_corrupt(self) -> None:
        if self.corruptions:
            c = self.corruptions[0]
            raise WalCorruption(
                f"WAL corruption at {c['file']}:{c['line']}: {c['detail']}"
                + (
                    f" (+{len(self.corruptions) - 1} more)"
                    if len(self.corruptions) > 1
                    else ""
                ),
                self.corruptions,
            )


def segment_files(path: str) -> List[str]:
    """Sealed segments (sorted oldest-first) followed by the active
    file — the live log's read order."""
    out: List[str] = []
    d = os.path.dirname(path) or "."
    base = os.path.basename(path) + SEG_INFIX
    try:
        names = os.listdir(d)
    # directory probe stays tolerant (a not-yet-created workdir is
    # normal), but classified + counted — never silently absorbed
    except OSError as exc:
        _note_os_error("segment_files.listdir", exc)
        names = []
    for n in sorted(names):
        if n.startswith(base):
            out.append(os.path.join(d, n))
    if os.path.exists(path):
        out.append(path)
    return out


def scan_files(files: List[str]) -> WalScan:
    """Tolerant scan over an explicit ordered file list (the PITR
    archive replays archived segments ahead of the live log this way).

    Classification: a damaged line that is the *final line of the final
    file* is the torn tail (dropped, counted); every other damaged line
    — or a sequence-number gap between adjacent verifiable frames — is
    recorded as corruption.  Verifiable frames after a corrupt region
    are still returned: recovery applies everything provable and
    reports the gap, it never silently skips."""
    out = WalScan(files=list(files))
    # (file, lineno, detail) of damaged lines, classified afterwards
    damaged: List[Tuple[str, int, str, int]] = []  # + global line index
    gidx = 0
    prev_seq: Optional[int] = None
    prev_gidx = -1
    for fp in files:
        try:
            # binary + per-line decode: a flipped bit can produce
            # invalid UTF-8, which must classify as a damaged frame,
            # not blow up the whole scan
            f = open(fp, "rb")
        # a file that vanished between listing and open (compaction
        # raced the scan) is normal; an EIO open is counted + logged
        except OSError as exc:
            _note_os_error("scan_files.open", exc)
            continue
        with f:
            for lineno, raw in enumerate(f, 1):
                raw = raw.strip()
                if not raw:
                    continue
                gidx += 1
                try:
                    seq, rec, legacy = _parse_frame(
                        raw.decode("utf-8")
                    )
                except (ValueError, UnicodeDecodeError) as exc:
                    damaged.append((fp, lineno, str(exc), gidx))
                    continue
                if legacy:
                    out.legacy += 1
                elif seq is not None:
                    if prev_seq is not None and seq != prev_seq + 1:
                        # lines vanished (or an alien file was spliced
                        # in) without leaving parse damage behind
                        lost = seq - prev_seq - 1
                        intervening = [
                            d for d in damaged if d[3] > prev_gidx
                        ]
                        if lost != len(intervening):
                            out.corruptions.append(
                                {
                                    "file": fp,
                                    "line": lineno,
                                    "detail": (
                                        f"sequence gap: {prev_seq} -> {seq}"
                                        f" ({lost} frame(s) missing,"
                                        f" {len(intervening)} damaged line(s))"
                                    ),
                                    "lost_frames": lost,
                                }
                            )
                    prev_seq = seq
                    prev_gidx = gidx
                    out.last_seq = seq
                out.records.append(rec)
                out.seqs.append(seq)
    out.total_lines = gidx
    # classify damaged lines: only the very last line of the log may be
    # dropped silently as the torn tail
    for fp, lineno, detail, idx in damaged:
        if idx == gidx and fp == (files[-1] if files else fp):
            out.torn_tail = 1
        else:
            out.corruptions.append(
                {"file": fp, "line": lineno, "detail": detail, "lost_frames": 1}
            )
    return out


def scan(path: str) -> WalScan:
    """Tolerant scan of the live log rooted at ``path`` (sealed
    segments + active file)."""
    return scan_files(segment_files(path))


def record_rvs(
    rec: Dict[str, Any], include_void: bool = False
) -> Iterator[int]:
    """Every resourceVersion one WAL record commits: the event's own
    rv, each status-batch item's, each txn sub-event's.  The ONE walk
    shared by retention/continuity accounting (fsck, the PITR rebuild)
    and the DST durability probes — a record type added to the framing
    must be threaded here once, not per consumer.  ``include_void``
    adds allocated-then-rolled-back rvs (``ResourceStore._unbump``):
    they count as *accounted* for continuity (the number was never a
    commit) but must NOT satisfy a durability check — an acked rv
    that was voided IS a lost write.  (``ResourceStore._apply_wal_scan``
    keeps its own walk: replay interleaves application with the rv
    accounting per record.)"""
    t = rec.get("t")
    if t == "ev" or (include_void and t == "void"):
        try:
            yield int(rec.get("rv", 0) or 0)
        except (TypeError, ValueError):
            return
    elif t == "status":
        for item in rec.get("i") or []:
            try:
                yield int(item[3])
            except (LookupError, TypeError, ValueError):
                continue
    elif t == "txn":
        for sub in rec.get("recs") or []:
            if sub.get("t") != "ev":
                continue
            try:
                yield int(sub.get("rv", 0) or 0)
            except (TypeError, ValueError):
                continue


def read_records(path: str) -> Iterator[Dict[str, Any]]:
    """Yield every verifiable record of the live log.

    A torn tail (the final line only) is skipped — the legal
    crash-mid-append case.  Mid-log damage raises
    :class:`WalCorruption` instead of being skipped: an earlier
    generation of this reader ``continue``d past *any* undecodable
    line, which silently conflated a flipped bit with a torn tail and
    lost acknowledged writes.  Callers that must make progress over a
    damaged log use :func:`scan` (and report the loss) instead."""
    s = scan(path)
    s.raise_if_corrupt()
    for rec in s.records:
        yield rec


# --------------------------------------------------------------- fs helpers


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a rename/create is durable, not
    just the file contents (the atomic-rename half of crash safety).

    Deliberately tolerant: directory fsync is a best-effort durability
    upgrade — some filesystems reject O_RDONLY dir fsync outright, and
    failing the *rename itself* over it would turn a working log
    unusable.  Both sites classify + count what they absorb."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    # reason: dirs unopenable for fsync (e.g. permissions, exotic fs)
    # must not fail the already-completed rename
    except OSError as exc:
        _note_os_error("fsync_dir.open", exc)
        return
    try:
        os.fsync(fd)
    # reason: same best-effort posture as the open above
    except OSError as exc:
        _note_os_error("fsync_dir.fsync", exc)
    finally:
        os.close(fd)


# --------------------------------------------------------- state integrity


def _canonical(state: Dict[str, Any]) -> bytes:
    return json.dumps(
        state, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")


def state_crc(state: Dict[str, Any]) -> int:
    """CRC32 over the canonical JSON of ``state`` minus its own
    ``integrity`` block."""
    body = {k: v for k, v in state.items() if k != "integrity"}
    return zlib.crc32(_canonical(body)) & 0xFFFFFFFF


def write_state_file(path: str, state: Dict[str, Any]) -> None:
    """Atomically write a snapshot with an embedded integrity checksum
    (tmp → fsync → rename → directory fsync): a crash never leaves a
    truncated file, and a later bit flip is detected at load."""
    doc = dict(state)
    doc["integrity"] = {"v": 1, "crc32": state_crc(state)}
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def verify_state(state: Dict[str, Any], source: str = "<state>") -> Dict[str, Any]:
    """Check an in-memory state dict's embedded checksum (no-op for
    pre-integrity snapshots); raises :class:`SnapshotCorruption`."""
    integ = state.get("integrity")
    if isinstance(integ, dict) and "crc32" in integ:
        want = int(integ["crc32"])
        got = state_crc(state)
        if got != want:
            raise SnapshotCorruption(
                f"{source}: snapshot checksum mismatch "
                f"(want {want:08x}, got {got:08x})"
            )
    return state


def read_state_file(path: str) -> Dict[str, Any]:
    """Load + integrity-verify a snapshot written by
    :func:`write_state_file` (files without the integrity block — the
    pre-checksum format — load unverified for upgrade)."""
    with open(path, "r", encoding="utf-8") as f:
        try:
            state = json.load(f)
        except ValueError as exc:
            raise SnapshotCorruption(f"{path}: unparseable snapshot: {exc}")
    if not isinstance(state, dict):
        raise SnapshotCorruption(f"{path}: snapshot is not an object")
    return verify_state(state, source=path)


# ------------------------------------------------------------------ writer


class WriteAheadLog:
    """Append-only framed mutation log with segments and a pluggable
    fsync policy.

    Not internally locked: the store appends under its own mutex (the
    same serialization the mutations themselves commit under), so
    records land in commit order by construction — and rotation /
    compaction swap file handles under that same mutex
    (``kwok_tpu/cluster/store.py:1738`` save_file).
    """

    FSYNC_POLICIES = ("always", "interval", "off")

    def __init__(
        self,
        path: str,
        fsync: str = "interval",
        fsync_interval: float = 0.5,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        archive_dir: Optional[str] = None,
        reserve_bytes: int = DEFAULT_RESERVE_BYTES,
    ):
        if fsync not in self.FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {self.FSYNC_POLICIES}"
            )
        self.path = path
        self.fsync = fsync
        self.fsync_interval = fsync_interval
        #: which store shard this log backs (0 = the single-store /
        #: shard-0 workdir root layout; kwok_tpu/cluster/sharding sets
        #: 1..N-1 on the shard logs) — the bounded label the observed
        #: append/fsync latency histograms carry
        self.shard = 0
        self.segment_bytes = int(segment_bytes)
        #: sealed segments fully covered by a snapshot move here on
        #: compaction (the PITR archive); None deletes them instead
        self.archive_dir = archive_dir
        self._last_sync = 0.0
        #: monotonic instant of the last real fsync (health surface)
        self._last_fsync_at: Optional[float] = None
        #: emergency reserve: preallocated headroom released on the
        #: first ENOSPC so the in-flight append, sealing, and lease
        #: renewals still complete on a full disk; 0 disables
        self.reserve_bytes = int(reserve_bytes)
        self._reserve_path = path + RESERVE_SUFFIX
        #: degraded state: None (healthy) or {"reason", "detail",
        #: "since"} — the store turns this into read-only mode
        self._degraded: Optional[Dict[str, Any]] = None
        self._last_rearm_probe = 0.0
        #: exhaustion counters (health surface / metrics)
        self.enospc_total = 0
        self.fsync_failures_total = 0
        self.io_errors_total = 0
        self.rearms_total = 0
        #: duck-typed filesystem-pressure shim (chaos/fs_pressure.py):
        #: consulted before this log's own write/fsync syscalls —
        #: ``on_write(nbytes)``/``on_fsync()`` raise the injected
        #: OSError, ``freed(nbytes)`` credits released reserve space
        self._pressure = None
        #: chaos crash points inside compaction/rotation (phase names:
        #: compact-begin, compact-sealed, compact-mid-archive,
        #: compact-done) — a hook that raises leaves the files exactly
        #: as a crash at that boundary would
        self._crash_hook: Optional[Callable[[str], None]] = None
        #: per-sealed-segment (min_rv, max_rv, records) metadata, kept
        #: for cheap compaction coverage checks; lazily rebuilt by a
        #: scan for segments discovered on open
        self._sealed_meta: Dict[str, Tuple[int, int, int]] = {}
        # a crash mid-append leaves a partial final line; appending
        # after it would MERGE the next record into the torn debris and
        # destroy it — repair (truncate the unterminated tail) before
        # opening for append, exactly like etcd's WAL repair.  Only an
        # unterminated tail is touched: the partial frame was never
        # readable, so nothing observable changes.
        self._repair_tail()
        # resume sequence + segment numbering from what's on disk
        self._seq = self._discover_seq()
        self._seg_index = self._discover_seg_index()
        # active-file rv bounds since last rotation (coverage metadata)
        self._active_min_rv: Optional[int] = None
        self._active_max_rv: Optional[int] = None
        self._active_records = 0
        self._f = open(path, "a", encoding="utf-8")
        # arm the emergency reserve (best-effort at open: a disk that
        # is ALREADY full boots straight into degraded on first append)
        try:
            self._arm_reserve()
        except OSError as exc:
            self._count_error(exc)
            self._enter_degraded(classify_os_error(exc), str(exc))

    # ------------------------------------------------------------ discovery

    def _repair_tail(self) -> None:
        try:
            size = os.path.getsize(self.path)
        # size probe stays tolerant (no log file yet is the normal
        # first-boot case) but is classified + counted
        except OSError as exc:
            _note_os_error("repair_tail.getsize", exc)
            return
        if size == 0:
            return
        with open(self.path, "rb+") as f:
            # walk back in chunks until a newline (or the file start)
            # is found — a torn line can exceed any fixed window, and
            # truncating to 0 on a miss would destroy valid records
            end = size
            keep = 0
            while end > 0:
                back = min(end, 1 << 20)
                f.seek(end - back)
                data = f.read(back)
                if end == size and data.endswith(b"\n"):
                    return
                idx = data.rfind(b"\n")
                if idx >= 0:
                    keep = end - back + idx + 1
                    break
                end -= back
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())

    def _discover_seq(self) -> int:
        # after a compaction retired everything and the process
        # restarted, the live log may be empty while the archive holds
        # seq 1..N — restarting numbering at 1 would read as a
        # sequence gap to fsck --archive and the PITR rebuild
        candidates = list(reversed(segment_files(self.path)))
        if self.archive_dir:
            base = os.path.basename(self.path) + SEG_INFIX
            try:
                candidates += sorted(
                    (
                        os.path.join(self.archive_dir, n)
                        for n in os.listdir(self.archive_dir)
                        if n.startswith(base)
                    ),
                    reverse=True,
                )
            # a missing archive dir is normal before the first
            # compaction; counted + logged when it is anything else
            except OSError as exc:
                _note_os_error("discover_seq.listdir", exc)
        for fp in candidates:
            s = scan_files([fp])
            if s.last_seq is not None:
                return s.last_seq + 1
        return 1

    def _discover_seg_index(self) -> int:
        idx = 0
        dirs = [os.path.dirname(self.path) or "."]
        if self.archive_dir:
            dirs.append(self.archive_dir)
        base = os.path.basename(self.path) + SEG_INFIX
        for d in dirs:
            try:
                names = os.listdir(d)
            # same tolerant-but-counted posture as _discover_seq
            except OSError as exc:
                _note_os_error("discover_seg_index.listdir", exc)
                continue
            for n in names:
                if n.startswith(base):
                    try:
                        idx = max(idx, int(n[len(base):]))
                    except ValueError:
                        pass
        return idx + 1

    def set_crash_hook(self, hook: Optional[Callable[[str], None]]) -> None:
        """Install a chaos crash point inside compaction/rotation —
        the file-level twin of ``ResourceStore.set_crash_hook``
        (``kwok_tpu/cluster/store.py:634``)."""
        self._crash_hook = hook

    def _crash_point(self, phase: str) -> None:
        hook = self._crash_hook
        if hook is not None:
            hook(phase)

    # ------------------------------------------------------------ writing

    def _note_rv(self, record: Dict[str, Any]) -> None:
        rvs = []
        if record.get("t") == "txn":
            # a txn frame spans its inner events' whole rv range — the
            # segment floor must reflect the smallest, or compaction
            # bookkeeping would overstate what this file retains
            for sub in record.get("recs") or []:
                try:
                    rvs.append(int(sub.get("rv", 0)))
                except (TypeError, ValueError):
                    pass
        try:
            rvs.append(int(record.get("rv", 0)))
        except (TypeError, ValueError):
            rvs.append(0)
        lo, hi = min(rvs), max(rvs)
        if self._active_min_rv is None or lo < self._active_min_rv:
            self._active_min_rv = lo
        if self._active_max_rv is None or hi > self._active_max_rv:
            self._active_max_rv = hi
        self._active_records += 1

    def append(self, record: Dict[str, Any]) -> None:
        self.append_many([record])

    def append_many(self, records) -> None:
        """One write + one flush for a whole mutation batch (the store's
        bulk lane defers its per-op records here — per-op flushes were
        the WAL's only measurable cost at drain rates).

        Exhaustion contract: a write-path OSError (ENOSPC/EDQUOT/EIO)
        is classified and retried once on a repaired fresh handle with
        the emergency reserve released; success still enters the
        degraded state (the store stops admitting non-lease mutations
        until :meth:`try_rearm` confirms space), failure raises
        :class:`WalExhausted` so the caller can refuse the ack instead
        of pretending the record is durable."""
        if not records:
            return
        lines = []
        for r in records:
            lines.append(encode_record(self._seq, r))
            self._seq += 1
            self._note_rv(r)
        t0 = time.monotonic()
        self._write_frames(lines)
        self._maybe_rotate()
        # observation-only; a failed write raised above, so this series
        # is the latency acked writes actually paid
        _H_APPEND.observe(time.monotonic() - t0, self.shard)

    # ------------------------------------------------- exhaustion-safe I/O

    def _guard_write(self, nbytes: int) -> None:
        p = self._pressure
        if p is not None:
            p.on_write(nbytes)

    def _guard_fsync(self) -> None:
        p = self._pressure
        if p is not None:
            p.on_fsync()

    def _write_frames(self, lines: List[str]) -> None:
        data = "".join(lines)
        try:
            self._guard_write(len(data))
            self._f.write(data)
            self._f.flush()
        except OSError as exc:
            self._recover_append(exc, lines)
            return  # the recovery path flushed + fsynced what it wrote
        try:
            self._policy_fsync()
        except OSError as exc:
            # the frames are written (process-crash durable); machine-
            # crash durability of the unsynced tail is now unknown —
            # poison-handle handling, never a silent absorb
            self._on_fsync_failure(exc)

    def _policy_fsync(self) -> None:
        if self.fsync == "always":
            self._guard_fsync()
            t0 = time.monotonic()
            os.fsync(self._f.fileno())
            self._last_fsync_at = time.monotonic()
            _H_FSYNC.observe(self._last_fsync_at - t0, self.shard)
        elif self.fsync == "interval":
            now = time.monotonic()
            if now - self._last_sync >= self.fsync_interval:
                self._last_sync = now
                self._guard_fsync()
                os.fsync(self._f.fileno())
                self._last_fsync_at = time.monotonic()
                _H_FSYNC.observe(self._last_fsync_at - now, self.shard)

    def _flush(self) -> None:
        # flush python buffer -> fd: acked writes survive process death
        self._f.flush()
        self._policy_fsync()

    def sync(self) -> None:
        """Force durability now.  An fsync failure here gets the same
        fsyncgate treatment as the policy path: the handle is poisoned
        (sealed + reopened, never re-fsynced) and the log degrades —
        the written frames stay process-crash durable, and lost pages
        surface as CRC-detected corruption at recovery."""
        self._f.flush()
        t0 = time.monotonic()
        try:
            self._guard_fsync()
            os.fsync(self._f.fileno())
        except OSError as exc:
            self._on_fsync_failure(exc)
            return
        self._last_fsync_at = time.monotonic()
        _H_FSYNC.observe(self._last_fsync_at - t0, self.shard)

    # ------------------------------------------------- exhaustion handling

    def _count_error(self, exc: OSError) -> str:
        kind = classify_os_error(exc)
        if kind == "disk-full":
            self.enospc_total += 1
        elif kind == "quota":
            self.enospc_total += 1
        else:
            self.io_errors_total += 1
        return kind

    @property
    def degraded(self) -> Optional[Dict[str, Any]]:
        """None when writes are armed; else ``{"reason", "detail",
        "since"}`` (reason: disk-full | quota | fsync-error |
        io-error).  The store's read-only gate keys on this."""
        return self._degraded

    def _enter_degraded(self, reason: str, detail: str) -> None:
        if self._degraded is not None:
            return  # already degraded; keep the first cause
        self._degraded = {
            "reason": reason,
            "detail": detail,
            "since": time.monotonic(),
        }
        from kwok_tpu_torch.utils.log import get_logger

        get_logger("wal").warn(
            "entering degraded (read-only) mode", reason=reason, detail=detail
        )
        # best-effort marker record so the window is visible to offline
        # fsck and recovery tooling; rides the freed reserve headroom
        self._append_marker(
            {"t": "degraded", "rv": 0, "reason": reason}
        )

    def _append_marker(self, record: Dict[str, Any]) -> None:
        """Append a bookkeeping record outside the normal recovery
        machinery (no recursion): failure rolls the sequence number
        back after a tail repair so continuity survives."""
        seq = self._seq
        line = encode_record(seq, record)
        try:
            self._guard_write(len(line))
            self._f.write(line)
            self._f.flush()
        except OSError as exc:
            self._count_error(exc)
            # the marker (possibly a torn prefix of it) must not leave
            # debris: repair the tail and reuse its sequence number
            try:
                self._f.close()
            except OSError as close_exc:
                _note_os_error("marker.close", close_exc)
            self._repair_tail()
            self._f = open(self.path, "a", encoding="utf-8")
            return
        self._seq = seq + 1
        try:
            self._guard_fsync()
            os.fsync(self._f.fileno())
            self._last_fsync_at = time.monotonic()
        # reason: the marker is best-effort observability — an unsynced
        # marker is still process-crash durable, and failing the append
        # that triggered it over marker fsync would invert priorities
        except OSError as exc:
            self._count_error(exc)

    def note_void(self, rv: int) -> None:
        """Record that ``rv`` was allocated but its commit rolled back
        and the number cannot be reused (the sharded store's shared
        sequence had already moved past it —
        ``ResourceStore._unbump``).  Best-effort marker riding the same
        lane as the degraded/rearmed bookkeeping frames: fsck and
        recovery count a voided rv as covered instead of reporting a
        phantom lost record."""
        self._append_marker({"t": "void", "rv": int(rv)})

    def _active_tail_seq(self) -> Optional[int]:
        """Last complete frame's sequence number in the active file
        (None when it holds none) — what a failed batch write must
        resume after.  Bounded: callers run :meth:`_repair_tail` first
        (the file ends at a newline), so reading one tail window
        suffices — a full CRC scan per failed append would hammer an
        already-struggling disk under a long pressure window.  Falls
        back to the full scan only when the window holds no parseable
        frame (e.g. one oversized record)."""
        try:
            size = os.path.getsize(self.path)
        # size probe, tolerant by design (no active file yet)
        except OSError as exc:
            _note_os_error("tail_seq.getsize", exc)
            return None
        if size == 0:
            return None
        window = min(size, 256 * 1024)
        try:
            with open(self.path, "rb") as f:
                f.seek(size - window)
                data = f.read(window)
        except OSError as exc:
            _note_os_error("tail_seq.read", exc)
            return scan_files([self.path]).last_seq
        # the first split piece may be a mid-frame cut from the window
        # boundary; walk back over the complete lines
        for raw in reversed(data.split(b"\n")):
            raw = raw.strip()
            if not raw:
                continue
            try:
                seq, _rec, _legacy = _parse_frame(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue
            if seq is not None:
                return seq
        return scan_files([self.path]).last_seq

    def _recover_append(self, exc: OSError, lines: List[str]) -> None:
        """A write-path failure mid-append: classify, free the
        emergency reserve, repair the (possibly torn) tail on a fresh
        handle — fsyncgate: the old handle is never trusted again —
        and rewrite the frames that did not land.  Success means the
        in-flight records ARE durable; the log still enters degraded
        so the store stops admitting non-exempt mutations.  A second
        failure raises :class:`WalExhausted`: the caller must not ack."""
        kind = self._count_error(exc)
        self.release_reserve()
        try:
            self._f.close()
        except OSError as close_exc:
            _note_os_error("recover_append.close", close_exc)
        self._repair_tail()
        durable = self._active_tail_seq()
        # frames at seq <= durable landed whole before the failure
        remaining = []
        for line in lines:
            seq = int(line.split(" ", 1)[0])
            if durable is None or seq > durable:
                remaining.append(line)
        self._f = open(self.path, "a", encoding="utf-8")
        data = "".join(remaining)
        try:
            if data:
                self._guard_write(len(data))
                self._f.write(data)
                self._f.flush()
            self._guard_fsync()
            os.fsync(self._f.fileno())
            self._last_fsync_at = time.monotonic()
        except OSError as exc2:
            self._count_error(exc2)
            # roll the sequence back over the frames that never landed
            # BEFORE entering degraded: the degraded marker append must
            # continue the durable sequence, not straddle the hole of
            # the frames the caller is about to un-commit
            try:
                self._f.close()
            except OSError as close_exc:
                _note_os_error("recover_append.close2", close_exc)
            self._repair_tail()
            tail = self._active_tail_seq()
            if tail is not None:
                self._seq = tail + 1
            elif remaining:
                self._seq = int(remaining[0].split(" ", 1)[0])
            self._f = open(self.path, "a", encoding="utf-8")
            self._enter_degraded(kind, str(exc))
            raise WalExhausted(
                f"append not durable even via reserve: {exc2}", kind
            ) from exc2
        self._enter_degraded(kind, str(exc))

    def _on_fsync_failure(self, exc: OSError) -> None:
        """fsyncgate-correct fsync-failure handling: the kernel may
        have dropped the dirty pages AND consumed the error, so
        retrying fsync on the same fd can report success for data that
        never reached the disk.  Seal the active file whole (rename —
        no fsync on the poisoned fd, ever) and open a fresh handle; if
        the sealed tail's pages were in fact lost, recovery sees CRC
        damage and *reports* the loss — detected, never silent."""
        self.fsync_failures_total += 1
        self._count_error(exc)
        try:
            self._f.close()
        except OSError as close_exc:
            _note_os_error("fsync_failure.close", close_exc)
        if self._active_records:
            seg = f"{self.path}{SEG_INFIX}{self._seg_index:08d}"
            self._seg_index += 1
            try:
                os.replace(self.path, seg)
                _fsync_dir(self.path)
                self._sealed_meta[seg] = (
                    self._active_min_rv or 0,
                    self._active_max_rv or 0,
                    self._active_records,
                )
                self._active_min_rv = None
                self._active_max_rv = None
                self._active_records = 0
            except OSError as seal_exc:
                # rename failed too: keep appending to the same file on
                # a fresh fd; the classification below still degrades
                _note_os_error("fsync_failure.seal", seal_exc)
        self._f = open(self.path, "a", encoding="utf-8")
        self._enter_degraded("fsync-error", str(exc))

    # ------------------------------------------------------------- reserve

    def _arm_reserve(self) -> None:
        """(Re)create the preallocated emergency reserve.  Raises
        OSError when the disk cannot hold it — which is exactly the
        rearm probe's signal that space has not come back."""
        if not self.reserve_bytes:
            return
        try:
            if os.path.getsize(self._reserve_path) >= self.reserve_bytes:
                return
        # absent or unreadable reserve: (re)create below
        except OSError as exc:
            _note_os_error("arm_reserve.getsize", exc)
        self._guard_write(self.reserve_bytes)
        with open(self._reserve_path, "wb") as f:
            f.write(b"\0" * self.reserve_bytes)
            f.flush()
            self._guard_fsync()
            os.fsync(f.fileno())

    def release_reserve(self) -> int:
        """Free the emergency reserve (delete the preallocated file);
        returns the bytes released.  The pressure shim, when armed, is
        credited so simulated full disks gain the same headroom a real
        unlink frees."""
        try:
            n = os.path.getsize(self._reserve_path)
            os.unlink(self._reserve_path)
        except OSError as exc:
            _note_os_error("release_reserve", exc)
            return 0
        p = self._pressure
        if p is not None:
            p.freed(n)
        return n

    # --------------------------------------------------------------- rearm

    def set_pressure(self, shim) -> None:
        """Install/remove (None) the duck-typed filesystem-pressure
        shim consulted before this log's own write/fsync syscalls
        (chaos/fs_pressure.py; the DST harness toggles it at virtual
        instants)."""
        self._pressure = shim

    def maybe_rearm(self, min_interval: float = 0.5) -> bool:
        """Throttled rearm probe — cheap enough to sit behind every
        rejected mutation and readiness poll.  Returns True when
        writes are (now) armed."""
        if self._degraded is None:
            return True
        now = time.monotonic()
        if now - self._last_rearm_probe < min_interval:
            return False
        self._last_rearm_probe = now
        return self.try_rearm()

    def try_rearm(self) -> bool:
        """Attempt to leave degraded mode: re-arm the emergency
        reserve and prove the active handle can fsync.  Both must
        succeed — a probe that passes on leftovers of the freed
        reserve would re-arm writes onto a still-full disk."""
        if self._degraded is None:
            return True
        try:
            self._arm_reserve()
            self._f.flush()
            self._guard_fsync()
            os.fsync(self._f.fileno())
            self._last_fsync_at = time.monotonic()
        except OSError as exc:
            self._count_error(exc)
            return False
        reason = self._degraded.get("reason", "")
        self._degraded = None
        self.rearms_total += 1
        from kwok_tpu_torch.utils.log import get_logger

        get_logger("wal").info(
            "storage re-armed: leaving degraded mode", was=reason
        )
        self._append_marker({"t": "rearmed", "rv": 0, "was": reason})
        return True

    # ------------------------------------------------------------- segments

    def _maybe_rotate(self) -> None:
        if self.segment_bytes and self._f.tell() >= self.segment_bytes:
            try:
                self._rotate()
            except OSError as exc:
                # rotation's pre-seal fsync failed: poison-handle
                # handling seals what it can; the appended frames are
                # already written, so the append itself still holds
                self._on_fsync_failure(exc)

    def _rotate(self) -> None:
        """Seal the active file into a read-only segment and start a
        fresh one.  Sealed data is fsynced before the rename and the
        directory entry after it, so the segment either exists whole or
        the records are still in the active file — never neither."""
        if self._active_records == 0:
            return
        self._f.flush()
        self._guard_fsync()
        os.fsync(self._f.fileno())
        self._last_fsync_at = time.monotonic()
        self._f.close()
        seg = f"{self.path}{SEG_INFIX}{self._seg_index:08d}"
        self._seg_index += 1
        os.replace(self.path, seg)
        _fsync_dir(self.path)
        self._sealed_meta[seg] = (
            self._active_min_rv or 0,
            self._active_max_rv or 0,
            self._active_records,
        )
        self._active_min_rv = None
        self._active_max_rv = None
        self._active_records = 0
        self._f = open(self.path, "a", encoding="utf-8")

    def _seg_meta(self, seg: str) -> Tuple[int, int, int]:
        meta = self._sealed_meta.get(seg)
        if meta is None:
            s = scan_files([seg])
            rvs: List[int] = []
            for rec in s.records:
                try:
                    rvs.append(int(rec.get("rv", 0)))
                except (TypeError, ValueError):
                    rvs.append(0)
            if s.corruptions:
                # a damaged segment is never "covered": keep it live so
                # boot recovery sees (and reports) it
                meta = (0, 2**63, len(s.records))
            else:
                meta = (
                    min(rvs) if rvs else 0,
                    max(rvs) if rvs else 0,
                    len(s.records),
                )
            self._sealed_meta[seg] = meta
        return meta

    # ---------------------------------------------------------- lifecycle

    def compact(self, upto_rv: int) -> int:
        """Retire sealed segments a snapshot at ``upto_rv`` fully
        covers (archive or delete them); returns an upper bound on the
        live records remaining above ``upto_rv`` (straddling segments
        are counted whole, not re-read).

        Unlike the first-generation rewrite-in-place compaction, no
        record bytes are ever rewritten: the active file is sealed,
        covered segments are renamed whole (into the archive) or
        unlinked, and straddling segments stay live — replay filters by
        rv anyway.  Every step is atomic-rename + directory fsync, so a
        crash at any :meth:`set_crash_hook` phase leaves the union of
        snapshot + live log complete."""
        self._crash_point("compact-begin")
        try:
            self._f.flush()
            self._guard_fsync()
            os.fsync(self._f.fileno())
            self._last_fsync_at = time.monotonic()
            if self._active_records:
                self._rotate()
        except OSError as exc:
            # a failing disk mid-compaction: poison-handle handling,
            # then skip this tick — compaction is optional work and the
            # un-retired segments stay covered by the snapshot
            self._on_fsync_failure(exc)
            return 0
        self._crash_point("compact-sealed")
        remaining = 0
        for seg in segment_files(self.path):
            if seg == self.path:
                continue
            _min_rv, max_rv, records = self._seg_meta(seg)
            if max_rv <= upto_rv:
                self._archive_segment(seg)
                self._crash_point("compact-mid-archive")
            else:
                # straddling segment stays live; the cached record
                # count is an upper bound (it includes snapshot-covered
                # records) — an exact count would mean re-reading and
                # CRC-verifying the segment under the store mutex on
                # every save tick, and no caller needs the precision
                remaining += records
        self._crash_point("compact-done")
        return remaining

    def _archive_segment(self, seg: str) -> None:
        self._sealed_meta.pop(seg, None)
        if self.archive_dir:
            os.makedirs(self.archive_dir, exist_ok=True)
            dst = os.path.join(self.archive_dir, os.path.basename(seg))
            os.replace(seg, dst)
            _fsync_dir(dst)
        else:
            os.unlink(seg)
        _fsync_dir(seg)

    def reset(self) -> None:
        """Start a fresh empty log (the coverage was superseded
        wholesale, e.g. by a state restore).  The active tail is sealed
        and EVERY segment is archived first (or deleted when no archive
        is configured): pre-restore history may still serve
        point-in-time restores, and the archive's sequence continuity
        must survive the reset — truncating the active file here used
        to silently drop its unarchived records from the PITR history."""
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        # classified + counted: reset() proceeds regardless (the log is
        # being superseded wholesale), but an EIO here must be visible
        except OSError as exc:
            self._count_error(exc)
            _note_os_error("reset.fsync", exc)
        self._f.close()
        try:
            size = os.path.getsize(self.path)
        # size probe, tolerant by design (empty/new log)
        except OSError as exc:
            _note_os_error("reset.getsize", exc)
            size = 0
        if size:
            seg = f"{self.path}{SEG_INFIX}{self._seg_index:08d}"
            self._seg_index += 1
            os.replace(self.path, seg)
            _fsync_dir(self.path)
        for seg in segment_files(self.path):
            if seg != self.path:
                self._archive_segment(seg)
        self._active_min_rv = None
        self._active_max_rv = None
        self._active_records = 0
        self._f = open(self.path, "w", encoding="utf-8")

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        # best-effort teardown, but classified + counted — a close-time
        # ENOSPC is the same signal the append path surfaces loudly
        except OSError as exc:
            self._count_error(exc)
            _note_os_error("close", exc)

    # -------------------------------------------------------------- health

    def health(self) -> Dict[str, Any]:
        """Liveness surface for /metrics and ``kwokctl get
        components``: segment count, live bytes, last-fsync age."""
        files = segment_files(self.path)
        total = 0
        for fp in files:
            try:
                total += os.path.getsize(fp)
            # size probe over a file compaction may have just retired;
            # tolerant but counted
            except OSError as exc:
                _note_os_error("health.getsize", exc)
        age = (
            None
            if self._last_fsync_at is None
            else max(0.0, time.monotonic() - self._last_fsync_at)
        )
        deg = self._degraded
        out = {
            "segments": len(files),
            "bytes": total,
            "last_fsync_age_s": age,
            "next_seq": self._seq,
            "enospc_total": self.enospc_total,
            "fsync_failures_total": self.fsync_failures_total,
            "io_errors_total": self.io_errors_total,
            "rearms_total": self.rearms_total,
            "reserve_armed": os.path.exists(self._reserve_path),
            "degraded": None,
        }
        if deg is not None:
            out["degraded"] = {
                "reason": deg["reason"],
                "detail": deg["detail"],
                "for_s": max(0.0, time.monotonic() - deg["since"]),
            }
        return out

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -------------------------------------------------------------------- fsck


def fsck(
    path: str,
    snapshot: Optional[str] = None,
    archive: Optional[str] = None,
    rv_continuity: bool = True,
) -> Dict[str, Any]:
    """Offline integrity check of the live log at ``path`` (plus,
    optionally, the snapshot it compacts behind and the archive dir).

    Checks: frame integrity (CRC + parse), sequence continuity, rv
    continuity against the snapshot floor (every resourceVersion in
    ``(snapshot_rv, max_rv]`` must be present exactly once — missing
    rvs are lost records), and the compaction floor (the live log must
    reach down to the snapshot's rv, or records were retired without
    snapshot coverage).  Returns the JSON-able report; ``report["ok"]``
    is the exit-status verdict (a torn tail alone is normal crash
    debris, reported but not fatal).

    ``rv_continuity=False`` skips the missing-rv computation for this
    log alone and instead exposes the observed rv set under the
    private ``"_observed"`` key — one shard of a sharded store holds a
    deliberately sparse slice of the cluster-wide rv sequence, and
    continuity only holds over the union (:func:`fsck_sharded`)."""
    files = segment_files(path)
    if archive:
        base = os.path.basename(path) + SEG_INFIX
        try:
            arch = sorted(
                os.path.join(archive, n)
                for n in os.listdir(archive)
                if n.startswith(base)
            )
        # tolerant: fsck of a log without an archive yet; counted
        except OSError as exc:
            _note_os_error("fsck.archive_listdir", exc)
            arch = []
        files = arch + files
    s = scan_files(files)
    observed: set = set()
    max_rv = 0
    min_rv: Optional[int] = None
    markers = 0
    for rec in s.records:
        if rec.get("t") in ("degraded", "rearmed"):
            # exhaustion bookkeeping frames: visible in the report so
            # an operator can see the pressure windows offline
            markers += 1
            continue
        try:
            rv = int(rec.get("rv", 0) or 0)
        except (TypeError, ValueError):
            continue
        if rec.get("t") == "void":
            # allocated-then-rolled-back rv (sharded undo path): the
            # number was never a commit — covered, not missing
            markers += 1
            observed.add(rv)
            continue
        for irv in record_rvs(rec):
            observed.add(irv)
            max_rv = max(max_rv, irv)
            min_rv = irv if min_rv is None else min(min_rv, irv)
    snap_rv: Optional[int] = None
    snap_error: Optional[str] = None
    if snapshot:
        try:
            snap_rv = int(read_state_file(snapshot).get("resourceVersion", 0))
        except (OSError, SnapshotCorruption, TypeError, ValueError) as exc:
            snap_error = str(exc)
    # archived snapshots also establish a retention floor: pruning
    # deletes segments the oldest KEPT snapshot covers, and record
    # interleaving (bulk-lane deferral) means the surviving files'
    # min rv does not bound what pruning legitimately dropped — rvs
    # below the newest verifiable snapshot are covered, not missing
    archive_snap_rv: Optional[int] = None
    if archive:
        try:
            snaps = sorted(
                n for n in os.listdir(archive)
                if n.startswith("snap-") and n.endswith(".json")
            )
        # tolerant twin of the segment listing above; counted
        except OSError as exc:
            _note_os_error("fsck.snap_listdir", exc)
            snaps = []
        for n in reversed(snaps):
            try:
                archive_snap_rv = int(
                    read_state_file(os.path.join(archive, n)).get(
                        "resourceVersion", 0
                    )
                )
                break
            except (OSError, SnapshotCorruption, TypeError, ValueError) as exc:
                # walking back past an unreadable/corrupt snapshot to
                # an older verifiable one IS the fallback; OS-level
                # failures are still counted on the way past
                if isinstance(exc, OSError):
                    _note_os_error("fsck.snap_read", exc)
                continue
    floors = [f for f in (snap_rv, archive_snap_rv) if f is not None]
    floor = max(floors) if floors else (min_rv - 1 if min_rv else 0)
    missing = (
        sorted(
            rv
            for rv in range(floor + 1, max_rv + 1)
            if rv not in observed
        )
        if rv_continuity and max_rv > floor
        else []
    )
    floor_gap = (
        snap_rv is not None
        and min_rv is not None
        and min_rv > snap_rv + 1
        and bool(missing)
    )
    report = {
        "path": path,
        "files": s.files,
        "records": len(s.records),
        "legacy_frames": s.legacy,
        "exhaustion_markers": markers,
        "torn_tail": s.torn_tail,
        "corruptions": s.corruptions,
        "snapshot_rv": snap_rv,
        "archive_snapshot_rv": archive_snap_rv,
        "floor": floor,
        "snapshot_error": snap_error,
        "min_rv": min_rv,
        "max_rv": max_rv,
        "missing_rvs": missing[:100],
        "missing_rv_count": len(missing),
        "compaction_floor_gap": bool(floor_gap),
        "ok": not s.corruptions
        and not missing
        and snap_error is None,
    }
    if not rv_continuity:
        report["_observed"] = observed
    return report


def fsck_sharded(workdir: str) -> Dict[str, Any]:
    """Offline integrity check of a sharded store workdir in one
    invocation: shard 0 lives at the workdir root (the single-store
    layout, byte-compatible), shards 1..N-1 under ``shards/NN/``
    (``kwok_tpu/cluster/sharding/layout.py`` is the canonical layout
    helper; the directory convention is matched structurally here so
    this module stays below the sharding layer).

    Per shard: frame integrity, sequence continuity, and the
    compaction floor against that shard's own snapshot.  Globally: rv
    continuity over the UNION of the shards' observed rvs — each shard
    holds a sparse slice of the one cluster-wide rv sequence, so only
    the union is contiguous.  ``report["ok"]`` fails if ANY shard is
    damaged or the union has holes."""
    shard_dirs = [workdir]
    shards_root = os.path.join(workdir, "shards")
    try:
        names = sorted(os.listdir(shards_root))
    except OSError as exc:
        _note_os_error("fsck_sharded.listdir", exc)
        names = []
    for n in names:
        d = os.path.join(shards_root, n)
        if os.path.isdir(d):
            shard_dirs.append(d)
    per_shard: List[Dict[str, Any]] = []
    union: set = set()
    gmax = 0
    floors: List[int] = []
    all_ok = True
    for d in shard_dirs:
        wal_p = os.path.join(d, "wal.jsonl")
        snap_p = os.path.join(d, "state.json")
        pitr_p = os.path.join(d, "pitr")
        rep = fsck(
            wal_p,
            snapshot=snap_p if os.path.exists(snap_p) else None,
            archive=pitr_p if os.path.isdir(pitr_p) else None,
            rv_continuity=False,
        )
        union |= rep.pop("_observed")
        gmax = max(gmax, rep["max_rv"] or 0)
        floors.append(rep["floor"] or 0)
        all_ok = all_ok and rep["ok"]
        per_shard.append(rep)
    # the daemon saves every shard against ONE captured horizon, so
    # the per-shard snapshot floors agree and max() is exact.  When a
    # skipped save tick skews them, the union check covers only
    # (max, gmax] — a lower-floor shard's records in (its floor, max]
    # are vouched for by its OWN scan instead (seq continuity + frame
    # verification over its full retained log, reported per shard
    # above); min() here would instead read higher-floor shards'
    # snapshot-covered, legitimately-pruned rvs as losses
    floor = max(floors) if floors else 0
    missing = sorted(
        rv for rv in range(floor + 1, gmax + 1) if rv not in union
    )
    return {
        "workdir": workdir,
        "shards": len(shard_dirs),
        "per_shard": per_shard,
        "floor": floor,
        "max_rv": gmax,
        "missing_rvs": missing[:100],
        "missing_rv_count": len(missing),
        "ok": all_ok and not missing,
    }


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m kwok_tpu_torch.cluster.wal",
        description="Offline WAL verifier (frame integrity, sequence/rv "
        "continuity, compaction floor vs snapshot).  PATH may be a WAL "
        "file, or a (possibly sharded) cluster workdir — every shard's "
        "frames, sequence continuity and compaction floor are then "
        "verified in one invocation, with rv continuity checked over "
        "the union of the shards.",
    )
    p.add_argument(
        "--fsck",
        metavar="PATH",
        required=True,
        help="live WAL path, or a cluster workdir (sharded or not)",
    )
    p.add_argument(
        "--snapshot", default="", help="state file the log compacts behind"
    )
    p.add_argument(
        "--archive", default="", help="PITR archive dir holding retired segments"
    )
    args = p.parse_args(argv)
    if os.path.isdir(args.fsck):
        if args.snapshot or args.archive:
            # a workdir walk discovers each shard's snapshot/archive by
            # layout convention — honoring ONE explicit path across N
            # shards is ill-defined, and silently ignoring it would
            # hand out an "ok" verdict that never inspected the named
            # file
            p.error(
                "--snapshot/--archive only apply to a single WAL file; "
                "a workdir fsck discovers every shard's snapshot and "
                "PITR archive from the workdir layout"
            )
        report = fsck_sharded(args.fsck)
    else:
        report = fsck(
            args.fsck,
            snapshot=args.snapshot or None,
            archive=args.archive or None,
        )
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
