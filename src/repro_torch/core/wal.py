"""Write-ahead journal for the streaming TCQ service (durability tier;
PyTorch port of ``repro.core.wal``, host-side and byte-compatible with it:
the same record framing, CRC, segment header and snapshot layout, so a
journal directory written by either package recovers in the other).

Snapshots alone lose everything between two ``save_snapshot`` calls —
every ingested edge batch, every admitted or cancelled ticket — and a
snapshot written in place can be corrupted by a crash *mid-save*.  This
module closes that gap with the standard database recipe, adapted to the
service's epoch-pinned snapshot model:

* **Append-only segments of checksummed records.**  Every mutation the
  service accepts (``add_edges`` batch, ticket admission, cancellation,
  external snapshot install) is encoded as one length-prefixed record —
  ``u32 payload_len | u32 crc32(payload) | payload`` — and appended to
  the active segment *before* the mutation is applied (write-ahead: a
  mutation is durable iff its record is).  Payloads are self-describing
  (JSON meta + raw little-endian array bytes), pickle-free.

* **Torn-tail tolerance.**  A crash can leave a half-written record at
  the tail (or bit rot can corrupt an older one).  Recovery verifies
  every record's CRC and *cuts* the log at the first bad record: the
  event is reported (``tail_events``), the surviving prefix is replayed,
  and the bad bytes are physically truncated so they can never be
  misread later.  A torn record is an operation that was never
  acknowledged — cutting it is correct, replaying garbage is not.

* **Segment rotation keyed to snapshot points.**  Segments and snapshots
  share one monotonically increasing sequence number.  A checkpoint
  seals the active segment (``rotate``), writes the snapshot under the
  *new* segment's sequence number, and garbage-collects segments older
  than the oldest retained snapshot.  Recovery therefore loads the
  newest valid snapshot ``snapshot-S`` and replays exactly the segments
  with ``seq >= S`` — the WAL tail.

* **fsync policy.**  ``always`` fsyncs every append (no acknowledged
  record can be lost to an OS crash), ``batch`` fsyncs on an explicit
  ``sync()`` / rotation (the service syncs at pump boundaries — bounded
  loss on power failure, cheap in the common case), ``off`` leaves
  flushing to the OS (process crashes still lose nothing, because the
  stream position is flushed; only a machine crash can).

The service-side half — journal hooks in ``submit``/``push_edges``/
``cancel``, atomic checkpoints, and ``TCQService.recover`` — lives in
``core/service.py``; this module knows nothing about tickets beyond
bytes.  Crash-point and torn-write *injection* lives in
``core/faultinject.py`` (``CrashingWAL``); the kill-anywhere drill that
gates bit-identical recovery at every injected point is
``tests/test_torch_wal.py``.

* **On a mesh of several ranks** (``MeshJournal``) every rank runs the
  service's host control, and rank 0 alone writes: the journal, every
  snapshot and the genesis snapshot.  The other ranks follow, writing
  nothing; whatever rank 0 learns from its files (an append's outcome,
  the snapshots on disk, a recovery's records) reaches them by a
  broadcast, so every rank takes the same path and ranks on other hosts
  need no shared file system (``tests/test_torch_wal_mesh.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import struct
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

SEGMENT_MAGIC = b"TWAL"
SEGMENT_VERSION = 1
_SEG_HEADER = struct.Struct("<4sI")      # magic, version
_REC_HEADER = struct.Struct("<II")       # payload_len, crc32(payload)
_SEG_RE = re.compile(r"^wal-(\d{8})\.log$")
_SNAP_RE = re.compile(r"^snapshot-(\d{8})\.npz$")

FSYNC_POLICIES = ("always", "batch", "off")


class WALError(RuntimeError):
    """Unrecoverable WAL structure problem (bad header, unknown policy)."""


class WALReplayError(WALError):
    """A replayed record did not reproduce the state it promised
    (lineage fingerprint mismatch, id collision) — the log and the
    replay path disagree, which must fail loudly, never sort-of-recover."""


@dataclasses.dataclass(frozen=True)
class WALRecord:
    """One decoded journal record: a kind tag, JSON-able metadata, and
    named numpy arrays (dtype/shape round-trip exactly)."""

    kind: str
    meta: Dict
    arrays: Dict[str, np.ndarray]


def encode_record(kind: str, meta: Optional[Dict] = None,
                  arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Frame one record: header JSON (kind, meta, array specs) + raw
    array bytes, length-prefixed and CRC32-checksummed."""
    metas = dict(meta or {})
    specs = []
    blobs = []
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        # canonical little-endian byte order: segments written on one
        # host must replay on any other
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        specs.append([name, a.dtype.str, list(a.shape)])
        blobs.append(a.tobytes())
    head = json.dumps({"kind": kind, "meta": metas, "arrays": specs},
                      sort_keys=True).encode()
    payload = struct.pack("<I", len(head)) + head + b"".join(blobs)
    return _REC_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> WALRecord:
    (head_len,) = struct.unpack_from("<I", payload, 0)
    head = json.loads(payload[4:4 + head_len].decode())
    arrays: Dict[str, np.ndarray] = {}
    off = 4 + head_len
    for name, dtype, shape in head["arrays"]:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        arrays[name] = np.frombuffer(
            payload[off:off + n], dtype=dt).reshape(shape).copy()
        off += n
    return WALRecord(head["kind"], head["meta"], arrays)


def segment_path(wal_dir: str, seq: int) -> str:
    return os.path.join(wal_dir, f"wal-{int(seq):08d}.log")


def snapshot_path(wal_dir: str, seq: int) -> str:
    return os.path.join(wal_dir, f"snapshot-{int(seq):08d}.npz")


def list_segments(wal_dir: str) -> List[Tuple[int, str]]:
    """(seq, path) for every segment file, ascending ([] if the
    directory does not exist yet)."""
    if not os.path.isdir(wal_dir):
        return []
    out = []
    for name in os.listdir(wal_dir):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(wal_dir, name)))
    return sorted(out)


def list_snapshots(wal_dir: str) -> List[Tuple[int, str]]:
    """(seq, path) for every snapshot file, ascending ([] if the
    directory does not exist yet)."""
    if not os.path.isdir(wal_dir):
        return []
    out = []
    for name in os.listdir(wal_dir):
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(wal_dir, name)))
    return sorted(out)


def read_segment(path: str) -> Tuple[List[WALRecord], Optional[Dict], int]:
    """Decode one segment: ``(records, tail_event, valid_bytes)``.

    ``tail_event`` is None for a clean segment, else a dict describing
    the first bad record (``reason`` in {"torn", "corrupt", "bad_header"})
    — everything at and after it is excluded from ``records``.
    ``valid_bytes`` is the offset of the last byte that parsed cleanly
    (the truncation point for :func:`cut_segment`).
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _SEG_HEADER.size:
        return [], {"reason": "bad_header", "offset": 0,
                    "detail": f"{len(data)} bytes, no segment header"}, 0
    magic, version = _SEG_HEADER.unpack_from(data, 0)
    if magic != SEGMENT_MAGIC or version != SEGMENT_VERSION:
        return [], {"reason": "bad_header", "offset": 0,
                    "detail": f"magic={magic!r} version={version}"}, 0
    records: List[WALRecord] = []
    off = _SEG_HEADER.size
    while off < len(data):
        if off + _REC_HEADER.size > len(data):
            return records, {"reason": "torn", "offset": off,
                             "detail": "partial record header"}, off
        length, crc = _REC_HEADER.unpack_from(data, off)
        start = off + _REC_HEADER.size
        payload = data[start:start + length]
        if len(payload) < length:
            return records, {
                "reason": "torn", "offset": off,
                "detail": f"record wants {length} payload bytes, "
                          f"{len(payload)} on disk"}, off
        if zlib.crc32(payload) != crc:
            return records, {"reason": "corrupt", "offset": off,
                             "detail": "payload CRC mismatch"}, off
        try:
            records.append(decode_payload(payload))
        except Exception as e:   # undecodable but CRC-clean: still cut
            return records, {"reason": "corrupt", "offset": off,
                             "detail": f"payload decode failed: {e!r}"}, off
        off = start + length
    return records, None, off


def cut_segment(path: str, valid_bytes: int) -> None:
    """Physically truncate a segment at its last valid record so the bad
    tail can never be re-read (recovery calls this after logging it)."""
    with open(path, "r+b") as f:
        f.truncate(max(int(valid_bytes), 0))
        f.flush()
        os.fsync(f.fileno())


class WriteAheadLog:
    """Append-only, segment-rotated, CRC-checked journal in one
    directory.

    Opening a directory always starts a *new* active segment at
    ``max(existing seq) + 1`` — existing segments are never appended to,
    so a recovering process can replay them while its own journal is
    already live, and a half-written tail from the previous life never
    shares a file with fresh records.
    """

    def __init__(self, wal_dir: str, *, fsync: str = "batch"):
        if fsync not in FSYNC_POLICIES:
            raise WALError(
                f"unknown fsync policy {fsync!r}: expected one of "
                f"{FSYNC_POLICIES}")
        self.dir = str(wal_dir)
        self.fsync = fsync
        os.makedirs(self.dir, exist_ok=True)
        self.records_appended = 0
        self.bytes_appended = 0
        self.syncs = 0
        self.tail_events: List[Dict] = []
        taken = [s for s, _ in list_segments(self.dir)]
        taken += [s for s, _ in list_snapshots(self.dir)]
        self._seq = (max(taken) + 1) if taken else 0
        self._file = None
        self._open_segment()

    # ------------------------------------------------------------- writing
    def _open_segment(self) -> None:
        self._file = open(segment_path(self.dir, self._seq), "xb")
        self._file.write(_SEG_HEADER.pack(SEGMENT_MAGIC, SEGMENT_VERSION))
        self._file.flush()
        if self.fsync != "off":
            os.fsync(self._file.fileno())

    @property
    def active_seq(self) -> int:
        return self._seq

    @property
    def active_path(self) -> str:
        return segment_path(self.dir, self._seq)

    def append(self, kind: str, meta: Optional[Dict] = None,
               arrays: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Append one record; returns its 0-based index within this
        WAL's lifetime.  Under ``fsync='always'`` the record is on disk
        when this returns; under ``batch``/``off`` it is in the OS page
        cache (flushed, so a *process* crash loses nothing)."""
        if self._file is None:
            raise WALError("append on a closed WAL")
        rec = encode_record(kind, meta, arrays)
        self._file.write(rec)
        self._file.flush()
        if self.fsync == "always":
            os.fsync(self._file.fileno())
            self.syncs += 1
        idx = self.records_appended
        self.records_appended += 1
        self.bytes_appended += len(rec)
        return idx

    def sync(self) -> None:
        """Batch-policy barrier: fsync the active segment (no-op under
        ``off``; redundant under ``always``)."""
        if self._file is not None and self.fsync == "batch":
            os.fsync(self._file.fileno())
            self.syncs += 1

    def rotate(self) -> int:
        """Seal the active segment and open the next one; returns the new
        segment's sequence number (the checkpoint key)."""
        f, self._file = self._file, None
        if f is not None:
            f.flush()
            if self.fsync != "off":
                os.fsync(f.fileno())
            f.close()
        self._seq += 1
        self._open_segment()
        return self._seq

    def close(self) -> None:
        f, self._file = self._file, None
        if f is not None:
            f.flush()
            if self.fsync != "off":
                os.fsync(f.fileno())
            f.close()

    # ------------------------------------------------------------- reading
    def replay(self, from_seq: int) -> Iterator[WALRecord]:
        """Yield every record of every *sealed* segment with
        ``seq >= from_seq``, in order, cutting at the first torn or
        corrupted record (logged in ``tail_events``, physically
        truncated).  Records after a cut are never yielded — replay
        order must match append order, and a gap breaks that promise."""
        self.tail_events = []
        for seq, path in list_segments(self.dir):
            if seq < int(from_seq) or seq >= self._seq:
                continue        # pre-snapshot history / our own segment
            records, bad, valid = read_segment(path)
            if bad is not None:
                self.tail_events.append(
                    {"segment": seq, "records_kept": len(records), **bad})
                cut_segment(path, valid)
            yield from records
            if bad is not None:
                return

    # ----------------------------------------------------------------- GC
    def gc(self, keep_from_seq: int) -> List[str]:
        """Delete sealed segments and snapshots with ``seq <
        keep_from_seq`` plus stray ``*.tmp`` files (interrupted atomic
        snapshot writes); returns the removed paths."""
        removed = []
        for seq, path in list_segments(self.dir):
            if seq < int(keep_from_seq) and seq != self._seq:
                os.remove(path)
                removed.append(path)
        for seq, path in list_snapshots(self.dir):
            if seq < int(keep_from_seq):
                os.remove(path)
                removed.append(path)
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                os.remove(path)
                removed.append(path)
        return removed

    def stats(self) -> Dict:
        return {
            "dir": self.dir,
            "fsync": self.fsync,
            "active_seq": self._seq,
            "records_appended": self.records_appended,
            "bytes_appended": self.bytes_appended,
            "syncs": self.syncs,
            "segments": len(list_segments(self.dir)),
            "snapshots": len(list_snapshots(self.dir)),
        }


# --------------------------------------------------------- atomic snapshots
def snapshot_checksum(meta: Dict, arrays: Dict[str, np.ndarray]) -> int:
    """Deterministic whole-snapshot checksum: CRC32 over the canonical
    meta JSON (checksum field excluded) and every array's name + raw
    little-endian bytes, in sorted key order."""
    clean = {k: v for k, v in meta.items() if k != "checksum"}
    c = zlib.crc32(json.dumps(clean, sort_keys=True).encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        c = zlib.crc32(name.encode(), c)
        c = zlib.crc32(a.tobytes(), c)
    return c


def write_snapshot_atomic(path_or_file, meta: Dict,
                          arrays: Dict[str, np.ndarray]) -> None:
    """Persist one snapshot as ``.npz`` with the whole-file checksum
    embedded in the meta record.  File-path targets are written to a
    sibling ``.tmp`` and ``os.replace``d — a crash mid-write leaves the
    previous snapshot untouched and at worst a stray tmp (GC'd)."""
    meta = dict(meta)
    meta["checksum"] = snapshot_checksum(meta, arrays)
    blob = np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                         dtype=np.uint8)
    if isinstance(path_or_file, (str, os.PathLike)):
        path = os.fspath(path_or_file)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=blob, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the directory so the rename itself survives power loss
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:        # pragma: no cover - exotic filesystems
            pass
    else:
        np.savez(path_or_file, meta=blob, **arrays)


class SnapshotCorruption(WALError):
    """A snapshot file failed its checksum or could not be parsed —
    recovery falls back to the previous retained snapshot."""


def read_snapshot(path_or_file) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Inverse of :func:`write_snapshot_atomic`; verifies the embedded
    checksum (when present — pre-durability snapshots lack it) and
    raises :class:`SnapshotCorruption` on any mismatch or parse error."""
    try:
        with np.load(path_or_file, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            arrays = {k: z[k] for k in z.files if k != "meta"}
    except SnapshotCorruption:
        raise
    except Exception as e:
        raise SnapshotCorruption(f"unreadable snapshot: {e!r}") from e
    want = meta.get("checksum")
    if want is not None and snapshot_checksum(meta, arrays) != int(want):
        raise SnapshotCorruption("snapshot checksum mismatch")
    return meta, arrays


# ------------------------------------------------------- on a mesh of ranks
def share(mesh, fn: Callable):
    """``fn()`` run on rank 0 of ``mesh`` and its value on every rank (a
    broadcast from rank 0); off a mesh, or on a mesh of one rank, just
    ``fn()``.  An exception ``fn`` raises is raised on every rank: the
    same exception on rank 0, a copy of it on the others (a
    :class:`WALError` naming it when it does not pickle), so that no rank
    carries on alone into a collective the others never reach."""
    if mesh is None or mesh.size == 1:
        return fn()
    import torch.distributed as dist

    box, err = [None], None
    if mesh.rank == 0:
        try:
            box = [(True, fn())]
        except BaseException as e:      # re-raised below, on every rank:
            err = e                     # a drill's kill included
            try:
                pickle.dumps(e)
                box = [(False, e)]
            except Exception:
                box = [(False, WALError(f"rank 0 failed: {e!r}"))]
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if ok:
        return value
    raise err if err is not None else value


class MeshJournal:
    """The write-ahead journal of a ``TCQService`` on a mesh of several
    ranks: rank 0 holds the :class:`WriteAheadLog` (``log``) and the
    other ranks follow it, writing nothing.

    Every rank calls the journal at the same points (each rank runs the
    service's host control); each call that touches the log runs on rank
    0 and is broadcast with the log's ``stats()`` (:func:`share`), so
    every rank returns rank 0's value, raises rank 0's failure, and holds
    the same ``active_seq`` and counters.  The service writes snapshots
    through :meth:`share` too.
    """

    def __init__(self, mesh, log, stats: Dict):
        self.mesh = mesh
        self.log = log                  # None on every rank but 0
        self._stats = stats
        self.dir = stats["dir"]         # rank 0's directory
        self.fsync = stats["fsync"]
        self.tail_events: List[Dict] = []

    @classmethod
    def attach(cls, mesh, *, wal=None, wal_dir: Optional[str] = None,
               fsync: str = "batch") -> Optional["MeshJournal"]:
        """The mesh's journal, or None when rank 0 keeps none.  Rank 0
        opens ``wal`` (a log instance, rank 0's alone) or ``wal_dir``;
        the other ranks follow whatever rank 0 opened (their ``wal_dir``
        is not touched)."""
        if mesh.rank != 0 and wal is not None:
            raise ValueError("on a mesh of several ranks only rank 0 "
                             "writes the journal: pass wal= on rank 0 "
                             "alone")
        log = None
        if mesh.rank == 0 and (wal is not None or wal_dir is not None):
            log = wal if wal is not None else WriteAheadLog(wal_dir,
                                                            fsync=fsync)
        stats = share(mesh, lambda: None if log is None else log.stats())
        if stats is None:
            if wal_dir is not None:
                raise ValueError(f"rank {mesh.rank} was given a journal "
                                 f"({wal_dir!r}) and rank 0 keeps none")
            return None
        return cls(mesh, log, stats)

    def share(self, fn: Callable, *, barrier: bool = False):
        """``fn(log)`` on rank 0, its value on every rank; every rank's
        counters become rank 0's.  ``barrier``: every rank waits for all
        the others before it returns."""
        value, self._stats = share(self.mesh,
                                   lambda: (fn(self.log), self.log.stats()))
        if barrier:
            import torch.distributed as dist

            dist.barrier()
        return value

    @property
    def active_seq(self) -> int:
        return self._stats["active_seq"]

    def append(self, kind: str, meta: Optional[Dict] = None,
               arrays: Optional[Dict[str, np.ndarray]] = None) -> int:
        return self.share(lambda log: log.append(kind, meta, arrays))

    def sync(self) -> None:
        self.share(lambda log: log.sync())

    def rotate(self) -> int:
        return self.share(lambda log: log.rotate())

    def replay(self, from_seq: int) -> List[WALRecord]:
        """Rank 0's records from ``from_seq`` on (its torn tail cut, as
        :meth:`WriteAheadLog.replay`), and its ``tail_events``, on every
        rank."""
        records, self.tail_events = self.share(
            lambda log: (list(log.replay(from_seq)), log.tail_events))
        return records

    def close(self) -> None:
        if self.log is not None:
            self.log.close()

    def stats(self) -> Dict:
        """Rank 0's journal stats as of the last call, on every rank."""
        return dict(self._stats)
