"""The port's write-ahead journal and crash recovery against the JAX
package's.

The cases of tests/test_wal.py run on the port (``device="cpu"``), with
the JAX service's fault-free drain of the same tape as the reference
every recovery is held to.  The journal format is shared: the two
packages encode records to the same bytes, and a journal directory
written by either service recovers in the other to the same drains.
"""

import io
import os
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import wal as jwal  # noqa: E402
from repro.graphs import powerlaw_temporal  # noqa: E402
from repro_torch.core import wal as walmod  # noqa: E402
from repro_torch.core.faultinject import (CrashingWAL,  # noqa: E402
                                          InjectedCrash, corrupt_snapshot,
                                          flip_tail_byte, torn_tail)


# ------------------------------------------------------------ primitives
def test_record_roundtrip():
    arrays = {"u": np.arange(5, dtype=np.int64),
              "w": np.linspace(0, 1, 3, dtype=np.float32)}
    payload = walmod.encode_record("edges", {"epoch": 3}, arrays)
    # byte-compatible with the JAX package's framing
    assert payload == jwal.encode_record("edges", {"epoch": 3}, arrays)
    body = payload[walmod._REC_HEADER.size:]
    rec = walmod.decode_payload(body)
    assert rec.kind == "edges" and rec.meta == {"epoch": 3}
    assert set(rec.arrays) == {"u", "w"}
    for k in arrays:
        np.testing.assert_array_equal(rec.arrays[k], arrays[k])
        assert rec.arrays[k].dtype == arrays[k].dtype


def test_segment_append_read_rotate_gc(tmp_path):
    d = str(tmp_path)
    wal = P.WriteAheadLog(d, fsync="always")
    for i in range(4):
        assert wal.append("tick", {"i": i}) == i
    seq0 = wal.active_seq
    seq1 = wal.rotate()
    assert seq1 == seq0 + 1
    wal.append("tock", {"i": 99})
    wal.close()
    segs = walmod.list_segments(d)
    assert [s for s, _ in segs] == [seq0, seq1]
    recs, bad, _ = walmod.read_segment(segs[0][1])
    assert bad is None and [r.meta["i"] for r in recs] == [0, 1, 2, 3]
    # the JAX package reads the port's segment to the same records
    jrecs, jbad, _ = jwal.read_segment(segs[0][1])
    assert jbad is None and [r.meta for r in jrecs] == \
        [r.meta for r in recs]
    wal2 = P.WriteAheadLog(d, fsync="off")
    assert [r.meta["i"] for r in wal2.replay(seq0)] == [0, 1, 2, 3, 99]
    (tmp_path / "junk.tmp").write_bytes(b"x")
    removed = wal2.gc(seq1)
    assert any(p.endswith("junk.tmp") for p in removed)
    assert [s for s, _ in walmod.list_segments(d)] == [seq1,
                                                      wal2.active_seq]
    wal2.close()


@pytest.mark.parametrize("damage,reason", [("torn", "torn"),
                                           ("flip", "corrupt")])
def test_tail_damage_detected_and_cut(tmp_path, damage, reason):
    d = str(tmp_path)
    wal = P.WriteAheadLog(d, fsync="always")
    for i in range(3):
        wal.append("tick", {"i": i},
                   {"a": np.arange(64, dtype=np.int64)})
    wal.close()
    (torn_tail if damage == "torn" else flip_tail_byte)(d)
    path = walmod.list_segments(d)[-1][1]
    recs, bad, valid = walmod.read_segment(path)
    assert bad is not None and bad["reason"] == reason
    assert [r.meta["i"] for r in recs] == [0, 1]
    walmod.cut_segment(path, valid)
    assert os.path.getsize(path) == valid
    recs2, bad2, _ = walmod.read_segment(path)
    assert bad2 is None and len(recs2) == 2


def test_atomic_snapshot_checksum(tmp_path):
    path = str(tmp_path / "snapshot-00000007.npz")
    meta = {"version": 1, "epoch": 2}
    arrays = {"x": np.arange(100, dtype=np.int32)}
    walmod.write_snapshot_atomic(path, meta, arrays)
    assert not [p for p in os.listdir(str(tmp_path))
                if p.endswith(".tmp")]
    got_meta, got_arrays = walmod.read_snapshot(path)
    assert got_meta["epoch"] == 2 and "checksum" in got_meta
    assert got_meta["checksum"] == jwal.snapshot_checksum(meta, arrays)
    np.testing.assert_array_equal(got_arrays["x"], arrays["x"])
    with open(path, "r+b") as f:                   # one flipped byte
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(P.SnapshotCorruption):
        walmod.read_snapshot(path)


# --------------------------------------------------- service-level drill
def _graph():
    return powerlaw_temporal(60, 360, 48, seed=5)


def _ops(g, seed=0):
    """tests/test_wal.py's tape: admissions, a same-tick submit+cancel
    twin of the first request, ingest, a checkpoint, more of both."""
    uts = g.unique_ts
    n = int(uts.size)
    reqs = [{"k": 2 + (i % 2), "ts": int(uts[a]), "te": int(uts[b])}
            for i, (a, b) in enumerate([(0, n // 2), (n // 3, n - 1),
                                        (n // 5, n // 2 + 2),
                                        (1, n // 4)])]
    rng = np.random.default_rng(seed)
    V = int(g.num_vertices)

    def batch(m):
        u = rng.integers(0, V, size=m)
        v = (u + 1 + rng.integers(0, V - 1, size=m)) % V
        t = rng.integers(int(uts[0]), int(uts[-1]) + 1, size=m)
        return (u.astype(np.int64), v.astype(np.int64),
                t.astype(np.int64))

    return ([("submit", reqs[0]), ("submit_cancel", reqs[0])]
            + [("submit", r) for r in reqs[1:3]]
            + [("edges", batch(16)), ("checkpoint",),
               ("submit", reqs[3]), ("edges", batch(8))])


def _drive(svc, ops, tickets=None):
    tickets = {} if tickets is None else tickets
    state = {"i": 0}

    def poll(s):
        if state["i"] >= len(ops):
            return
        op = ops[state["i"]]
        state["i"] += 1
        if op[0] == "submit":
            tk = s.submit(dict(op[1]))
            tickets[tk.id] = tk
        elif op[0] == "submit_cancel":
            tk = s.submit(dict(op[1]))
            tickets[tk.id] = tk
            s.cancel(tk)
        elif op[0] == "edges":
            s.push_edges(*op[1])
        elif op[0] == "checkpoint" and s.wal is not None:
            s.checkpoint()

    while state["i"] < len(ops) or svc.pending:
        svc.run_until_idle(poll)
    return tickets


def _digest(tk):
    return sorted((k, tuple(c.vertices.tolist()), int(c.n_edges))
                  for k, c in tk.result.by_tti().items())


def _roster(d):
    out = []
    for _, path in walmod.list_segments(d):
        recs, bad, _ = walmod.read_segment(path)
        assert bad is None, (path, bad)
        out.extend(recs)
    return out


def _svc(g, **kw):
    return P.TCQService(P.TemporalGraph.from_state(g.state_dict()),
                        device="cpu", use_kernel=False, **kw)


def _recover(d, **kw):
    return P.TCQService.recover(d, device="cpu", use_kernel=False, **kw)


def _check_prefix(rec_svc, prefix, precrash, ref, ref_twin):
    """Recovery over one surviving prefix: every journaled admission is
    accounted for and equal to the JAX service's fault-free drain."""
    got = {tk.id: tk for tk in rec_svc.run_until_idle()}
    cancelled = {int(r.meta["id"]) for r in prefix if r.kind == "cancel"}
    for r in prefix:
        if r.kind != "submit":
            continue
        rid = int(r.meta["id"])
        tk = got.get(rid) or precrash.get(rid)
        assert tk is not None and tk.done, f"admission #{rid} lost"
        if rid in cancelled:
            assert tk.status == "cancelled", (rid, tk.status)
            continue
        want = ref[rid]
        if want.status == "cancelled":     # cancel fell off the tail
            want = ref_twin[(tk.k, tk.h, tk.ts, tk.te, tk.epoch)]
        assert _digest(tk) == _digest(want), rid
    return got


@pytest.fixture(scope="module")
def drill():
    """Graph, tape, the JAX service's fault-free drain, and one completed
    journaled run of the port (the mutilation target + kill roster)."""
    g = _graph()
    ops = _ops(g)
    ref = _drive(J.TCQService(g, use_kernel=False), ops)
    ref_twin = {(tk.k, tk.h, tk.ts, tk.te, tk.epoch): tk
                for tk in ref.values() if tk.status == "done"}
    full_dir = tempfile.mkdtemp(prefix="tcq-torch-walgate-")
    svc = _svc(g, wal_dir=full_dir, fsync="always")
    full = _drive(svc, ops)
    svc.wal.close()
    assert sorted(full) == sorted(ref)
    for rid in full:
        assert full[rid].status == ref[rid].status
        if full[rid].status == "done":
            assert _digest(full[rid]) == _digest(ref[rid])
    roster = _roster(full_dir)
    yield dict(g=g, ops=ops, ref=ref, ref_twin=ref_twin,
               full_dir=full_dir, full=full, roster=roster)
    shutil.rmtree(full_dir, ignore_errors=True)


def test_kill_after_every_record(drill, tmp_path):
    """Die right after record n lands, at the boundary sample of
    tests/test_wal.py; recovery + drain equal the JAX drain over the
    n+1-record prefix, graph fingerprint included."""
    g, ops, roster = drill["g"], drill["ops"], drill["roster"]
    R = len(roster)
    fps, gg = [], g
    for rec in roster:
        if rec.kind == "edges":
            gg = gg.add_edges(rec.arrays["u"], rec.arrays["v"],
                              rec.arrays["t"])
        fps.append(gg.fingerprint())
    sig = [(r.kind, (r.meta or {}).get("id")) for r in roster]
    e0 = next(i for i, r in enumerate(roster) if r.kind == "edges")
    for n in sorted({0, 1, e0, e0 + 1, R - 1}):
        d = str(tmp_path / f"kill{n}")
        killer = CrashingWAL(P.WriteAheadLog(d, fsync="always"),
                             crash_after_records=n)
        seen = {}
        with pytest.raises(InjectedCrash):
            _drive(_svc(g, wal=killer), ops, seen)
        prefix = _roster(d)
        assert [(r.kind, (r.meta or {}).get("id"))
                for r in prefix] == sig[:n + 1]
        rec_svc = _recover(d)
        _check_prefix(rec_svc, prefix, seen, drill["ref"],
                      drill["ref_twin"])
        assert rec_svc.graph.fingerprint() == fps[n], n
        rec_svc.wal.close()


@pytest.mark.parametrize("damage,reason", [(torn_tail, "torn"),
                                           (flip_tail_byte, "corrupt")])
def test_recover_from_damaged_tail(drill, tmp_path, damage, reason):
    d = str(tmp_path / reason)
    shutil.copytree(drill["full_dir"], d)
    damage(d)
    rec_svc = _recover(d)
    rep = rec_svc.recovery_report
    assert [e["reason"] for e in rep["tail_events"]] == [reason]
    _check_prefix(rec_svc, drill["roster"][:-1], drill["full"],
                  drill["ref"], drill["ref_twin"])
    rec_svc.wal.close()


def test_corrupt_newest_snapshot_falls_back(drill, tmp_path):
    d = str(tmp_path / "snapfall")
    shutil.copytree(drill["full_dir"], d)
    corrupt_snapshot(d)
    rec_svc = _recover(d)
    rep = rec_svc.recovery_report
    assert len(rep["snapshots_skipped"]) == 1
    _check_prefix(rec_svc, drill["roster"], drill["full"],
                  drill["ref"], drill["ref_twin"])
    rec_svc.wal.close()


def test_recover_mid_checkpoint_crash(drill, tmp_path):
    g, ops = drill["g"], drill["ops"]
    d = str(tmp_path / "rotcrash")
    killer = CrashingWAL(P.WriteAheadLog(d, fsync="always"),
                         crash_on_rotate=True)
    seen = {}
    with pytest.raises(InjectedCrash):
        _drive(_svc(g, wal=killer), ops, seen)
    junk = os.path.join(d, "snapshot-99999999.npz.tmp")
    with open(junk, "wb") as f:
        f.write(b"half a snapshot")
    prefix = _roster(d)
    rec_svc = _recover(d)
    _check_prefix(rec_svc, prefix, seen, drill["ref"], drill["ref_twin"])
    rec_svc.checkpoint()
    assert not os.path.exists(junk)
    rec_svc.wal.close()


def test_replay_verifies_lineage_and_ids(drill, tmp_path):
    d = str(tmp_path / "tamper")
    shutil.copytree(drill["full_dir"], d)
    wal = P.WriteAheadLog(d, fsync="always")
    wal.append("edges", {"graph_epoch": 999, "num_edges": 1,
                         "num_pairs": 1, "num_vertices": 1,
                         "fingerprint": 12345},
               {"u": np.array([1]), "v": np.array([2]),
                "t": np.array([3])})
    wal.rotate()
    wal.close()
    with pytest.raises(P.WALReplayError):
        _recover(d)


def test_recover_empty_dir_raises(tmp_path):
    with pytest.raises(P.WALError):
        P.TCQService.recover(str(tmp_path / "nothing-here"))


def test_journal_off_by_default():
    g = _graph()
    svc = _svc(g)
    assert svc.wal is None
    svc.submit({"k": 2, "ts": int(g.unique_ts[0]),
                "te": int(g.unique_ts[-1])})
    svc.run_until_idle()
    assert "wal" not in svc.stats


def test_snapshot_includes_live_pool(drill):
    g = drill["g"]
    svc = _svc(g)
    uts = g.unique_ts
    for i in range(3):
        svc.submit({"k": 2, "ts": int(uts[0]), "te": int(uts[-1 - i])})
    snaps = []

    def poll(s):
        if not snaps and s._inflight:
            snaps.append(s.snapshot())
    svc.run_until_idle(poll)
    assert snaps, "poll never saw a live pool"
    ids = {t["id"] for t in snaps[0]["tickets"]}
    assert ids, "mid-pool snapshot dropped the running tickets"
    restored = P.TCQService.restore(snaps[0], device="cpu",
                                    use_kernel=False)
    got = {tk.id: tk for tk in restored.run_until_idle()}
    assert set(got) == ids
    by_id = {tk.id: tk for tk in svc.completed}
    for rid in ids:
        assert _digest(got[rid]) == _digest(by_id[rid])


# ------------------------------------------- journals across the packages
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_recovers_in_the_other_package(drill, tmp_path, writer):
    """A journal directory written by one package's service, cut by a
    crash after its ingest, recovers in the other package; the drains of
    the recovered service equal the JAX fault-free drain, and a further
    8 requests drain the same as on the uninterrupted JAX service."""
    g, ops, roster = drill["g"], drill["ops"], drill["roster"]
    e1 = max(i for i, r in enumerate(roster) if r.kind == "edges") - 1
    d = str(tmp_path / writer)
    inner = (J.WriteAheadLog if writer == "jax" else P.WriteAheadLog)(
        d, fsync="always")
    killer = CrashingWAL(inner, crash_after_records=e1)
    seen = {}
    with pytest.raises(InjectedCrash):
        if writer == "jax":
            _drive(J.TCQService(g, use_kernel=False, wal=killer), ops, seen)
        else:
            _drive(_svc(g, wal=killer), ops, seen)
    prefix = _roster(d)
    if writer == "jax":
        rec_svc = _recover(d)
    else:
        rec_svc = J.TCQService.recover(d, use_kernel=False)
    _check_prefix(rec_svc, prefix, seen, drill["ref"], drill["ref_twin"])
    gg = g
    for rec in prefix:
        if rec.kind == "edges":
            gg = gg.add_edges(rec.arrays["u"], rec.arrays["v"],
                              rec.arrays["t"])
    assert rec_svc.graph.fingerprint() == gg.fingerprint()
    # further traffic on the recovered service drains as on a JAX service
    # that holds the same graph
    uts = g.unique_ts
    rng = np.random.default_rng(42)
    more = []
    for _ in range(8):
        a, b = sorted(rng.integers(0, uts.size, 2).tolist())
        more.append({"k": int(rng.integers(2, 4)), "ts": int(uts[a]),
                     "te": int(uts[b])})
    got = [rec_svc.submit(r) for r in more]
    rec_svc.run_until_idle()
    base = J.TCQService(gg, use_kernel=False)
    want = [base.submit(r) for r in more]
    base.run_until_idle()
    assert [_digest(t) for t in got] == [_digest(t) for t in want]
    rec_svc.wal.close()


def test_recover_defaults_to_cuda(drill, tmp_path):
    d = str(tmp_path / "cuda")
    shutil.copytree(drill["full_dir"], d)
    if torch.cuda.is_available():
        rec = P.TCQService.recover(d)
        assert rec.engine.device.type == "cuda"
        rec.wal.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.TCQService.recover(d)
    buf = io.BytesIO()
    rec = _recover(d)
    rec.save_snapshot(buf)
    rec.wal.close()
    buf.seek(0)
    assert J.TCQService.load_snapshot(buf).epoch == rec.epoch
