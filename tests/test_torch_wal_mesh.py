"""The journal on a mesh of several ranks (``TCQService(mesh=, wal_dir=)``,
``TCQService.recover(wal_dir, mesh=)``, ``core/wal.py::MeshJournal``)
against the JAX package, on the CPU over gloo.

tests/test_torch_wal.py's tape runs on gloo worlds (1, 2), (2, 1) and
(2, 2), each with psum and with rs_ag: once uninterrupted with a journal,
then killed after a stated journal record (mid-tape, and after the
checkpoint) or with its last record torn, each kill recovered by a new
world and drained.  Every drain must equal, ticket for ticket, the
uninterrupted world, the port's unsharded service killed and recovered
the same way, and the JAX plain service's fault-free drain of the tape
(the JAX mesh service cannot be the oracle: it is red on this JAX).  Only
rank 0 may write: every other rank is handed a directory of its own,
which must never appear.

Every spawned world has a timeout: a hang fails the test.
"""

import os
import shutil
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.faultinject import (CrashingWAL,  # noqa: E402
                                          InjectedCrash, torn_tail)
from repro_torch.launch.world import run_world  # noqa: E402

WORLDS = {2: [((1, 2), "psum"), ((1, 2), "rs_ag"), ((2, 1), "psum"),
              ((2, 1), "rs_ag")],
          4: [((2, 2), "psum"), ((2, 2), "rs_ag")]}
CASES = [(n, f"{s[0]}x{s[1]}-{c}") for n, cases in WORLDS.items()
         for s, c in cases]
WORLD_TIMEOUT_S = 300
TESTS = str(Path(__file__).resolve().parent)


@pytest.fixture(scope="module")
def worlds():
    """Each world's journaling life, then its recovering life, on every
    rank: {world size: (writer outputs, recoverer outputs)}."""
    base = tempfile.mkdtemp(prefix="tcq-wal-mesh-")
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    try:
        for n, cases in WORLDS.items():
            wrote = run_world("_torch_dist_worker:wal_write", n,
                              args=(cases, base), backend="gloo",
                              timeout_s=WORLD_TIMEOUT_S)
            rec = run_world("_torch_dist_worker:wal_recover", n,
                            args=(cases, base), backend="gloo",
                            timeout_s=WORLD_TIMEOUT_S)
            out[n] = (wrote, rec)
        yield out
    finally:
        mp.undo()
        shutil.rmtree(base, ignore_errors=True)


@pytest.fixture(scope="module")
def references():
    """The JAX plain service's fault-free drain of the tape, and the
    port's unsharded service journaled, killed as each world is, and
    recovered and drained: {"jax": {id: digest}, kill: {id: digest}}."""
    g = W.wal_graph()
    ops = W.wal_ops(g)
    jg = J.TemporalGraph.from_state(g.state_dict())
    jax_drain = W.ticket_digests(W.drive_tape(
        J.TCQService(jg, use_kernel=False), ops))
    pg = P.TemporalGraph.from_state(g.state_dict())
    refs = {"jax": jax_drain}
    tmp = tempfile.mkdtemp(prefix="tcq-wal-unsharded-")
    try:
        for kill, (after, torn) in W.WAL_KILLS.items():
            d = f"{tmp}/{kill}"
            wal = P.WriteAheadLog(d, fsync="always")
            if after is not None:
                wal = CrashingWAL(wal, crash_after_records=after)
            svc = P.TCQService(pg, device="cpu", use_kernel=False, wal=wal)
            seen = {}
            try:
                W.drive_tape(svc, ops, seen)
            except InjectedCrash:
                pass
            svc.wal.close()
            if torn:
                torn_tail(d)
            rec = P.TCQService.recover(d, device="cpu", use_kernel=False,
                                       fsync="always")
            drained = {tk.id: tk for tk in rec.run_until_idle()}
            rec.wal.close()
            refs[kill] = {"precrash": W.ticket_digests(seen),
                          "drained": W.ticket_digests(drained),
                          "report": rec.recovery_report}
        yield refs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _case(worlds, n, key):
    wrote, rec = worlds[n]
    return [w[key] for w in wrote], [r[key] for r in rec]


@pytest.mark.parametrize("n,key", CASES)
def test_uninterrupted_world_journals_and_matches_jax(worlds, references,
                                                      n, key):
    wrote, _ = _case(worlds, n, key)
    full = wrote[0]["full"]
    assert full["tickets"] == references["jax"]
    assert full["stats"]["records_appended"] == 8    # the tape's records
    for w in wrote:             # rank 0's journal stats on every rank
        assert w["full"] == full


@pytest.mark.parametrize("kill", list(W.WAL_KILLS))
@pytest.mark.parametrize("n,key", CASES)
def test_recovered_world_drains_bit_identical(worlds, references, n, key,
                                              kill):
    """A world killed (or torn) at ``kill``, recovered by a new world and
    drained: every admission the journal kept resolves, equal to the
    uninterrupted world, the unsharded port's recovery and JAX's drain."""
    wrote, rec = _case(worlds, n, key)
    after, torn = W.WAL_KILLS[kill]
    unsharded = references[kill]
    full = wrote[0]["full"]["tickets"]
    # which tickets finish before the kill follows the pools' pace; every
    # admission the journal kept resolves, before the kill or in the drain
    want = {**unsharded["precrash"], **unsharded["drained"]}
    for w, r in zip(wrote, rec):
        k = w[kill]
        assert k["crashed"] == (after is not None)
        got = r[kill]
        assert got["epoch"] == rec[0][kill]["epoch"]
        resolved = {**k["precrash"], **got["drained"]}
        assert resolved, "no admission survived"
        assert resolved == want
        for tid, (status, epoch, cores) in resolved.items():
            assert (status, epoch, cores) == full[tid], tid
            assert (status, epoch, cores) == references["jax"][tid], tid
    # what the journal kept: records up to the kill, or all but the torn
    reports = [r[kill]["report"] for r in rec]
    plain = unsharded["report"]
    assert reports[0]["wal_records"] == plain["wal_records"]
    assert reports[0]["snapshot_seq"] == plain["snapshot_seq"]
    assert [e["reason"] for e in reports[0]["tail_events"]] == \
        [e["reason"] for e in plain["tail_events"]]
    assert [e["reason"] for e in reports[0]["tail_events"]] == \
        (["torn"] if torn else [])
    assert all(rep == reports[0] for rep in reports)   # rank 0's report


@pytest.mark.parametrize("n,key", CASES)
def test_only_rank_0_writes(worlds, n, key):
    _, rec = _case(worlds, n, key)
    files = rec[0]["files"]
    assert files and all(f == files for f in (r["files"] for r in rec))
    assert not [f for f in files if "-rank" in f], files
    for kill in ("full",) + tuple(W.WAL_KILLS):
        assert any(f"/{kill}/snapshot-" in f for f in files), kill
    # every rank holds rank 0's journal counters after recovery
    for kill in W.WAL_KILLS:
        assert all(r[kill]["stats"] == rec[0][kill]["stats"] for r in rec)
