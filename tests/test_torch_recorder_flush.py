"""The flight recorder's writer (grove_tpu_torch/trace/recorder.py): the
files its thread's passes stage ahead and a write commits with one write
and one rename each, the manifest made of kept entry texts, and flush()
writing on its caller's thread.

  - same bytes: after every flush of a run with several flushes per
    segment, rotations, pruning and a restart that seeds from the prior
    manifest, each segment and the manifest are byte for byte json.dumps
    of their documents, and the manifest is the one a whole rewrite makes
    from the segments on disk (`_manifest_entry` of each);
  - no torn files: a reader polling the directory through the flushes only
    ever parses whole segments and manifests;
  - the flush contract: flush() returns only after every record enqueued
    before it is on disk, while the writer thread makes passes of its own;
  - faults: an injected `recorder.write` ENOSPC drops and counts one
    segment's records, and the next segment is whole (its fleet written
    again);
  - no stray files: stop() leaves no temporary file, after a failed write
    too, and start() removes those a killed writer left;
  - a request_flush() that lands while the writer thread reads the request
    is served by its next pass, not at the flush interval;
  - the flush's parts in stats(split=True).
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from grove_tpu_torch import faults as p_faults
from grove_tpu_torch.trace import recorder as p_rec


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    p_faults.install(None)


FLEETS = {
    name: {"kind": "fleet", "topology": [{"domain": "rack", "key": "r"}],
           "nodes": [{"name": f"{name}-n{i}", "capacity": {"cpu": 8.5 + i}, "labels": {},
                      "taints": [], "schedulable": True} for i in range(3)],
           "digest": f"digest-{name}"}
    for name in ("a", "b")
}


class Feed:
    """Waves (a fleet riding with the first wave that references it, as
    capture_wave enqueues it) and actions, each wave's JSON text rendered
    at enqueue time."""

    def __init__(self, rec):
        self.rec = rec
        self.sent: list[str] = []
        self.announced: set[str] = set()

    def wave(self, i: int, fleet: str = "a") -> None:
        digest = FLEETS[fleet]["digest"]
        wid = f"w-{i:04d}"
        doc = {"kind": "wave", "now": float(i), "wave": wid, "fleet": digest,
               "plan": {f"g{i}": {"p0": f"{fleet}-n{i % 3}"}}, "ok": {f"g{i}": i % 5 != 0}}
        stub = {"kind": "wave", "wave": wid, "fleet": digest,
                "_text": bytearray(json.dumps(doc).encode())}
        if digest not in self.announced:
            stub["_fleet"] = dict(FLEETS[fleet])
            self.announced.add(digest)
        assert self.rec.record(stub)
        self.sent.append(wid)

    def action(self, i: int) -> None:
        assert self.rec.capture_action(float(i), "preempt", f"gang-{i}", reason="test")


def segments(path) -> list[str]:
    return sorted(f for f in os.listdir(path) if f.startswith("segment-"))


def check_files(path) -> dict:
    """Every segment and the manifest are json.dumps of their documents,
    and the manifest is the whole rewrite's; returns the manifest."""
    entries = []
    for name in segments(path):
        raw = (path / name).read_bytes()
        doc = json.loads(raw)
        assert raw == json.dumps(doc).encode(), name
        entries.append(p_rec._manifest_entry(int(name[8:14]), doc["records"]))
    raw = (path / "manifest.json").read_bytes()
    man = json.loads(raw)
    assert raw == json.dumps(man).encode()
    assert man["segments"] == entries
    assert man["waves"] == sum(e["waves"] for e in entries)
    ranges = [e["waveRange"] for e in entries if e["waveRange"]]
    assert man["lastWave"] == (ranges[-1][1] if ranges else None)
    return man


def journal_waves(path) -> list[str]:
    return [r["wave"] for r in p_rec.read_journal(str(path)) if r.get("kind") == "wave"]


def test_files_are_json_dumps_of_their_documents_after_every_flush(tmp_path):
    """Several flushes per segment, rotations, pruning, a fleet change, and
    a second writer life seeded from the first's manifest."""
    path = tmp_path / "j"
    i = 0
    for life in range(2):
        rec = p_rec.TraceRecorder(str(path), max_records_per_file=7, max_files=3,
                                  flush_interval_seconds=60.0)
        rec.start()
        feed = Feed(rec)
        try:
            for step in range(9):
                for _ in range(2 + step % 3):
                    feed.wave(i, "a" if i < 25 else "b")
                    i += 1
                if step % 4 == 1:
                    feed.action(i)
                assert rec.flush()
                man = check_files(path)
                # Everything enqueued before the flush is on disk (the
                # pruned segments' waves aside).
                assert journal_waves(path)[-1] == feed.sent[-1]
        finally:
            rec.stop()
        man = check_files(path)
        assert man["prunedSegments"] == rec.pruned_segments > 0
        assert len(segments(path)) == 3
        assert rec.segments_written > rec.pruned_segments + 3  # rewrites of open segments
    # The second life numbered on from the first and carried its ledger.
    assert int(segments(path)[-1][8:14]) >= 6 and man["prunedWaves"] > 0
    records = p_rec.read_journal(str(path))
    fleets = {r["digest"] for r in records if r.get("kind") == "fleet"}
    assert fleets == {"digest-a", "digest-b"} or fleets == {"digest-b"}
    for name in segments(path):  # every segment replays standalone
        doc = json.loads((path / name).read_bytes())
        refs = {r["fleet"] for r in doc["records"] if r.get("kind") == "wave"}
        assert refs <= {r["digest"] for r in doc["records"] if r.get("kind") == "fleet"}


def test_a_reader_never_sees_a_torn_file(tmp_path):
    path = tmp_path / "j"
    rec = p_rec.TraceRecorder(str(path), max_records_per_file=40, max_files=4,
                              flush_interval_seconds=60.0)
    rec.start()
    feed = Feed(rec)
    stop, seen, errors = threading.Event(), [0], []

    def reader():
        while not stop.is_set():
            for name in [*segments(path), "manifest.json"]:
                try:
                    raw = (path / name).read_bytes()
                except FileNotFoundError:  # pruned between the listing and the open
                    continue
                try:
                    json.loads(raw)
                except ValueError as e:
                    errors.append((name, len(raw), str(e)))
                seen[0] += 1

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(400):
            feed.wave(i)
            if i % 3 == 0:
                assert rec.flush()
    finally:
        stop.set()
        t.join()
        rec.stop()
    assert not errors, errors[:3]
    assert seen[0] > 50
    check_files(path)


def test_flush_returns_after_everything_enqueued_before_it_is_on_disk(tmp_path):
    """The writer thread makes passes of its own (a queue of 8 wakes it at
    half full, and a 1 ms flush interval writes on its own) while the
    caller flushes: each flush finds every wave sent before it on disk."""
    path = tmp_path / "j"
    rec = p_rec.TraceRecorder(str(path), max_records_per_file=64, max_files=64, queue_size=8,
                              flush_interval_seconds=0.001)
    rec.start()
    feed = Feed(rec)
    try:
        for i in range(300):
            feed.wave(i)
            if i % 2:
                assert rec.flush()
                assert journal_waves(path) == feed.sent
    finally:
        rec.stop()
    assert rec.dropped == 0
    assert journal_waves(path) == feed.sent
    check_files(path)


def test_flushes_from_many_threads_lose_and_repeat_no_record(tmp_path):
    """Stress: a producer and six flushing threads against the writer
    thread's own passes (1 ms interval, a queue of 16), under a 10 us
    switch interval: each flush finds what was sent before it on disk,
    and at the end every wave is on disk exactly once, in order."""
    import sys

    path = tmp_path / "j"
    rec = p_rec.TraceRecorder(str(path), max_records_per_file=32, max_files=1000,
                              queue_size=16, flush_interval_seconds=0.001)
    rec.start()
    feed = Feed(rec)
    done, failures = threading.Event(), []

    def flusher():
        try:
            while not done.is_set():
                sent = len(feed.sent)
                if not rec.flush(timeout=10.0):
                    failures.append("flush timed out")
                    return
                on_disk = journal_waves(path) if sent else []
                if on_disk[:sent] != feed.sent[:sent]:
                    failures.append(("lost", sent, len(on_disk)))
                    return
        except Exception as e:  # the thread's failure, reported by the test
            failures.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=flusher) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for i in range(400):
            while len(rec._queue) >= 8:  # no drop: the writer keeps up
                done.wait(0.0005)
            feed.wave(i)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=30.0)
        sys.setswitchinterval(interval)
        rec.stop()
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:3]
    assert rec.dropped == 0 and journal_waves(path) == feed.sent
    check_files(path)


def test_an_injected_enospc_drops_one_segment_and_the_next_is_whole(tmp_path):
    path = tmp_path / "j"
    p_faults.install(p_faults.FaultInjector(
        {"recorder.write": p_faults.SiteSpec(kind="enospc", count=1, after=1)}, seed=0))
    rec = p_rec.TraceRecorder(str(path), max_records_per_file=50, flush_interval_seconds=60.0)
    rec.start()
    feed = Feed(rec)
    try:
        for i in range(3):
            feed.wave(i)
        assert rec.flush()  # written
        written = journal_waves(path)
        for i in range(3, 7):
            feed.wave(i)
        assert rec.flush()  # the injected ENOSPC: the open segment's 8 records dropped
        assert rec.write_errors == 1 and rec.degraded and rec.dropped == 8
        assert journal_waves(path) == written  # the file on disk is the last good one
        for i in range(7, 10):
            feed.wave(i)
        assert rec.flush()
        assert not rec.degraded
    finally:
        rec.stop()
    doc = json.loads((path / segments(path)[0]).read_bytes())
    kinds = [r["kind"] for r in doc["records"]]
    # The next segment is whole: its fleet written again before its waves.
    assert kinds == ["fleet", "wave", "wave", "wave"]
    assert [r["wave"] for r in doc["records"][1:]] == ["w-0007", "w-0008", "w-0009"]
    assert doc["recorderWriteErrors"] == 1 and doc["recorderDropped"] == 8
    assert p_rec.journal_stats(str(path))["degraded"] is True
    check_files(path)
    assert [f for f in os.listdir(path) if f.startswith(".atomic-")] == []


def test_stop_leaves_no_temporary_file(tmp_path):
    """The writer thread's passes stage the next files in the journal
    directory; stop() takes them away, after a failed write as well."""
    path = tmp_path / "j"
    rec = p_rec.TraceRecorder(str(path), max_records_per_file=4)
    rec.start()
    try:
        feed = Feed(rec)
        for i in range(10):
            feed.wave(i)
        assert rec.flush()
        feed.wave(10)
        rec.request_flush()  # a pass of the writer thread, which stages
        deadline = time.monotonic() + 10.0
        while not any(f.startswith(".atomic-") for f in os.listdir(path)):
            assert time.monotonic() < deadline, "the writer's pass staged nothing"
            time.sleep(0.005)
    finally:
        rec.stop()
    assert sorted(os.listdir(path)) == ["manifest.json", *segments(path)]
    p_faults.install(p_faults.FaultInjector(
        {"recorder.write": p_faults.SiteSpec(kind="enospc", count=1)}, seed=0))
    rec = p_rec.TraceRecorder(str(path), max_records_per_file=4)
    rec.start()
    try:
        Feed(rec).wave(99)
        assert rec.flush() and rec.write_errors == 1
    finally:
        rec.stop()
    assert sorted(os.listdir(path)) == ["manifest.json", *segments(path)]
    check_files(path)


def test_start_removes_the_temporary_files_a_killed_writer_left(tmp_path):
    path = tmp_path / "j"
    rec = p_rec.TraceRecorder(str(path))
    rec.start()
    try:
        Feed(rec).wave(0)
        assert rec.flush()
    finally:
        rec.stop()
    # A writer killed mid-write leaves its temporary files behind.
    for name in (".atomic-x", ".atomic-segmentcopy"):
        (path / name).write_bytes(b'{"version": 1, "records": [')
    rec = p_rec.TraceRecorder(str(path))
    rec.start()
    try:
        Feed(rec).wave(1)
        assert rec.flush()
    finally:
        rec.stop()
    assert sorted(os.listdir(path)) == ["manifest.json", *segments(path)]
    assert journal_waves(path) == ["w-0000", "w-0001"]
    check_files(path)


class RacingEvent(threading.Event):
    """The flush request, with a request_flush() landing just after the
    writer thread's next read of it (between its read and its clear)."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec
        self.armed = False

    def is_set(self) -> bool:
        was = super().is_set()
        if self.armed:
            self.armed = False
            self.rec.request_flush()
        return was


def test_a_flush_request_landing_on_the_writers_read_is_served_next_pass(tmp_path):
    path = tmp_path / "j"
    rec = p_rec.TraceRecorder(str(path), flush_interval_seconds=60.0)
    rec._flush_now = RacingEvent(rec)
    rec.start()
    try:
        Feed(rec).wave(0)
        rec._flush_now.armed = True
        rec._wake.set()  # a pass with no request read
        deadline = time.monotonic() + 10.0
        while not segments(path) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert segments(path), "the request was lost until the flush interval"
        assert journal_waves(path) == ["w-0000"]
    finally:
        rec.stop()


def test_the_flush_split_adds_up(tmp_path):
    rec = p_rec.TraceRecorder(str(tmp_path / "j"), flush_interval_seconds=60.0)
    rec.start()
    feed = Feed(rec)
    try:
        for i in range(6):
            feed.wave(i)
            assert rec.flush()
        assert rec.flush()  # nothing new: no write
    finally:
        rec.stop()
    split = rec.stats(split=True)["split"]
    assert split["flush"]["n"] == 7 and split["startup"]["n"] == 1
    parts = sum(split[f"flush.{p}"]["s"] for p in p_rec.FLUSH_PARTS)
    assert parts == pytest.approx(split["flush"]["s"], rel=1e-6, abs=1e-9)
    assert all(split[f"flush.{p}"]["n"] == 7 for p in p_rec.FLUSH_PARTS)
    steps = rec.stats(split=True)["fileSteps"]
    assert set(steps) == {"open", "write", "close", "rename"} and steps["rename"] > 0
    # Six flushes wrote the segment and the manifest; stop() wrote both once
    # more; the start-up wrote the manifest.
    assert rec.segments_written == 7 and rec.manifest_writes == 8
    assert split["segment"]["n"] == 7 and split["manifest"]["n"] == 7


def test_the_long_lived_reading_runs_on_the_cpu(capsys, tmp_path):
    """trace/recorder_cost.py at one round of one-drain blocks: one kept
    recorder, flushed at the end of each of the round's two ON blocks."""
    from grove_tpu_torch.trace import recorder_cost

    out = tmp_path / "cost.json"
    assert recorder_cost.main(["--device", "cpu", "--rounds", "1", "--drains", "1",
                               "--scale", "0.5", "--out", str(out)]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == [doc]
    assert doc["drains_a_side"] == 2 and doc["card"] == "not measured (CPU)"
    assert doc["segments_written"] == 2 and doc["manifest_writes"] == 2
    assert doc["flush_ms"] > 0 and doc["render_ms"] > 0 and doc["capture_ms"] > 0
    assert doc["wall_off_ms"] > 0 and doc["wall_on_ms"] > 0
