"""The flight recorder's cost repair on the port (trace/recorder.py,
utils/serde.py, utils/fsio.py) and the replay bench's windowed reading
(bench.run_replay_bench), on the CPU:

  - every wave text a drain journals, rendered at capture by the C renderer
    (serde.dumpb, utils/csrc/serde_render.c), equals the general path's
    (json.dumps of the encoded record), serde.dumps raises where encode
    does, and the renderer holds each item it renders;
  - a capture renders its wave at once: what it queues holds no object the
    collector tracks (after its fleet's first wave);
  - `stats(split=True)` reports the recorder's cost by part, and stats()
    keeps the JAX recorder's keys;
  - a segment written in chunks, with writes that land in part, holds the
    bytes it was given, and a failed write leaves nothing behind;
  - run_replay_bench with rounds: the windows in the order OFF, ON, ON, OFF
    per round, each of the same count, bench.py's formula on their sums.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest

from grove_tpu_torch import bench as p_bench
from grove_tpu_torch.trace import recorder as p_rec
from grove_tpu_torch.utils import fsio, serde
from torch_jax_programs import _release_jax_programs  # noqa: F401


def test_serde_dumps_raises_where_encode_raises():
    for bad in (np.int64(3), object()):
        with pytest.raises(TypeError):
            serde.encode(bad)
        with pytest.raises(TypeError):
            serde.dumps([1, {"x": bad}])


@dataclasses.dataclass
class _Field:
    x: int = 1


class _Shrinks(_Field):
    """A dataclass whose field runs Python code that empties the list being
    rendered."""

    outer: list = []

    @property
    def x(self):
        type(self).outer.clear()
        return 2

    @x.setter
    def x(self, value):
        pass


def test_the_renderer_holds_what_it_renders():
    """A field's getter that empties the list the renderer is walking: the
    C renderer neither crashes nor reads freed items, and it writes what the
    general path writes for the same walk (the list stops where it was
    emptied)."""
    for render in (serde.dumps, lambda o: json.dumps(serde.encode(o))):
        _Shrinks.outer = [_Shrinks(), "gone", 3, {"k": 4}]
        _Shrinks.outer.append(_Shrinks.outer[-1])
        got = render(_Shrinks.outer)
        assert got == '[{"!t": "_Shrinks", "x": 2}]', got
    assert serde.dumpb([("a", 1.5), {2: None}]) == json.dumps(
        serde.encode([("a", 1.5), {2: None}])).encode()


def test_wave_texts_equal_the_general_paths(tmp_path, monkeypatch):
    """Every wave a drain journals, rendered at capture by serde.dumpb (the C
    renderer) and,
    from the same capture, by json.dumps of the encoded record: the same
    bytes; and each segment on disk is json.dumps of itself."""
    from test_torch_trace import port_drain_journal

    real = p_rec._wave_text
    fast = serde.dumpb
    seen = []

    def both(c, digest):
        text = real(c, digest)
        monkeypatch.setattr(serde, "dumpb", lambda o: json.dumps(serde.encode(o)).encode())
        try:
            general = real(c, digest)
        finally:
            monkeypatch.setattr(serde, "dumpb", fast)
        assert text == general
        seen.append(len(text))
        return text

    monkeypatch.setattr(p_rec, "_wave_text", both)
    records, *_ = port_drain_journal(tmp_path / "j", n=(4, 3, 3), racks_per_block=2,
                                     wave_size=4)
    assert len(seen) == sum(1 for r in records if r.get("kind") == "wave") >= 2
    for seg in sorted((tmp_path / "j").glob("segment-*.json")):
        text = seg.read_text()
        assert text == json.dumps(json.loads(text)), seg


def test_a_capture_queues_nothing_the_collector_tracks(tmp_path):
    """Every wave after its fleet's first is queued as bytes and strings: no
    pod copy or object graph waits a flush interval in the queue."""
    from grove_tpu_torch.solver.drain import drain_backlog
    from test_torch_host import PORT
    from test_torch_trace import problem

    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(4, 3, 3))
    rec = p_rec.TraceRecorder(str(tmp_path / "j"))  # not started: the queue keeps all
    drain_backlog(gangs, pods, snap, wave_size=4, recorder=rec, device="cpu")
    queued = list(rec._queue.queue)
    waves = [r for r in queued if r.get("kind") == "wave"]
    assert len(waves) >= 2 and "_fleet" in waves[0]
    for r in waves[1:]:
        assert not gc.is_tracked(r), r.keys()
        assert isinstance(r["_text"], bytes)


def test_stats_split_reports_each_part(tmp_path):
    from test_torch_trace import port_drain_journal

    records, _, _, rec = port_drain_journal(tmp_path / "j", n=(4, 3, 3), racks_per_block=2,
                                            wave_size=4)
    doc = rec.stats(split=True)
    assert set(doc["split"]) == set(p_rec.SPLIT_PARTS)
    waves = sum(1 for r in records if r.get("kind") == "wave")
    assert doc["split"]["capture"]["n"] == doc["split"]["render"]["n"] == waves
    assert doc["split"]["segment"]["n"] == rec.segments_written
    assert doc["split"]["manifest"]["n"] == rec.manifest_writes
    assert all(v["s"] >= 0.0 for v in doc["split"].values())
    assert "split" not in rec.stats()


def test_chunks_written_in_part_land_whole(tmp_path, monkeypatch):
    real = os.writev
    calls = []

    def short_writev(fd, buffers):
        calls.append(len(buffers))
        first = bytes(buffers[0])[:7]
        return real(fd, [first])

    monkeypatch.setattr(os, "writev", short_writev)
    chunks = [b"{", b"", b"abcdefghijklmnop" * 3, b", ", b"xyz", b"}"]
    path = tmp_path / "seg.json"
    fsio.atomic_write_chunks(str(path), chunks)
    assert path.read_bytes() == b"".join(chunks) and len(calls) > len(chunks)
    assert [p.name for p in tmp_path.iterdir()] == ["seg.json"]


def test_a_failed_chunk_write_leaves_the_file_and_no_temporary(tmp_path, monkeypatch):
    path = tmp_path / "seg.json"
    path.write_bytes(b"old")

    def fail(fd, buffers):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(os, "writev", fail)
    with pytest.raises(OSError):
        fsio.atomic_write_chunks(str(path), [b"new"])
    assert path.read_bytes() == b"old"
    assert [p.name for p in tmp_path.iterdir()] == ["seg.json"]


def test_replay_bench_rounds_of_windows():
    doc = p_bench.run_replay_bench(device="cpu", window_s=0.05, rounds=2)
    windows = doc["record_windows"]
    assert [w[0] for w in windows] == ["off", "on", "on", "off"] * 2
    assert len({w[1] for w in windows}) == 1 and windows[0][1] >= 1
    assert all(w[3] >= 0.0 and w[4] >= 0 for w in windows)
    drains = sum(w[1] for w in windows if w[0] == "on")
    assert doc["record_split"]["drains"] == drains
    assert set(doc["record_split"]["parts"]) == set(p_rec.SPLIT_PARTS)
    assert doc["record_split"]["parts"]["render"]["n"] >= drains
    off = sum(w[2] for w in windows if w[0] == "off")
    on = sum(w[2] for w in windows if w[0] == "on")
    assert doc["record_overhead_frac"] == pytest.approx((on - off) / off)
    assert doc["value"] == 0 and doc["gangs_admitted"] == 4

