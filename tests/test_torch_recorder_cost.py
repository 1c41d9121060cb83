"""The flight recorder's cost repair on the port (trace/recorder.py,
utils/serde.py, utils/fsio.py) and the replay bench's windowed reading
(bench.run_replay_bench), on the CPU:

  - every wave text a drain journals, rendered at capture by the C renderer
    straight from the capture (serde.render_wave, utils/csrc/serde_render.c),
    equals the general path's (json.dumps of the encoded
    recorder.wave_record) for every record of a replay drain, a serving
    drain and a pipelined pruned drain, and so does every odd input that
    takes the general path field by field; those journals read the same
    through the port's and the JAX package's readers and replay with 0
    divergences; serde.dumps raises where encode does, and the renderer
    holds each item it renders;
  - the C comparison of two snapshots' fleets decides as the Python one;
  - a capture renders its wave at once: what it queues holds no object the
    collector tracks (after its fleet's first wave);
  - `stats(split=True)` reports the recorder's cost by part, and stats()
    keeps the JAX recorder's keys;
  - a segment written in chunks, with writes that land in part, holds the
    bytes it was given, and a failed write leaves nothing behind;
  - run_replay_bench with rounds: the windows in the order OFF, ON, ON, OFF
    and ON, OFF, OFF, ON in turn, each of the same count, bench.py's formula on their sums.
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


@dataclasses.dataclass
class _Parent:
    first: object = None
    second: int = 1


class _Touch(_Field):
    """A dataclass whose field getter sets the _Parent's second field."""

    parent = None

    @property
    def x(self):
        type(self).parent.second = 2
        return 3

    @x.setter
    def x(self, value):
        pass

    def __hash__(self):
        return 0


def test_a_later_field_set_while_a_field_renders_is_read_again():
    """A plain dataclass's fields are read before they are rendered; where
    rendering one runs Python code (the fallback, here for a set) that sets
    a later field, the renderer writes that field as serde.encode reads it:
    after the change."""
    for render in (serde.dumps, lambda o: json.dumps(serde.encode(o))):
        _Touch.parent = _Parent(first={_Touch()})
        got = render(_Touch.parent)
        assert got == '{"!t": "_Parent", "first": {"!s": [{"!t": "_Touch", "x": 3}]}, ' \
            '"second": 2}', got


def test_wave_texts_equal_the_general_paths(tmp_path, monkeypatch):
    """Every wave a drain journals, rendered at capture by the C renderer
    (serde.render_wave) and, from the same capture, by json.dumps of the
    encoded general record (recorder.wave_record): the same bytes; and each
    segment on disk is json.dumps of itself."""
    from test_torch_trace import port_drain_journal

    real = p_rec._wave_text
    seen = []

    def both(c):
        text = real(c)
        assert text == json.dumps(serde.encode(p_rec.wave_record(c))).encode()
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
    """Every wave after its fleet's first is queued as its text (a bytearray)
    and strings: no pod copy or object graph waits a flush interval in the
    queue."""
    from grove_tpu_torch.solver.drain import drain_backlog
    from test_torch_host import PORT
    from test_torch_trace import problem

    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(4, 3, 3))
    rec = p_rec.TraceRecorder(str(tmp_path / "j"))  # not started: the queue keeps all
    drain_backlog(gangs, pods, snap, wave_size=4, recorder=rec, device="cpu")
    queued = list(rec._queue)
    waves = [r for r in queued if r.get("kind") == "wave"]
    assert len(waves) >= 2 and "_fleet" in waves[0]
    for r in waves[1:]:
        assert not gc.is_tracked(r), r.keys()
        assert isinstance(r["_text"], bytearray) and not gc.is_tracked(r["_text"])


def test_stats_split_reports_each_part(tmp_path):
    from test_torch_trace import port_drain_journal

    records, _, _, rec = port_drain_journal(tmp_path / "j", n=(4, 3, 3), racks_per_block=2,
                                            wave_size=4)
    doc = rec.stats(split=True)
    assert set(doc["split"]) == set(p_rec.SPLIT_PARTS)
    waves = sum(1 for r in records if r.get("kind") == "wave")
    assert doc["split"]["capture"]["n"] == doc["split"]["render"]["n"] == waves
    assert doc["split"]["segment"]["n"] == rec.segments_written
    assert doc["split"]["manifest"]["n"] + doc["split"]["startup"]["n"] == rec.manifest_writes
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
    assert [w[0] for w in windows] == ["off", "on", "on", "off", "on", "off", "off", "on"]
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



# ---- the wave record rendered straight from the capture ---------------------------------


def general_text(capture) -> bytes:
    return json.dumps(serde.encode(p_rec.wave_record(capture))).encode()


@pytest.fixture
def captures(monkeypatch):
    """Every capture a drain renders, each checked against the general path
    (a failed check is kept and asserted by the test: capture_wave's callers
    swallow what it raises)."""
    real = p_rec._wave_text
    seen, differ = [], []

    def both(c):
        text = real(c)
        seen.append(c)
        if text != general_text(c):
            differ.append((c[1], text, general_text(c)))
        return text

    monkeypatch.setattr(p_rec, "_wave_text", both)
    yield seen, differ


def replay_drain_journal(path):
    """bench.py's replay world drained once by GroveController under the
    Simulator, recorded."""
    doc = p_bench.run_replay_bench(device="cpu", journal_dir=str(path))
    assert doc["value"] == 0 and doc["journal_waves"] >= 2


def serving_drain_journal(path):
    """The serving world (256 nodes, a fiftieth of the backlog) served by
    GroveController until every pod is Ready, recorded."""
    from grove_tpu_torch.orchestrator.controller import GroveController
    from grove_tpu_torch.orchestrator.store import Cluster
    from grove_tpu_torch.sim.simulator import Simulator

    topo, nodes, backlog = p_bench.serving_world(0.05, 0.02)
    cluster = Cluster()
    for n in nodes:
        cluster.nodes[n.name] = n
    rec = p_rec.TraceRecorder(str(path))
    rec.start()
    try:
        ctrl = GroveController(cluster=cluster, topology=topo, device="cpu", recorder=rec)
        sim = Simulator(cluster=cluster, controller=ctrl)
        for pcs in backlog:
            cluster.podcliquesets[pcs.metadata.name] = pcs
        sim.run_until(lambda: cluster.pods and all(p.ready for p in cluster.pods.values()),
                      timeout=60.0)
    finally:
        rec.stop()
    assert rec.waves >= 1 and rec.dropped == 0


def pipelined_drain_journal(path):
    """A pipelined, candidate-pruned drain_backlog, recorded: its waves carry
    freeRows, the allocation entering them and their candidate lists."""
    from test_torch_trace import PRUNED, port_drain_journal

    records, *_ = port_drain_journal(path, harvest="pipeline", pruning=PRUNED, n=(14, 10, 10),
                                     wave_size=16)
    assert any("candidates" in r and "freeRows" in r for r in records if r.get("kind") == "wave")


DRAINS = {"replay": replay_drain_journal, "serving": serving_drain_journal,
          "pipelined": pipelined_drain_journal}


@pytest.mark.parametrize("drain", sorted(DRAINS))
def test_every_record_equals_the_general_path_and_both_readers_agree(tmp_path, captures,
                                                                      drain):
    """Every wave record of the drain, rendered from its capture, == json.dumps
    of the general path's record; the journal it lands in reads the same
    through the port's and the JAX package's read_journal, and replays on
    the port's plain versions with 0 divergences."""
    from grove_tpu.trace.recorder import read_journal as r_read
    from grove_tpu_torch.trace.replay import replay_journal

    seen, differ = captures
    DRAINS[drain](tmp_path / "j")
    assert seen and not differ, differ[:1]
    records = p_rec.read_journal(str(tmp_path / "j"))
    assert records == r_read(str(tmp_path / "j"))
    waves = [r for r in records if r.get("kind") == "wave"]
    assert waves and len(waves) <= len(seen)
    assert replay_journal(records, device="cpu").divergence_count == 0


def test_odd_captures_take_the_general_path_field_by_field():
    """Inputs the renderer does not take as they are — filtered maps that are
    not empty, a torch allocation table, an int-keyed free-row map, a plan
    of mappings that are not dicts, numpy parameters and candidates, gang
    names that are not str, verdicts of an unregistered type with .item(),
    a mesh and a pruning fingerprint — are built by the general path's own
    expressions: the same bytes as json.dumps of wave_record."""
    import collections

    import torch

    from grove_tpu_torch.solver.pruning import PruningConfig
    from test_torch_host import PORT
    from test_torch_trace import problem

    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(4, 3, 3))

    class Item:
        def __init__(self, v):
            self.v = v

        def item(self):
            return self.v

    names = [g.name for g in gangs]
    alloc = np.array(snap.allocated, copy=True)
    alloc[1] = [1.5, 0.0, -0.0, float("nan")][:alloc.shape[1]]
    base = dict(
        now=np.float32(3.25), wave="w-000001", fleet="d" * 32, pad_nodes=snap.capacity.shape[0],
        resources=snap.resource_names, alloc=alloc, node_names=snap.node_names, gangs=gangs,
        pods_by_name=pods, scheduled={"b", "a"}, bound_nodes={}, reuse_nodes={},
        spread_avoid={}, max_groups=4, max_sets=None, max_pods=8, pad_gangs_to=16,
        params=np.array([1.0, 4.0, 2.0, 8.0, 1.5], np.float32), portfolio=np.int64(4),
        escalate_portfolio=1, mesh=p_rec._mesh_doc({"portfolio": 2, "node": 4}),
        pruning=p_rec._pruning_doc(PruningConfig(enabled=True, max_candidates=64, min_fleet=8)),
        plan={names[0]: {"p": "n"}}, ok_by_name={names[0]: np.bool_(True), names[1]: Item(0)},
        valid_by_name={names[1]: Item(1)}, scores={names[0]: np.float32(0.7), names[1]: Item(2)},
        solve_seconds=0.125, free_rows=None, candidates=np.arange(5, dtype=np.int32),
    )
    odd = [
        {},
        {"bound_nodes": {names[0]: {"grp": np.array([3, 1])}, "elsewhere": {"g": [0]}},
         "reuse_nodes": {names[1]: (2, 0)}, "spread_avoid": {names[0]: [np.int32(5)]}},
        {"alloc": torch.as_tensor(alloc)},
        {"alloc": alloc.astype(np.float64), "resources": list(snap.resource_names)},
        {"alloc": np.nan_to_num(alloc).astype(np.int32)},
        {"free_rows": {snap.node_names[0]: np.float32([1, 2.5]), 7: [0.1]}},
        {"free_rows": {snap.node_names[0]: (1, 2)}},
        {"plan": collections.OrderedDict({names[0]: collections.OrderedDict({"p": "n"})})},
        {"candidates": None, "mesh": None, "pruning": None},
    ]
    for edit in odd:
        capture = tuple({**base, **edit}[k] for k in p_rec.CAPTURE)
        assert p_rec._wave_text(capture) == general_text(capture), edit
    renamed = [dataclasses.replace(g, name=i) for i, g in enumerate(gangs)]
    capture = tuple({**base, "gangs": renamed}[k] for k in p_rec.CAPTURE)
    assert p_rec._wave_text(capture) == general_text(capture)
    bad = tuple({**base, "params": [object()]}[k] for k in p_rec.CAPTURE)
    with pytest.raises(TypeError):
        p_rec._wave_text(bad)
    with pytest.raises(TypeError):
        p_rec._wave_text(bad[:-1])


def test_same_fleet_decides_as_the_python_comparison():
    """serde.same_fleet against recorder._same_fleet: equal fleets (new
    snapshots, new topology objects), and a fleet changed in each input the
    fleet record holds."""
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_cluster
    from grove_tpu_torch.state import build_snapshot

    def fleet(**edit):
        nodes = synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2,
                                  hosts_per_rack=4, cpu=8.0, tpu=0.0)
        n = nodes[1]
        if "label" in edit:
            n.labels["extra"] = edit["label"]
        if "taint" in edit:
            n.taints.append(edit["taint"])
        if "cpu" in edit:
            n.capacity["cpu"] = edit["cpu"]
        if "cordon" in edit:
            n.schedulable = False
        if "name" in edit:
            n.name = edit["name"]
        return build_snapshot(nodes, bench_topology())

    a = fleet()
    cases = [fleet(), fleet(label="x"), fleet(taint={"key": "k", "effect": "NoSchedule"}),
             fleet(cpu=4.0), fleet(cordon=True), fleet(name="other")]
    for b in cases:
        fast = serde.same_fleet(a, b)
        assert fast in (True, False) and fast == p_rec._same_fleet(a, b)
    assert serde.same_fleet(a, cases[0]) is True
    shifted = fleet()
    shifted.capacity = np.asfortranarray(shifted.capacity)
    assert serde.same_fleet(a, shifted) in (None, True)
    assert p_rec._same_fleet(a, shifted)


def test_a_given_back_text_is_reused_only_once_nothing_else_holds_it():
    """serde.recycle keeps the texts that nothing but the list holds;
    render_wave hands such a text's memory out again for a record of a size
    it takes, never a text still held, and every text keeps its own bytes."""
    from test_torch_host import PORT
    from test_torch_trace import problem

    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(4, 3, 3))
    base = dict(
        now=1.0, wave="w", fleet="d", pad_nodes=snap.capacity.shape[0],
        resources=snap.resource_names, alloc=snap.allocated, node_names=snap.node_names,
        gangs=gangs, pods_by_name=pods, scheduled=[], bound_nodes={}, reuse_nodes={},
        spread_avoid={}, max_groups=None, max_sets=None, max_pods=None, pad_gangs_to=None,
        params=[1.0], portfolio=1, escalate_portfolio=1, mesh=None, pruning=None, plan={},
        ok_by_name={}, valid_by_name={}, scores={}, solve_seconds=0.0, free_rows=None,
        candidates=None)

    def capture(wave):
        return tuple({**base, "wave": wave}[k] for k in p_rec.CAPTURE)

    texts = [p_rec._wave_text(capture(f"w{i}")) for i in range(4)]
    kept = texts[0]  # still held elsewhere: recycle must leave it
    given = {id(t) for t in texts[1:]}
    serde.recycle(texts)
    del texts
    copy = bytes(kept)
    reused = [p_rec._wave_text(capture(f"y{i}")) for i in range(3)]
    assert {id(t) for t in reused} == given
    assert all(t is not kept for t in reused) and bytes(kept) == copy
    for i, t in enumerate(reused):
        assert t == general_text(capture(f"y{i}"))
    fresh = p_rec._wave_text(capture("z"))
    assert fresh is not kept and id(fresh) not in given
