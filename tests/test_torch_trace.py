"""The flight recorder and deterministic replay of the port
(grove_tpu_torch/trace, plain PyTorch versions on the CPU) against the JAX
package, and the encode, pruning and solve() pieces replay needs:

  - the encoder's bound-node pins, candidate_pad / plan_candidates /
    plan_from_indices with a pad ladder and mesh axes 1 and 8, and solve()
    with pruning, each equal to the JAX package's;
  - the codec: the port's encode of port-decoded wave records equals the
    JAX package's encode of JAX-decoded ones, wave for wave; an unknown
    tag raises;
  - JAX-recorded journals (drains under harvest "pipeline", "scan" and
    "resident", a pruned drain with candidates, a pruned drain recorded
    under an 8-device mesh) replay through the port with 0 divergences;
  - the port's recorder journals what the JAX one journals for the same
    backlog (ok, plan, scores, freeRows, candidates, scheduled, allocated),
    and a port journal replays through the port with 0 divergences;
  - the JAX recorder tests' counterparts: a forged plan is a divergence, a
    schema mismatch is refused, rotated segments replay standalone, the
    bounded queue drops and counts, a missing fleet raises.

The controller journals, the sweep and the committed journal for the card
are in tests/test_torch_sweep.py.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest
import torch

from grove_tpu.solver import core as rc
from grove_tpu.solver import pruning as rp
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.warm import WarmPath
from grove_tpu.trace import recorder as r_rec
from grove_tpu.utils import serde as r_serde
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver import pruning as pp
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.trace import recorder as p_rec
from grove_tpu_torch.trace.replay import (
    encode_wave_record,
    nodes_from_fleet,
    replay_journal,
    snapshot_from_wave,
)
from grove_tpu_torch.utils import serde as p_serde
from test_torch_host import PORT, REF, _bench, expand_all
from torch_jax_programs import _release_jax_programs  # noqa: F401

# The backlogs of tests/test_tuning.py `_problem`: 160 nodes (one zone, two
# blocks, four racks each), 26 PodCliqueSets.
PROBLEM = dict(racks_per_block=4, n=(10, 8, 8))
PRUNED = dict(enabled=True, max_candidates=120, min_fleet=16, min_pad=8)
WAVE_FIELDS = ("ok", "plan", "scores", "valid", "freeRows", "candidates", "scheduled",
               "allocated", "fleet", "solver", "wave", "padGangsTo", "maxGroups", "maxSets",
               "maxPods", "padNodesTo", "resources", "boundNodes")


def problem(P, racks_per_block=4, n=(10, 8, 8)):
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.synthetic_backlog(*n), topo)
    nodes = P.wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=racks_per_block)
    return gangs, pods, P.build_snapshot(nodes, topo)


def jax_drain_journal(path, *, wave_size=8, harvest="pipeline", pruning=None, mesh=None,
                      **kw):
    """A JAX drain of the problem backlog, journaled: (records, bindings, stats)."""
    gangs, pods, snap = problem(REF, **kw)
    rec = r_rec.TraceRecorder(str(path))
    rec.start()
    try:
        bindings, stats = r_drain(
            gangs, pods, snap, wave_size=wave_size, warm_path=WarmPath(), harvest=harvest,
            pruning=None if pruning is None else rp.PruningConfig(**pruning), recorder=rec,
            mesh=mesh,
        )
    finally:
        rec.stop()
    return r_rec.read_journal(str(path)), bindings, stats


def port_drain_journal(path, *, wave_size=8, harvest="pipeline", pruning=None, **kw):
    """The same backlog drained by the port (plain versions) with its own
    recorder: (records, bindings, stats, recorder)."""
    gangs, pods, snap = problem(PORT, **kw)
    rec = p_rec.TraceRecorder(str(path))
    rec.start()
    try:
        bindings, stats = p_drain(
            gangs, pods, snap, wave_size=wave_size, harvest=harvest,
            pruning=None if pruning is None else pp.PruningConfig(**pruning), recorder=rec,
            device="cpu",
        )
    finally:
        rec.stop()
    return p_rec.read_journal(str(path)), bindings, stats, rec


def waves_of(records):
    return [r for r in records if r.get("kind") == "wave"]


@pytest.fixture(scope="module")
def jax_journals(tmp_path_factory):
    """JAX-recorded drain journals, by name."""
    d = tmp_path_factory.mktemp("jax_journals")
    out = {h: jax_drain_journal(d / h, harvest=h)[0] for h in ("pipeline", "scan", "resident")}
    out["pruned"] = jax_drain_journal(d / "pruned", pruning=PRUNED, n=(14, 10, 10),
                                      wave_size=16)[0]
    return out


# ---- step 1: pins, the pad ladder and the mesh axis, solve()'s pruned path ----


def test_encoder_pins_byte_equal_to_jax():
    rg, rpods, rs = _bench(REF, n=(8, 6, 6))
    pg, ppods, ps = _bench(PORT, n=(8, 6, 6))
    n = rs.capacity.shape[0]
    # Every other gang partly bound: each group's first pod on a node, and
    # for odd gangs a group name that is not one of the gang's (a group an
    # incremental sub-gang dropped still anchors the gang-level pin).
    bound = {}
    for i, g in enumerate(rg):
        if i % 2:
            continue
        per = {grp.name: [(7 * i + 3 * k) % n] for k, grp in enumerate(g.spec.pod_groups)}
        if i % 4 == 2:
            per = {"dropped-group": [(11 * i) % n]}
        bound[g.name] = per
    rb, _ = REF.encode_gangs(rg, rpods, rs, bound_nodes_by_group=bound)
    pb, _ = PORT.encode_gangs(pg, ppods, ps, bound_nodes_by_group=bound)
    assert (np.asarray(rb.set_pinned) >= 0).sum() > 4
    for name in rb._fields:
        a, b = getattr(rb, name), getattr(pb, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("mesh_axis", [1, 8])
@pytest.mark.parametrize("ladder", [(), (20, 60, 100, 300), (12,)])
def test_pad_ladder_and_mesh_axis_byte_equal(ladder, mesh_axis):
    rg, rpods, rs = problem(REF, racks_per_block=2, n=(6, 4, 5))
    pg, ppods, ps = problem(PORT, racks_per_block=2, n=(6, 4, 5))
    rb, _ = REF.encode_gangs(rg, rpods, rs)
    pb, _ = PORT.encode_gangs(pg, ppods, ps)
    fields = dict(enabled=True, max_candidates=40, min_fleet=16, min_pad=8, pad_ladder=ladder)
    rcfg, pcfg = rp.PruningConfig(**fields), pp.PruningConfig(**fields)
    for count in (0, 5, 11, 19, 59, 99, 299, 400):
        assert pp.candidate_pad(count, pcfg, mesh_axis) == rp.candidate_pad(
            count, rcfg, mesh_axis), count
    rplan = rp.plan_candidates(rs, rb, rcfg, mesh_axis=mesh_axis)
    pplan = pp.plan_candidates(ps, pb, pcfg, mesh_axis=mesh_axis)
    if ladder == (12,):
        assert rplan is None and pplan is None, "no ladder entry fits"
        with pytest.raises(ValueError, match="pad ladder"):
            pp.plan_from_indices(ps, np.arange(40), pcfg, 4, mesh_axis)
        return
    assert rplan is not None and pplan is not None
    cand = rplan.idx[::2]
    rebuilt = (rp.plan_from_indices(rs, cand, rcfg, rb.gang_valid.shape[0], mesh_axis),
               pp.plan_from_indices(ps, cand, pcfg, pb.gang_valid.shape[0], mesh_axis))
    for r_plan, p_plan in ((rplan, pplan), rebuilt):
        for f in ("count", "pad", "fleet_pad", "clipped"):
            assert getattr(r_plan, f) == getattr(p_plan, f), f
        for f in ("idx", "gang_lossy", "capacity", "schedulable", "node_domain_id",
                  "num_domains"):
            a, b = getattr(r_plan, f), getattr(p_plan, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        free = np.asarray(rs.free, np.float32)
        assert np.array_equal(r_plan.gather_free(free), p_plan.gather_free(free))
        asg = np.random.default_rng(3).integers(-1, p_plan.count, (5, 7)).astype(np.int32)
        assert np.array_equal(r_plan.remap_assigned(asg), p_plan.remap_assigned(asg))
    assert not rebuilt[1].gang_lossy.any()


def _jax_solve(snap, batch, **kw):
    res = rc.solve(snap, batch, rc.SolverParams(), **kw)
    return [np.asarray(x) for x in (res.assigned, res.ok, res.placement_score, res.free_after)]


def _one_block(P, racks, n):
    """tests/test_pruning.py `_setup`: one zone, one block, `racks` racks."""
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.synthetic_backlog(*n), topo)
    nodes = P.wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=racks)
    return gangs, pods, P.build_snapshot(nodes, topo)


@pytest.mark.parametrize("escalate", [1, 4])
@pytest.mark.parametrize("fleet", ["racks4", "clipped"])
def test_pruned_solve_equals_jax(fleet, escalate):
    """solve(pruning=...) against the JAX solve, with and without portfolio
    escalation: a 4-rack fleet, and a clipped 2-rack one whose lossy
    rejections re-solve dense."""
    racks, n, budget = (4, (6, 4, 5), 60) if fleet == "racks4" else (2, (10, 10, 10), 24)
    cfg = dict(enabled=True, max_candidates=budget, min_fleet=16, min_pad=8)
    rg, rpods, rs = _one_block(REF, racks, n)
    pg, ppods, ps = _one_block(PORT, racks, n)
    rb, _ = REF.encode_gangs(rg, rpods, rs)
    pb, _ = PORT.encode_gangs(pg, ppods, ps)
    rplan = rp.plan_candidates(rs, rb, rp.PruningConfig(**cfg))
    assert rplan is not None and (rplan.clipped or fleet == "racks4")
    want = _jax_solve(rs, rb, pruning=rp.PruningConfig(**cfg), escalate_portfolio=escalate)
    got = pc.solve(ps, pb, pc.SolverParams(), pruning=pp.PruningConfig(**cfg),
                   escalate_portfolio=escalate, device="cpu")
    for f, a, b in zip(("assigned", "ok", "placement_score", "free_after"), want, got):
        b = b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---- the codec --------------------------------------------------------------


def test_port_decode_encodes_like_jax_on_every_wave(jax_journals):
    """On every wave of every test journal the port's encode of the
    port-decoded gangs and pods equals the JAX package's encode of the
    JAX-decoded ones, array for array."""
    from grove_tpu.trace import replay as r_replay

    checked = 0
    for name, records in jax_journals.items():
        fleets = {r["digest"]: r for r in records if r.get("kind") == "fleet"}
        for w in waves_of(records):
            fleet = fleets[w["fleet"]]
            rsnap = r_replay.snapshot_from_wave(w, fleet)
            rb, rdec = REF.encode_gangs(
                [r_serde.decode(d) for d in w["gangs"]],
                {n: r_serde.decode(d) for n, d in w["pods"].items()}, rsnap,
                max_groups=w.get("maxGroups"), max_sets=w.get("maxSets"),
                max_pods=w.get("maxPods"), pad_gangs_to=w.get("padGangsTo"),
                scheduled_gangs=set(w.get("scheduled", [])),
                bound_nodes_by_group=w.get("boundNodes") or None,
                reuse_nodes_by_gang=w.get("reuseNodes") or None,
                spread_avoid_by_gang=w.get("spreadAvoid") or None,
            )
            psnap = snapshot_from_wave(w, fleet, nodes=nodes_from_fleet(fleet))
            pb, pdec = encode_wave_record(w, psnap)
            for f in rb._fields:
                a, b = getattr(rb, f), getattr(pb, f)
                assert (a is None) == (b is None), (name, f)
                if a is not None:
                    a = np.asarray(a)
                    assert a.dtype == b.dtype and np.array_equal(a, b), (name, w["wave"], f)
            assert rdec.gang_names == pdec.gang_names and rdec.pod_names == pdec.pod_names
            for arr in ("capacity", "allocated", "schedulable", "node_domain_id"):
                assert np.array_equal(getattr(rsnap, arr), getattr(psnap, arr)), arr
            checked += 1
    assert checked >= 20


def test_codec_drops_fields_the_port_lacks_and_refuses_unknown_tags():
    gangs, pods, _ = _bench(REF, n=(1, 0, 0))
    doc = r_serde.encode(gangs[0])
    assert "status" in doc and "queue" in doc
    port_gang = p_serde.decode(doc)
    assert type(port_gang).__module__ == "grove_tpu_torch.api.podgang"
    assert port_gang.name == gangs[0].name and port_gang.total_pods() == gangs[0].total_pods()
    assert p_serde.decode(p_serde.encode(port_gang)) == port_gang
    pod = next(iter(pods.values()))
    port_pod = p_serde.decode(r_serde.encode(pod))
    assert port_pod.spec.total_requests() == pod.spec.total_requests()
    # The port's host model carries every field of the JAX package's Pod and
    # PodGang (status, queue, phase, gates, ...): a JAX document round-trips
    # through the port's codec unchanged.
    assert p_serde.encode(port_gang) == doc
    assert p_serde.encode(port_pod) == r_serde.encode(pod)
    assert type(p_serde.decode({"!t": "PodGangStatus", "phase": {"!e": "PodGangPhase",
                                                                 "v": "Pending"}})).__module__ \
        == "grove_tpu_torch.api.podgang"
    # A field the port's type lacks is still dropped without being decoded.
    extra = dict(r_serde.encode(pod), no_such_field={"!t": "NoSuchType"})
    assert p_serde.decode(extra) == port_pod
    with pytest.raises(KeyError, match="not registered"):
        p_serde.decode([{"!t": "NoSuchType"}])
    assert p_serde.decode({"!u": [1, {"!s": [2, 3]}], "!d": 0}) == (1, {2, 3})


# ---- replay of JAX journals ----------------------------------------------------


@pytest.mark.parametrize("name", ["pipeline", "scan", "resident", "pruned"])
def test_port_replays_jax_drain_journal_exactly(jax_journals, name):
    records = jax_journals[name]
    waves = waves_of(records)
    assert len(waves) >= 3
    if name == "pruned":
        assert any(w.get("candidates") is not None for w in waves)
    assert all(w.get("freeRows") for w in waves[1:]), "a drain journals its entering free"
    report = replay_journal(records, device="cpu")
    assert len(report.waves) == len(waves)
    assert report.divergence_count == 0, report.to_doc()
    for w in report.waves:
        assert w.replayed_admitted == w.recorded_admitted


def test_port_replays_jax_pruned_mesh_journal_exactly(tmp_path):
    """tests/test_tuning.py:185-225's journal: pruned and recorded under an
    8-device mesh; the rebuilt candidate pad honours the recorded axis."""
    from grove_tpu.parallel.mesh import MeshConfig

    records, _, stats = jax_drain_journal(
        tmp_path / "j", wave_size=16, pruning=PRUNED, mesh=MeshConfig(enabled=True, min_nodes=64),
        racks_per_block=4, n=(14, 10, 10),
    )
    waves = waves_of(records)
    assert stats.pruned_waves > 0
    assert all(w["solver"]["mesh"] == {"portfolio": 1, "node": 8} for w in waves)
    assert any(w.get("candidates") is not None for w in waves)
    report = replay_journal(records, device="cpu")
    assert report.divergence_count == 0, report.to_doc()


# ---- the port's recorder --------------------------------------------------------


@pytest.mark.parametrize("harvest,pruning", [("pipeline", None), ("scan", None),
                                             ("chained", PRUNED)])
def test_port_journal_equals_jax_journal(tmp_path, harvest, pruning):
    kw = dict(harvest=harvest, pruning=pruning)
    if pruning is not None:
        kw.update(n=(14, 10, 10), wave_size=16)
    jrec, jb, jst = jax_drain_journal(tmp_path / "jax", **kw)
    precs, pb, pst, rec = port_drain_journal(tmp_path / "port", **kw)
    assert pb == jb
    assert pst.journaled_waves == jst.journaled_waves == pst.waves and rec.dropped == 0
    jw, pw = waves_of(jrec), waves_of(precs)
    assert len(jw) == len(pw) >= 3
    for a, b in zip(jw, pw):
        for f in WAVE_FIELDS:
            assert a.get(f) == b.get(f), (a["wave"], f)
    if pruning is not None:
        assert any(w.get("candidates") for w in pw)
    assert {r["digest"] for r in jrec if r["kind"] == "fleet"} == {
        r["digest"] for r in precs if r["kind"] == "fleet"}
    report = replay_journal(precs, device="cpu")
    assert report.divergence_count == 0, report.to_doc()
    assert p_rec.journal_stats(str(tmp_path / "port"))["dropped"] == 0


def test_port_replay_detects_a_forged_plan(jax_journals):
    records = json.loads(json.dumps(jax_journals["pipeline"]))
    forged = None
    for rec in waves_of(records):
        if rec["plan"]:
            gang, bindings = next(iter(rec["plan"].items()))
            pod = next(iter(bindings))
            bindings[pod] = "node-that-never-was"
            forged = gang
            break
    report = replay_journal(records, device="cpu")
    assert report.divergence_count >= 1
    divs = [d for w in report.waves for d in w.divergences]
    assert any(d["gang"] == forged and d["type"] == "bindings" for d in divs)


def test_read_journal_refuses_a_schema_mismatch(tmp_path):
    path = tmp_path / "journal"
    path.mkdir()
    (path / "segment-000000.json").write_text(
        json.dumps({"version": p_rec.SCHEMA_VERSION + 1, "records": []}))
    with pytest.raises(p_rec.TraceSchemaError, match="schema version"):
        p_rec.read_journal(str(path))
    with pytest.raises(FileNotFoundError):
        p_rec.read_journal(str(tmp_path / "none"))


def test_port_segments_rotate_and_replay_standalone(tmp_path):
    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(4, 3, 3))
    rec = p_rec.TraceRecorder(str(tmp_path / "j"), max_records_per_file=2, max_files=64)
    rec.start()
    _, stats = p_drain(gangs, pods, snap, wave_size=4, recorder=rec, device="cpu")
    rec.stop()
    segments = sorted(f for f in os.listdir(rec.path) if f.startswith("segment-"))
    assert len(segments) >= 2 and stats.journaled_waves == stats.waves
    replayed = 0
    for seg in segments:
        records = p_rec.read_journal(os.path.join(rec.path, seg))
        wave_digests = {r["fleet"] for r in records if r["kind"] == "wave"}
        assert wave_digests <= {r["digest"] for r in records if r["kind"] == "fleet"}, seg
        if wave_digests:
            assert replay_journal(records, device="cpu").divergence_count == 0
            replayed += 1
    assert replayed >= 2
    manifest = p_rec.read_manifest(rec.path)
    assert manifest["waves"] == stats.waves and not p_rec.journal_truncated(rec.path)


class _StrEnum(str, enum.Enum):
    A = "a\u00e9"


class _IntEnum(enum.IntEnum):
    B = 7


class _Enum(enum.Enum):
    C = (1, "c")


@dataclasses.dataclass
class _Inner:
    x: float = 0.5
    tags: tuple = ("t",)


@dataclasses.dataclass
class _Outer:
    name: str = "o"
    inner: list = dataclasses.field(default_factory=lambda: [_Inner(), _Inner(x=-0.0)])
    keys: dict = dataclasses.field(default_factory=lambda: {1: "one", "two": 2})
    big: int = 2**80
    nothing: object = None


@dataclasses.dataclass
class _Empty:
    pass


ODD_VALUES = [1, -2.5, float("nan"), float("inf"), -float("inf"), True, None, "é\n\"q",
              (1, "a"), {1: 2, "a": (3,)}, {"b": {2.0: None}}, {3, 1}, frozenset(), [],
              {}, (), [[1, "x"], {"k": [None, 0.1]}], _StrEnum.A, _IntEnum.B, _Enum.C,
              {"e": [_StrEnum.A, _IntEnum.B]}, {_IntEnum.B: _Enum.C},
              2**63, -(2**70), 1e-310, np.float64(2.25), "", "\x00\x1f\x7f\"\\/\t",
              "☃ snow \U0001F600", [[], {}, ()], {3: 4, None: 5}, {frozenset({1})},
              _Outer(), [_Outer(), _Empty()], _Empty(), {"k": _Outer()}]


@pytest.mark.parametrize("value", ODD_VALUES, ids=range(len(ODD_VALUES)))
def test_serde_dumps_is_json_dumps_of_encode(value):
    assert p_serde.dumps(value) == json.dumps(p_serde.encode(value))


def test_serde_dumps_of_gangs_and_pods_is_json_dumps_of_encode():
    gangs, pods, _ = problem(PORT, racks_per_block=2, n=(3, 2, 2))
    pods = list(pods.values()) if isinstance(pods, dict) else list(pods)
    pods[0].conditions.append(p_serde._lookup("Condition")(type="Ready", status="True"))
    for obj in gangs + pods:
        assert p_serde.dumps(obj) == json.dumps(p_serde.encode(obj)), obj.name


def test_port_segments_are_json_dumps_of_their_records(tmp_path):
    """The writer renders each record once and splices the texts into every
    rewrite of its segment: each segment on disk is byte for byte
    json.dumps of the document it holds, across flushes and rotation."""
    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(4, 3, 3))
    rec = p_rec.TraceRecorder(str(tmp_path / "j"), max_records_per_file=5, max_files=64)
    rec.start()
    p_drain(gangs[: len(gangs) // 2], pods, snap, wave_size=4, recorder=rec, device="cpu")
    assert rec.flush()  # a segment written, then rewritten with more records
    rec.capture_action(1.0, "preempt", "gang-x", reason="test")
    p_drain(gangs[len(gangs) // 2:], pods, snap, wave_size=4, recorder=rec, device="cpu")
    rec.stop()
    segments = sorted(f for f in os.listdir(rec.path) if f.startswith("segment-"))
    assert len(segments) >= 2 and rec.segments_written > len(segments), rec.stats()
    for seg in segments:
        text = open(os.path.join(rec.path, seg)).read()
        assert text == json.dumps(json.loads(text)), seg


def test_port_recorder_bounded_queue_drops_and_counts(tmp_path):
    recorder = p_rec.TraceRecorder(str(tmp_path / "j"), queue_size=1)
    assert recorder.record({"kind": "action", "now": 0.0, "action": "x", "object": "a"})
    assert not recorder.record({"kind": "action", "now": 0.0, "action": "x", "object": "b"})
    assert recorder.dropped == 1 and recorder.stats()["dropped"] == 1
    # A drain whose recorder drops keeps binding: journaling never breaks it.
    gangs, pods, snap = problem(PORT, racks_per_block=2, n=(2, 2, 2))
    full = p_rec.TraceRecorder(str(tmp_path / "k"), queue_size=1)
    full.record({"kind": "action", "now": 0.0, "action": "x", "object": "a"})
    bindings, stats = p_drain(gangs, pods, snap, wave_size=4, recorder=full, device="cpu")
    assert stats.admitted == len(gangs) and stats.journaled_waves == 0 and full.dropped > 0


def test_port_replay_raises_on_a_missing_fleet(jax_journals):
    records = [r for r in jax_journals["pipeline"] if r.get("kind") != "fleet"]
    with pytest.raises(ValueError, match="does not contain"):
        replay_journal(records, device="cpu")


def test_replay_runs_on_the_card_unless_asked_for_the_cpu(jax_journals):
    if torch.cuda.is_available():
        pytest.skip("a card is present: replay runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_journal(jax_journals["pipeline"])
