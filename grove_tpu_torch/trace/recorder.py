"""The decision flight recorder: journal every solve wave, its file I/O off
the hot path (grove_tpu/trace/recorder.py counterpart).

The journal is a directory of SELF-CONTAINED segment files, each an atomic
JSON document `{"version": N, "records": [...]}` written via the shared
temp-file+rename primitive (`utils/fsio.StagedFile`) — readers never
see a torn segment, and rotation/pruning cannot corrupt older ones. Two
record kinds matter to replay:

  fleet   the cluster fleet at one instant (nodes + topology), content-
          addressed by digest and deduplicated — a wave references its fleet
          by digest instead of re-serializing 5k nodes per tick. The writer
          re-emits the referenced fleet record into every segment so each
          segment replays standalone even after older segments are pruned.
  wave    one solve wave: the exact encode inputs (serde-encoded sub-gangs
          and their referenced pods, allocated rows, bound/reuse/spread
          seeds, bucketing pads), the solver config fingerprint (weights,
          portfolio, effective escalation width), the resulting plan with
          per-gang verdicts/scores/rejection reasons, and timings.

Everything else (`action` records: preemption, reclaim, defrag migration,
rolling updates, gang termination, sim chaos) is narrative for incident
forensics — replay re-solves wave records only. The port's drains journal
their waves here (solver/drain.py); a port journal and a JAX one share the
schema and the fleet digests.

Hot-path discipline: `capture_wave` runs on the commit path, before the
binding loop edits the pods, and renders the wave record to its JSON text
there (`_wave_text`: the C renderer of utils/csrc writes the record straight
from the capture tuple the commit path already holds, with no dict built,
byte for byte the record the JAX recorder builds at capture time;
`wave_record` is the general path, field by field; the text is a
bytearray, and the writer gives a segment's texts back (`serde.recycle`)
when it lets the segment go, so the next records take that memory and do
not fault in new pages). So nothing is copied, and the queue holds text,
which the collector does not track: a capture that waited a flush interval
for the writer as an object graph (pod copies) was promoted into the oldest
generation and made full collections come sooner. The writer keeps each
record's bytes and each manifest entry's text, so a write costs the new
records and the file I/O, not a re-encoding. Each pass of its thread
stages the next files (`_Journal.stage`: the temporary file made, the open
segment's bytes so far written) and releases the files the last writes
replaced, so a write after a pass is one writev and one rename per file;
flush() writes on its caller's thread, which would only wait for the
writer's otherwise. A full queue DROPS the record and counts it
(`dropped`) rather than blocking a solve.
"""

from __future__ import annotations

import collections
import glob
import hashlib
import json
import os
import resource
import threading
import time
from typing import Any, Optional

import numpy as np

from grove_tpu_torch.api import pod as pod_mod
from grove_tpu_torch.api import podgang as podgang_mod
from grove_tpu_torch.api import types as types_mod
from grove_tpu_torch.state import cluster as state_mod
from grove_tpu_torch.utils import serde
from grove_tpu_torch.utils.fsio import FILE_STEPS, TEMP_PREFIX, StagedFile

# Journal schema, the JAX package's: either package reads the other's
# journals. The replayer refuses a mismatched version outright: a silent
# best-effort parse of an old journal would "replay" different solver inputs
# and report fake divergence (or fake equivalence).
SCHEMA_VERSION = 1

_SEGMENT_GLOB = "segment-*.json"
# A segment's text up to its first record.
_SEGMENT_HEAD = (json.dumps({"version": SCHEMA_VERSION})[:-1] + ', "records": [').encode()
# The caller's wall inside flush(), in its order: the wait for the writer's
# lock ("wake"), the queue's drain, the segment write, the manifest write,
# and the rest until the return ("handback").
FLUSH_PARTS = ("wake", "drain", "segment", "manifest", "handback")
# The parts of TraceRecorder.stats(split=True), in the order of a record's
# way to disk, then the writer's start-up and the flush with its parts.
SPLIT_PARTS = ("capture", "render", "segment", "manifest", "startup", "flush") + tuple(
    f"flush.{part}" for part in FLUSH_PARTS)
_MANIFEST = "manifest.json"
# The manifest's text up to its first segment entry.
_MANIFEST_HEAD = (json.dumps({"version": SCHEMA_VERSION})[:-1] + ', "segments": [').encode()


# A wave's capture, as TraceRecorder.capture_wave hands it to the renderer:
# a plain tuple in this order (utils/csrc/serde_render.c reads the slots by
# position). `fleet` is the fleet's digest; `pad_nodes`, `resources`,
# `alloc` (the allocation entering the wave) and `node_names` are the
# snapshot's; `mesh` and `pruning` are their record fields (_mesh_doc,
# _pruning_doc); the rest are capture_wave's arguments.
CAPTURE = (
    "now", "wave", "fleet", "pad_nodes", "resources", "alloc", "node_names", "gangs",
    "pods_by_name", "scheduled", "bound_nodes", "reuse_nodes", "spread_avoid",
    "max_groups", "max_sets", "max_pods", "pad_gangs_to", "params", "portfolio",
    "escalate_portfolio", "mesh", "pruning", "plan", "ok_by_name", "valid_by_name",
    "scores", "solve_seconds", "free_rows", "candidates",
)
WaveCapture = collections.namedtuple("WaveCapture", CAPTURE)


def _mesh_doc(mesh: dict | None):
    # Mesh fingerprint (parallel/mesh.SolveLayout.fingerprint): the
    # device-mesh layout the recorded solve ran under. The sharded solve is
    # bitwise-equal to the unsharded one, so a replay host with fewer
    # devices still replays bitwise — but the pruning candidate pad is
    # negotiated mesh-divisible, so replay needs the recorded node-axis size
    # to rebuild the exact launch shape (trace/replay.py).
    if not mesh or int(mesh.get("node", 1)) <= 1:
        return None
    return {"portfolio": int(mesh.get("portfolio", 1)), "node": int(mesh["node"])}


def _pruning_doc(pruning):
    # Candidate-pruning fingerprint: replay must route through the same
    # pruned path (pruned placements legitimately differ from dense ones)
    # for bitwise equivalence.
    if pruning is None or not getattr(pruning, "enabled", False):
        return None
    return {
        "enabled": True,
        "maxCandidates": int(pruning.max_candidates),
        "padLadder": [int(x) for x in pruning.pad_ladder],
        "minPad": int(pruning.min_pad),
        "minFleet": int(pruning.min_fleet),
    }


def _allocated_rows(alloc, node_names) -> dict:
    """The rows with any allocation, by node name (f32 -> the same Python
    floats float() gives)."""
    alloc = np.asarray(alloc)
    n_real = len(node_names)
    return {node_names[i]: alloc[i].tolist()
            for i in np.flatnonzero(alloc[:n_real].any(axis=1)).tolist()}


def _names(c: WaveCapture) -> set:
    return {g.name for g in c.gangs}


def _rejections(c: WaveCapture) -> dict:
    out = {}
    for name in _names(c):
        if _jsonable(c.ok_by_name.get(name, False)):
            continue
        out[name] = (
            "rejected (capacity/constraints)"
            if _jsonable(c.valid_by_name.get(name, False))
            else "not solver-valid (gated base or unresolvable constraint)"
        )
    return out


# The wave record's fields, in the JAX recorder's order, each the expression
# of its value on a capture (the general path); "freeRows" and "candidates"
# are in the record only where the capture has them (wave_record).
_WAVE_FIELDS = {
    "kind": lambda c: "wave",
    "now": lambda c: float(c.now),
    "wave": lambda c: c.wave,
    "fleet": lambda c: c.fleet,
    "padNodesTo": lambda c: int(c.pad_nodes),
    "resources": lambda c: list(c.resources),
    "allocated": lambda c: _allocated_rows(c.alloc, c.node_names),
    "gangs": lambda c: c.gangs,
    "pods": lambda c: {n: c.pods_by_name[n] for n in sorted({
        r.name
        for g in c.gangs
        for grp in g.spec.pod_groups
        for r in grp.pod_references
        if r.name in c.pods_by_name
    })},
    "scheduled": lambda c: sorted(c.scheduled),
    "boundNodes": lambda c: {
        g: {grp: list(map(int, idx)) for grp, idx in per.items()}
        for g, per in c.bound_nodes.items()
        if g in _names(c)
    },
    "reuseNodes": lambda c: {
        g: list(map(int, idx)) for g, idx in c.reuse_nodes.items() if g in _names(c)
    },
    "spreadAvoid": lambda c: {
        g: list(map(int, idx)) for g, idx in c.spread_avoid.items() if g in _names(c)
    },
    "maxGroups": lambda c: c.max_groups,
    "maxSets": lambda c: c.max_sets,
    "maxPods": lambda c: c.max_pods,
    "padGangsTo": lambda c: c.pad_gangs_to,
    "solver": lambda c: {
        "params": [float(w) for w in c.params],
        "portfolio": int(c.portfolio),
        "escalatePortfolio": int(c.escalate_portfolio),
        "mesh": c.mesh,
        "pruning": c.pruning,
    },
    "plan": lambda c: {g: dict(b) for g, b in c.plan.items()},
    "ok": lambda c: {n: bool(_jsonable(c.ok_by_name.get(n, False))) for n in sorted(_names(c))},
    "valid": lambda c: {n: bool(_jsonable(c.valid_by_name.get(n, False)))
                        for n in sorted(_names(c))},
    "scores": lambda c: {n: float(_jsonable(c.scores.get(n, 0.0))) for n in sorted(_names(c))},
    "rejections": _rejections,
    "solveSeconds": lambda c: float(c.solve_seconds),
    "freeRows": lambda c: {str(n): [float(v) for v in row] for n, row in c.free_rows.items()},
    "candidates": lambda c: [int(i) for i in c.candidates],
}


def wave_field(key: str, capture: tuple):
    """The general path's value of the wave record's field `key`."""
    return _WAVE_FIELDS[key](WaveCapture._make(capture))


def wave_record(capture: tuple) -> dict:
    """The wave record the JAX recorder builds, field for field and in its
    order, from a capture (the general path: `_wave_text` renders the same
    bytes without building it)."""
    c = WaveCapture._make(capture)
    rec = {key: fn(c) for key, fn in _WAVE_FIELDS.items()
           if key not in ("freeRows", "candidates")}
    if c.free_rows:
        rec["freeRows"] = _WAVE_FIELDS["freeRows"](c)
    if c.candidates is not None:
        rec["candidates"] = _WAVE_FIELDS["candidates"](c)
    return rec


def _wave_text(capture: tuple) -> bytearray:
    """The JSON text of one capture's wave record:
    `json.dumps(serde.encode(wave_record(capture))).encode()`, rendered by the
    C renderer from the capture as it is (`serde.render_wave`, a bytearray)."""
    return serde.render_wave(capture, wave_field)


for _m in (types_mod, pod_mod, podgang_mod, state_mod):
    serde.register_module(_m)
serde.SCALAR_TYPES.update((np.bool_, np.float32, np.float64, np.int32, np.int64))


class TraceSchemaError(ValueError):
    """Journal version does not match this build's SCHEMA_VERSION."""


def _jsonable(x: Any) -> Any:
    """Coerce numpy scalars riding in verdict/score maps to plain JSON."""
    if hasattr(x, "item"):
        return x.item()
    return x


def fleet_payload(snapshot) -> dict:
    """Fleet record body derived from the snapshot itself (the padded rows
    are excluded — padding is re-derived at replay from `padNodesTo`)."""
    nodes = []
    for i, name in enumerate(snapshot.node_names):
        cap = {
            res: float(snapshot.capacity[i, j])
            for j, res in enumerate(snapshot.resource_names)
            if float(snapshot.capacity[i, j])
        }
        nodes.append(
            {
                "name": name,
                "capacity": cap,
                "labels": dict(snapshot.node_labels[i]),
                "taints": list(snapshot.node_taints[i]),
                "schedulable": bool(snapshot.schedulable[i]),
            }
        )
    return {
        "kind": "fleet",
        "topology": snapshot.topology.levels_doc(),
        "nodes": nodes,
    }


def fleet_digest_of(snapshot) -> tuple[str, dict]:
    """(digest, payload) for the snapshot's fleet; memoized on the snapshot
    object (immutable for its lifetime — defrag mutates only `allocated`,
    which the fleet payload excludes)."""
    cached = getattr(snapshot, "_trace_fleet", None)
    if cached is not None:
        return cached
    payload = fleet_payload(snapshot)
    digest = hashlib.blake2b(
        json.dumps(payload, sort_keys=True).encode(), digest_size=16
    ).hexdigest()
    payload["digest"] = digest
    snapshot._trace_fleet = (digest, payload)
    return digest, payload


# The JSON text of each captured fleet payload, by digest, for the process
# (at most _FLEET_TEXTS_MAX of them): a recorder started anew, as each
# window of the replay reading starts one, writes a fleet the process has
# written before without encoding it again. The digest hashes the
# payload's content; two snapshots with one digest are one fleet to the
# capture path too (_fleet_of), which reuses the first's payload.
_FLEET_TEXTS: dict[str, bytes] = {}
_FLEET_TEXTS_MAX = 8


def _fleet_text(digest: str, payload: dict) -> bytes:
    text = _FLEET_TEXTS.get(digest)
    if text is None:
        text = json.dumps(payload).encode()
        if len(_FLEET_TEXTS) >= _FLEET_TEXTS_MAX:
            _FLEET_TEXTS.clear()
        _FLEET_TEXTS[digest] = text
    return text


def _same_fleet(a, b) -> bool:
    """True when two snapshots give equal `fleet_payload`s: its inputs,
    compared as they are (equal topology levels give equal levels_doc)."""
    n = len(a.node_names)
    return (a.node_names == b.node_names and a.resource_names == b.resource_names
            and a.capacity.dtype == b.capacity.dtype
            and a.capacity[:n].tobytes() == b.capacity[:n].tobytes()
            and a.schedulable[:n].tobytes() == b.schedulable[:n].tobytes()
            and a.node_labels == b.node_labels and a.node_taints == b.node_taints
            and (a.topology is b.topology
                 or a.topology.levels == b.topology.levels
                 or a.topology.levels_doc() == b.topology.levels_doc()))


class TraceRecorder:
    """Bounded-queue journal writer with atomic segment rotation."""

    def __init__(
        self,
        path: str,
        *,
        max_records_per_file: int = 256,
        max_files: int = 16,
        queue_size: int = 2048,
        flush_interval_seconds: float = 1.0,
    ) -> None:
        self.path = path
        self.max_records_per_file = max(1, int(max_records_per_file))
        self.max_files = max(1, int(max_files))
        self.flush_interval_seconds = float(flush_interval_seconds)
        # Captures waiting for the writer: appended on the commit path and
        # taken by the writer thread (deque's append and popleft are atomic),
        # at most `queue_size` of them.
        self._queue: collections.deque = collections.deque()
        self._queue_size = max(1, int(queue_size))
        self._stop = threading.Event()
        # An asynchronous flush request (request_flush), served by the
        # writer thread's next pass.
        self._flush_now = threading.Event()
        # The writer's state (_Journal, from start() to stop()) and the lock
        # each use of it holds: the writer thread's passes, and flush(),
        # which writes on its caller's thread.
        self._io_lock = threading.Lock()
        self._journal: Optional[_Journal] = None
        # Set once the writer has read and rewritten the manifest: start()
        # returns after that, so the writer's start-up file I/O never
        # overlaps the solves it journals.
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters (stats(), journal_stats)
        self.recorded = 0
        self.dropped = 0
        self.segments_written = 0
        self.waves = 0
        self.actions = 0
        # Write-failure survival (ENOSPC, torn disk): the writer thread NEVER dies on an OSError — it drops the
        # segment, counts every record in it as dropped, latches `degraded`,
        # and keeps consuming the queue so the hot path stays unblocked. A
        # later successful write clears `degraded` (disk recovered) but the
        # cumulative write_errors counter persists — and is stamped into
        # every subsequent segment so an offline reader can see the episode
        # offline.
        self.write_errors = 0
        self.degraded = False
        self._last_write_error: Optional[str] = None
        # Segment manifest bookkeeping: the writer maintains manifest.json
        # beside the segments (atomic like them) so tail replay can find its
        # resume point — last journaled wave id, per-segment wave ranges,
        # fleet digests — without opening every segment. Derived data: a
        # failed manifest write is counted but never degrades the journal.
        self.manifest_writes = 0
        self.manifest_write_errors = 0
        # Rotation-pruning ledger, cumulative across writer lives (seeded
        # back from the manifest on restart): once > 0 the journal's oldest
        # waves are GONE, so a reader rebuilding state from it (cell
        # recovery) is working from an incomplete tail and must say so
        # (`journal_truncated`, RecoveryReport.truncated).
        self.pruned_segments = 0
        self.pruned_waves = 0
        # Fleet records captured beside their first wave (counted in
        # `recorded`, as the JAX recorder counts the fleet records it
        # enqueues beside its waves), and their digests.
        self.fleets_recorded = 0
        self._announced: set[str] = set()
        # (snapshot, its fleet_digest_of) of the last captured wave.
        self._last_fleet: tuple | None = None
        # The recorder's cost by part, [seconds, count] each (stats(split=
        # True)), every part on one clock, time.perf_counter. On the commit
        # path: "capture" (the fleet digest, the enqueue) and "render" (the
        # wave's JSON text, its pod names and allocated rows found as it is
        # written). The writer's work, wall seconds on whichever thread did
        # it (the writer thread's waits for the GIL included): "segment"
        # (taking records off the queue, the other records' JSON, a segment
        # file written), "manifest" and "startup" (the writer's start-up:
        # temporary files a killed writer left removed, the prior manifest
        # read, the manifest written, before start() returns). On the thread that calls flush():
        # "flush", its wall inside flush(), and "flush.<part>" for each of
        # FLUSH_PARTS.
        self._split = {part: [0.0, 0] for part in SPLIT_PARTS}
        # Seconds of each of fsio.FILE_STEPS over the writer's file writes.
        self._file_steps = [0.0] * len(FILE_STEPS)
        # The writer thread's own CPU seconds (time.thread_time) and its
        # voluntary and involuntary context switches (getrusage of the
        # thread), read in that thread after each pass, beside its wall
        # parts: wall well above CPU is time spent waiting (the GIL, the
        # disk, the scheduler), not work. Readings of this process's
        # threads only.
        self._writer_cpu = [0.0, 0, 0]
        # Wakes the writer: a flush, a stop, or a queue half full. Records
        # otherwise wait for the flush interval, when the writer writes them
        # in one pass.
        self._wake = threading.Event()

    # ---- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        os.makedirs(self.path, exist_ok=True)
        # Non-daemon: stop() joins; a daemon killed mid-rename could strand
        # a temp file (harmless) but a clean join never does.
        self._stop.clear()
        self._ready.clear()
        self._thread = threading.Thread(
            target=self._writer, name="grove-trace-writer", daemon=False
        )
        self._thread.start()
        self._ready.wait(timeout=10.0)

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    def request_flush(self) -> None:
        """Ask the writer to persist pending records now (the manager's
        trace flow step calls this each reconcile, bounding journal staleness
        by the reconcile cadence instead of the flush interval)."""
        self._flush_now.set()
        self._wake.set()

    def flush(self, timeout: float = 5.0) -> bool:
        """Synchronous flush: persist what was enqueued before this call and
        return once it is on disk (replay_verify and tests read the journal
        right after). The caller would only wait for the writer thread, so
        it does the writer's pass itself, under the writer's lock: no
        wake-up and no hand-back between threads stand between it and the
        disk, and the writer thread's next pass stages the next files and
        releases the replaced ones. False when no writer is running or its lock was not free within
        `timeout`. Its wall goes to stats(split=True)'s "flush", in
        FLUSH_PARTS: the wait for the writer's lock ("wake"), the queue's
        drain, the segment write, the manifest write, and the rest until
        the return ("handback")."""
        if self._thread is None:
            return False
        t0 = time.perf_counter()
        if not self._io_lock.acquire(timeout=timeout):
            return False
        try:
            journal = self._journal
            if journal is None:  # the writer has stopped
                return False
            t1 = time.perf_counter()
            journal.drain()
            t2 = time.perf_counter()
            t3, t4 = journal.write_segment() if journal.dirty else (t2, t2)
        finally:
            self._io_lock.release()
        t5 = time.perf_counter()
        split = self._split
        split["flush"][0] += t5 - t0
        split["flush"][1] += 1
        for part, a, b in zip(FLUSH_PARTS, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            split[f"flush.{part}"][0] += b - a
            split[f"flush.{part}"][1] += 1
        return True

    # ---- capture (reconcile thread) ----------------------------------------------

    def record(self, rec: dict) -> bool:
        """Enqueue one journal record; False (and counted) when full."""
        q = self._queue
        if len(q) >= self._queue_size:
            self.dropped += 1
            return False
        q.append(rec)
        self.recorded += 1
        if len(q) * 2 >= self._queue_size:
            self._wake.set()
        if rec.get("kind") == "wave":
            self.waves += 1
        elif rec.get("kind") == "action":
            self.actions += 1
        return True

    def capture_action(self, now: float, action: str, obj: str, **fields) -> bool:
        """Journal one control-plane decision action (preemption, reclaim,
        defrag migration, rolling update, gang termination, sim chaos)."""
        return self.record(
            {"kind": "action", "now": float(now), "action": action,
             "object": obj, **fields}
        )

    def capture_wave(
        self,
        *,
        now: float,
        wave: str,
        snapshot,
        gangs: list,
        pods_by_name: dict,
        scheduled_names,
        bound_nodes: dict,
        reuse_nodes: dict,
        spread_avoid: dict,
        max_groups,
        max_sets,
        max_pods,
        pad_gangs_to,
        params,
        portfolio: int,
        escalate_portfolio: int,
        pruning=None,  # solver.pruning.PruningConfig (or None = dense)
        plan: dict,
        ok_by_name: dict,
        valid_by_name: dict,
        scores: dict,
        solve_seconds: float,
        allocated_override=None,  # np [N, R]: allocation ENTERING this wave
        free_rows: dict | None = None,  # node -> exact entering free row
        candidates: list | None = None,  # pruned waves: fixed candidate list
        mesh: dict | None = None,  # mesh fingerprint {portfolio, node} | None
    ) -> bool:
        """Journal one solve wave — the full encode+solve input closure plus
        the resulting plan. The pods mutate (bind) right after the solve and
        a drain's allocation table advances, so the record is rendered to its
        JSON text here (`_wave_text`), and the writer thread only writes it.

        The pipelined drain (solver/drain._WavePipeline) journals waves whose
        entering state is NOT the snapshot: `allocated_override` is the
        running allocation table at the wave's commit point, `free_rows` the
        exact device-chained free carry (fetched bitwise — f32 round-trips
        JSON exactly), and `candidates` the fixed candidate-node list its
        plan was cut with (plans are cut against the INITIAL free, so replay
        must not re-cut them against the wave's entering free). Replay
        (trace/replay.py) prefers these over the snapshot-derived state."""
        t0 = time.perf_counter()
        digest, payload = self._fleet_of(snapshot)
        t1 = time.perf_counter()
        text = _wave_text((
            now, wave, digest, snapshot.capacity.shape[0], snapshot.resource_names,
            snapshot.allocated if allocated_override is None else allocated_override,
            snapshot.node_names, gangs, pods_by_name, scheduled_names, bound_nodes,
            reuse_nodes, spread_avoid, max_groups, max_sets, max_pods, pad_gangs_to,
            params, portfolio, escalate_portfolio, _mesh_doc(mesh) if mesh else None,
            None if pruning is None else _pruning_doc(pruning), plan, ok_by_name,
            valid_by_name, scores, solve_seconds, free_rows, candidates,
        ))
        t2 = time.perf_counter()
        rec = {"kind": "wave", "wave": wave, "fleet": digest, "_text": text}
        new_fleet = digest not in self._announced
        if new_fleet:
            # The fleet rides with the first wave that references it; the
            # writer re-emits it into every segment holding such a wave.
            rec["_fleet"] = payload
        ok = self.record(rec)
        if ok and new_fleet:
            self._announced.add(digest)
            self.fleets_recorded += 1
        split = self._split
        split["capture"][0] += t1 - t0 + time.perf_counter() - t2
        split["capture"][1] += 1
        split["render"][0] += t2 - t1
        split["render"][1] += 1
        return ok

    def _charge(self, part: str, t0: float, count: int = 1) -> None:
        """Add the writer thread's seconds since `t0` to `part`."""
        acc = self._split[part]
        acc[0] += time.perf_counter() - t0
        acc[1] += count

    def _fleet_of(self, snapshot) -> tuple[str, dict]:
        """fleet_digest_of(snapshot), or the last captured wave's when its
        snapshot holds the same fleet: a controller builds a new snapshot of
        an unchanged fleet for every wave, and comparing the payload's inputs
        costs a fraction of the digest's JSON (in C, serde.same_fleet; here
        what it leaves undecided)."""
        last = self._last_fleet
        if last is not None:
            if snapshot is last[0]:
                return last[1]
            same = serde.same_fleet(snapshot, last[0])
            if same is None:
                same = _same_fleet(snapshot, last[0])
            if same:
                return last[1]
        hit = fleet_digest_of(snapshot)
        self._last_fleet = (snapshot, hit)
        return hit

    # ---- writer thread -----------------------------------------------------------

    def _writer(self) -> None:
        cpu0 = time.thread_time()
        ru0 = resource.getrusage(resource.RUSAGE_THREAD)

        def read_cpu() -> None:
            self._writer_cpu[0] = time.thread_time() - cpu0
            ru = resource.getrusage(resource.RUSAGE_THREAD)
            self._writer_cpu[1:] = [ru.ru_nvcsw - ru0.ru_nvcsw, ru.ru_nivcsw - ru0.ru_nivcsw]

        t0 = time.perf_counter()
        try:
            with self._io_lock:
                journal = self._journal = _Journal(self)
            self._charge("startup", t0)
        finally:
            self._ready.set()
        while True:
            self._wake.wait(timeout=self.flush_interval_seconds)
            self._wake.clear()
            # A request read here has its records in the queue before the
            # drain below; one set after the read is the next pass's (its
            # _wake.set() makes one).
            want_flush = self._flush_now.is_set()
            if want_flush:
                self._flush_now.clear()
            with self._io_lock:
                journal.drain()
                interval_due = (
                    time.monotonic() - journal.last_flush >= self.flush_interval_seconds
                )
                if journal.dirty and (want_flush or interval_due):
                    journal.write_segment()
                journal.stage()
            read_cpu()
            if self._stop.is_set() and not self._queue:
                break
        with self._io_lock:
            journal.close()
            self._journal = None
        read_cpu()

    def _segments(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.path, _SEGMENT_GLOB)))

    def _next_seq(self) -> int:
        seqs = []
        for p in self._segments():
            stem = os.path.basename(p)[len("segment-"):-len(".json")]
            try:
                seqs.append(int(stem))
            except ValueError:
                continue
        return max(seqs) + 1 if seqs else 0

    def _prune(self, manifest: dict | None = None) -> bool:
        files = self._segments()
        removed = False
        for p in files[: max(0, len(files) - self.max_files)]:
            try:
                os.unlink(p)
            except OSError:
                continue  # pruning is best-effort; the journal stays readable
            removed = True
            self.pruned_segments += 1
            if manifest is not None:
                stem = os.path.basename(p)[len("segment-"):-len(".json")]
                try:
                    entry = manifest.pop(int(stem), None)
                except ValueError:
                    entry = None
                if entry:
                    self.pruned_waves += int(entry.get("waves", 0) or 0)
        return removed

    # ---- segment manifest (writer thread) ------------------------------------------

    def _seed_manifest(self) -> dict[int, dict]:
        """Entries for every segment already on disk: reuse the previous
        process's manifest where its entries still match a file, summarize
        the rest by reading them once."""
        prior = {}
        doc = read_manifest(self.path)
        if doc:
            # Carry the pruning ledger across writer lives (max, not +=, so
            # a same-instance restart cannot double-count its own entries).
            self.pruned_segments = max(
                self.pruned_segments, int(doc.get("prunedSegments", 0) or 0)
            )
            self.pruned_waves = max(
                self.pruned_waves, int(doc.get("prunedWaves", 0) or 0)
            )
            for e in doc.get("segments", []):
                try:
                    prior[int(e["seq"])] = e
                except (KeyError, TypeError, ValueError):
                    continue
        manifest: dict[int, dict] = {}
        for p in self._segments():
            stem = os.path.basename(p)[len("segment-"):-len(".json")]
            try:
                seq = int(stem)
            except ValueError:
                continue
            got = prior.get(seq)
            if got is not None and got.get("file") == os.path.basename(p):
                manifest[seq] = got
                continue
            try:
                with open(p) as f:
                    records = json.load(f).get("records", [])
            except (OSError, ValueError):
                continue
            manifest[seq] = _manifest_entry(seq, records)
        return manifest

    def stats(self, split: bool = False) -> dict:
        """JSON-able recorder state (the JAX recorder's keys); with `split`,
        also "split": {part: {"s": seconds, "n": count}} for each of
        SPLIT_PARTS, "fileSteps": {step: seconds} for each of
        fsio.FILE_STEPS over the writer's file writes, and the writer
        thread's own CPU seconds and its voluntary and involuntary context
        switches ("writerCpuSeconds", "writerSwitches"), as of its last
        pass."""
        doc = {
            "path": self.path,
            "recorded": self.recorded + self.fleets_recorded,
            "dropped": self.dropped,
            "waves": self.waves,
            "actions": self.actions,
            "segmentsWritten": self.segments_written,
            "queueDepth": len(self._queue),
            "degraded": self.degraded,
            "writeErrors": self.write_errors,
            "manifestWrites": self.manifest_writes,
            "manifestWriteErrors": self.manifest_write_errors,
            "prunedSegments": self.pruned_segments,
            "prunedWaves": self.pruned_waves,
        }
        if self._last_write_error:
            doc["lastWriteError"] = self._last_write_error
        if split:
            doc["split"] = {p: {"s": s, "n": n} for p, (s, n) in self._split.items()}
            doc["fileSteps"] = dict(zip(FILE_STEPS, self._file_steps))
            doc["writerCpuSeconds"] = self._writer_cpu[0]
            doc["writerSwitches"] = self._writer_cpu[1:]
        return doc


class _Journal:
    """The writer's state, used under TraceRecorder._io_lock by the writer
    thread and by flush(): the open segment (its records' texts, the counts
    its manifest entry is made of, and its file staged ahead of the write),
    the manifest (each segment's entry and that entry's JSON text), and the
    fleet payloads seen. Built at the writer's start-up: temporary files a
    killed writer left removed, the prior manifest read and written anew.

    Each pass of the writer thread stages the next files (`stage`: the
    temporary file made, the segment's bytes so far written into it) and
    closes the descriptors of the files the writes since its last pass
    replaced; a write after a pass is then one writev and one rename per
    file. start() stages nothing and holds no descriptor, so a write before
    the first pass makes its files and releases the manifest it replaces
    itself, as one after another write without a pass between makes its
    files. The bytes are those of json.dumps of each file's document, as a
    whole rewrite writes them."""

    def __init__(self, rec: TraceRecorder) -> None:
        self.rec = rec
        # A directory has one writer, so a temporary file in it is one a
        # writer killed mid-write or between two passes left behind.
        for p in glob.glob(os.path.join(glob.escape(rec.path), TEMP_PREFIX + "*")):
            try:
                os.unlink(p)
            except OSError:
                pass
        self.seq = rec._next_seq()
        self.fleets: dict[str, tuple[dict, bool]] = {}  # digest -> (payload, captured)
        self.fleet_texts: dict[str, bytes] = {}  # the texts written in this writer life
        self.segment_file: Optional[StagedFile] = None
        self.manifest_file: Optional[StagedFile] = None
        # The committed files on disk now, their descriptors kept open until
        # a later commit replaces them: a rename over a file that is still
        # open leaves the old file's deletion to that descriptor's close,
        # which the writer thread makes off its caller's clock (`stage`).
        self.live_segment: Optional[StagedFile] = None
        self.live_manifest: Optional[StagedFile] = None
        self.retired: list[StagedFile] = []  # replaced, descriptors still open
        self._new_segment()
        self.dirty = False
        self.last_flush = time.monotonic()
        # seq -> manifest entry for every segment currently on disk, seeded
        # from the prior process's manifest (entries for pruned files drop;
        # unmanifested segments — written before the manifest existed — are
        # summarized once from disk here, never again per write), and each
        # entry's JSON text.
        self.manifest = rec._seed_manifest()
        self.entry_texts: dict[int, bytes] = {}
        self.write_manifest(part=None)
        if self.live_manifest is not None:
            self.live_manifest.close()
            self.live_manifest = None

    def _new_segment(self) -> None:
        self.chunks: list = []  # the records' JSON texts and the ", " between them
        self.staged = 0  # of them in segment_file
        self.records = 0
        self.waves = 0
        self.wave_range: Optional[list] = None  # [first wave id, last]
        self.digests: set[str] = set()  # the fleets written into the segment

    def _path(self, name: str) -> str:
        return os.path.join(self.rec.path, name)

    def _add(self, rec: dict, text) -> None:
        if self.chunks:
            self.chunks.append(b", ")
        self.chunks.append(text)
        self.records += 1
        kind = rec.get("kind")
        if kind == "wave":
            wave = rec.get("wave", "?")
            self.waves += 1
            if self.wave_range is None:
                self.wave_range = [wave, wave]
            else:
                self.wave_range[1] = wave
        elif kind == "fleet":
            self.digests.add(rec["digest"])

    def _fleet_text(self, digest: str) -> bytes:
        text = self.fleet_texts.get(digest)
        if text is None:
            payload, captured = self.fleets[digest]
            text = _fleet_text(digest, payload) if captured else json.dumps(payload).encode()
            self.fleet_texts[digest] = text
        return text

    def entry(self) -> dict:
        """The open segment's manifest entry (_manifest_entry of its
        records)."""
        return {
            "file": f"segment-{self.seq:06d}.json",
            "seq": self.seq,
            "records": self.records,
            "waves": self.waves,
            "waveRange": list(self.wave_range) if self.wave_range else None,
            "fleetDigests": sorted(self.digests),
        }

    def drain(self) -> None:
        """Takes every queued record into the open segment (the queue is
        drained before a flush or stop is honored), rotating at
        max_records_per_file."""
        rec_ = self.rec
        queue = rec_._queue
        t0 = time.perf_counter()
        while True:
            try:
                rec = queue.popleft()
            except IndexError:
                break
            if rec.get("kind") == "fleet":
                # Written into a segment only when a wave references it.
                self.fleets[rec["digest"]] = (rec, False)
                continue
            payload = rec.pop("_fleet", None)
            if payload is not None:
                self.fleets[rec["fleet"]] = (payload, True)
            d = rec.get("fleet")
            if d and d not in self.digests and d in self.fleets:
                self._add(self.fleets[d][0], self._fleet_text(d))
            text = rec.pop("_text", None)
            self._add(rec, json.dumps(rec).encode() if text is None else text)
            self.dirty = True
            if self.records >= rec_.max_records_per_file:
                rec_._charge("segment", t0, count=0)
                self.rotate()  # charges its own write
                t0 = time.perf_counter()
        rec_._charge("segment", t0, count=0)

    def write_segment(self) -> tuple[float, float]:
        """Writes the open segment, then the manifest; returns the clock
        after each (the clock at the return for what was not written)."""
        rec = self.rec
        t_seg = t_man = 0.0
        if self.records:
            try:
                # The `recorder.write` fault site (an injected ENOSPC takes
                # the counting-drops path below).
                from grove_tpu_torch import faults as faults_mod

                faults_mod.active().maybe_raise("recorder.write", records=self.records)
                t0 = time.perf_counter()
                # json.dumps of {"version", "records", <counters>}: the
                # records' texts written as they are.
                counters = json.dumps({
                    # Recorder-state counters AT WRITE TIME (cumulative for
                    # this process): lets an offline reader (the tuning
                    # sweep, journal_stats) tell a truncated journal —
                    # records dropped under queue pressure — from a
                    # genuinely quiet day. Additive field: replay ignores
                    # it, old segments read as 0.
                    "recorderDropped": rec.dropped,
                    "recorderRecorded": rec.recorded + rec.fleets_recorded,
                    # Counting-drops mode ledger: segments the writer could
                    # NOT persist (ENOSPC et al). > 0 tells an offline
                    # reader the journal has a HOLE even when the queue
                    # never overflowed.
                    "recorderWriteErrors": rec.write_errors,
                })
                tail = ("], " + counters[1:]).encode()
                f, self.segment_file = self.segment_file, None
                if f is None:
                    f = StagedFile(self._path(f"segment-{self.seq:06d}.json"), rec._file_steps)
                    f.commit([_SEGMENT_HEAD, *self.chunks, tail])
                else:
                    f.commit([*self.chunks[self.staged:], tail])
                self._retire(self.live_segment)
                self.live_segment = f
                self.staged = 0
                rec._charge("segment", t0)
                t_seg = time.perf_counter()
                rec.segments_written += 1
                rec.degraded = False
                entry = self.manifest[self.seq] = self.entry()
                self.entry_texts[self.seq] = json.dumps(entry).encode()
                self.write_manifest()
                t_man = time.perf_counter()
            except OSError as e:
                # Counting-drops mode: the journal is observability, the
                # solve loop is the product — a full disk must cost a
                # SEGMENT of records (counted), never the writer thread
                # (whose death would silently drop everything after) and
                # never a blocked solve. The segment buffer is released so
                # memory stays bounded while the disk is sick.
                if self.segment_file is not None:
                    self.segment_file.discard()
                    self.segment_file = None
                rec.write_errors += 1
                rec.degraded = True
                rec.dropped += self.records
                rec._last_write_error = str(e)
                serde.recycle(self.chunks)
                self._new_segment()
        self.dirty = False
        self.last_flush = time.monotonic()
        now = time.perf_counter()
        return t_seg or now, t_man or now

    def rotate(self) -> None:
        self.write_segment()
        self.seq += 1
        # The segment's texts go back to the renderer together (the memory
        # of the next ones).
        serde.recycle(self.chunks)
        self._new_segment()
        if self.rec._prune(self.manifest):
            self.write_manifest()

    def write_manifest(self, part: Optional[str] = "manifest") -> None:
        """Writes manifest.json (json.dumps of its document: the closed
        entries' texts kept, the open one's new); its seconds go to `part`
        (None: the caller's). A failure is counted, and never degrades the
        journal: the manifest is derived data, and replay falls back to
        scanning segments."""
        rec = self.rec
        t0 = time.perf_counter()
        texts = self.entry_texts
        for seq in [s for s in texts if s not in self.manifest]:  # pruned
            del texts[seq]
        body: list = []
        last_wave, waves = None, 0
        for seq in sorted(self.manifest):
            e = self.manifest[seq]
            text = texts.get(seq)
            if text is None:
                text = texts[seq] = json.dumps(e).encode()
            if body:
                body.append(b", ")
            body.append(text)
            rng = e.get("waveRange")
            if rng:
                last_wave = rng[1]
            waves += int(e.get("waves", 0))
        tail = json.dumps({
            "lastWave": last_wave,
            "waves": waves,
            # Pruning ledger: > 0 means the journal's oldest waves were
            # rotated away — state rebuilt from this journal is incomplete
            # (journal_truncated / recovery flags it).
            "prunedSegments": rec.pruned_segments,
            "prunedWaves": rec.pruned_waves,
        })
        f, self.manifest_file = self.manifest_file, None
        try:
            if f is None:
                f = StagedFile(self._path(_MANIFEST), rec._file_steps)
            f.commit([_MANIFEST_HEAD, *body, ("], " + tail[1:]).encode()])
        except OSError:
            rec.manifest_write_errors += 1
            return
        self._retire(self.live_manifest)
        self.live_manifest = f
        rec.manifest_writes += 1
        if part is not None:
            rec._charge(part, t0)

    def _retire(self, f: Optional[StagedFile]) -> None:
        if f is not None:
            self.retired.append(f)

    def stage(self) -> None:
        """Closes the replaced files' descriptors and stages the next
        writes: a temporary file holding the open segment's bytes so far (its
        head and records), one for the manifest. A failure leaves the write
        to make its own file, and to meet the failure there."""
        for f in self.retired:
            f.close()
        self.retired = []
        steps = self.rec._file_steps
        try:
            if self.segment_file is None:
                f = StagedFile(self._path(f"segment-{self.seq:06d}.json"), steps)
                f.write([_SEGMENT_HEAD, *self.chunks])
                self.segment_file, self.staged = f, len(self.chunks)
            elif self.staged < len(self.chunks):
                n = len(self.chunks)
                self.segment_file.write(self.chunks[self.staged:n])
                self.staged = n
        except OSError:  # a failed write discarded its file
            self.segment_file = None
        try:
            if self.manifest_file is None:
                self.manifest_file = StagedFile(self._path(_MANIFEST), steps)
        except OSError:
            pass

    def close(self) -> None:
        """The last write, pruning, and no temporary file left."""
        self.write_segment()
        serde.recycle(self.chunks)
        if self.rec._prune(self.manifest):
            self.write_manifest()
        for f in (self.segment_file, self.manifest_file):
            if f is not None:
                f.discard()
        self.segment_file = self.manifest_file = None
        for f in (*self.retired, self.live_segment, self.live_manifest):
            if f is not None:
                f.close()
        self.retired = []
        self.live_segment = self.live_manifest = None


def _manifest_entry(seq: int, records: list[dict]) -> dict:
    """One segment's manifest row: id, record/wave counts, the wave-id range
    it covers (commit order — first and last wave record), and the fleet
    digests it re-emits (every segment replays standalone)."""
    waves = [r.get("wave", "?") for r in records if r.get("kind") == "wave"]
    return {
        "file": f"segment-{seq:06d}.json",
        "seq": seq,
        "records": len(records),
        "waves": len(waves),
        "waveRange": [waves[0], waves[-1]] if waves else None,
        "fleetDigests": sorted(
            {r["digest"] for r in records if r.get("kind") == "fleet"}
        ),
    }


def read_manifest(path: str) -> dict | None:
    """The journal's segment manifest ({"version", "segments", "lastWave",
    "waves"}), or None when absent/unreadable — callers fall back to
    scanning segment files (`read_journal`). A restarting cell uses
    `lastWave` as its resume point and the per-segment `waveRange` rows to
    pick the tail segments worth replaying."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def journal_truncated(path: str) -> bool:
    """True when the journal's oldest segments were rotation-pruned away —
    state rebuilt from it (cell recovery) is missing the pruned waves'
    admissions and therefore under-counts allocation. Primary signal is the
    manifest's pruning ledger (`prunedSegments`); the fallback — for a
    journal whose manifest is missing — is the surviving segment numbering
    (the writer numbers from 0, so a lowest seq > 0 means the head is
    gone)."""
    doc = read_manifest(path)
    if doc is not None and int(doc.get("prunedSegments", 0) or 0) > 0:
        return True
    files = [path] if os.path.isfile(path) else sorted(
        glob.glob(os.path.join(path, _SEGMENT_GLOB))
    )
    seqs = []
    for p in files:
        stem = os.path.basename(p)[len("segment-"):-len(".json")]
        try:
            seqs.append(int(stem))
        except ValueError:
            continue
    return bool(seqs) and min(seqs) > 0


def journal_stats(path: str) -> dict:
    """Writer-side counters recovered from the segment files themselves:
    {"dropped", "recorded", "segments", "writeErrors", "degraded"}.
    `dropped` > 0 means the journal is TRUNCATED — records were lost under
    queue pressure or to failed segment writes — which a sweep or replay
    consumer must surface (a wave referencing a dropped fleet fails replay
    outright, but dropped WAVES are silent without this). `writeErrors` > 0
    (stamped by the first segment successfully written AFTER a failed one)
    means the writer spent time in counting-drops mode — the journal has a
    hole even if the queue never overflowed; `degraded` mirrors it. Counters are cumulative per writer process, so the max
    across segments is the final count; segments written before the fields
    existed read as 0."""
    files = [path] if os.path.isfile(path) else sorted(
        glob.glob(os.path.join(path, _SEGMENT_GLOB))
    )
    dropped = 0
    recorded = 0
    write_errors = 0
    for p in files:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        dropped = max(dropped, int(doc.get("recorderDropped", 0) or 0))
        recorded = max(recorded, int(doc.get("recorderRecorded", 0) or 0))
        write_errors = max(
            write_errors, int(doc.get("recorderWriteErrors", 0) or 0)
        )
    return {
        "dropped": dropped,
        "recorded": recorded,
        "segments": len(files),
        "writeErrors": write_errors,
        "degraded": write_errors > 0,
    }


def read_journal(path: str) -> list[dict]:
    """Load a journal (directory of segments, or one segment file) into a
    record list, oldest first. Raises TraceSchemaError on a version mismatch
    — replaying a journal written by a different schema would rebuild
    different solver inputs and report meaningless (non-)divergence."""
    files = [path] if os.path.isfile(path) else sorted(
        glob.glob(os.path.join(path, _SEGMENT_GLOB))
    )
    if not files:
        raise FileNotFoundError(f"no trace journal at {path!r}")
    records: list[dict] = []
    for p in files:
        with open(p) as f:
            doc = json.load(f)
        version = doc.get("version")
        if version != SCHEMA_VERSION:
            raise TraceSchemaError(
                f"{p}: journal schema version {version!r} does not match this "
                f"build's {SCHEMA_VERSION} — re-record the journal with this "
                "build (or replay with the build that wrote it)"
            )
        records.extend(doc.get("records", []))
    return records
