"""The decision flight recorder: journal every solve wave, its file I/O off
the hot path (grove_tpu/trace/recorder.py counterpart).

The journal is a directory of SELF-CONTAINED segment files, each an atomic
JSON document `{"version": N, "records": [...]}` written via the shared
temp-file+rename primitive (`utils/fsio.atomic_write_chunks`) — readers never
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
there (`_wave_text`; `serde.dumpb`, the C renderer of utils/csrc: byte for
byte the record the JAX recorder builds at capture time). So nothing is
copied, and the queue holds bytes,
which the collector does not track: a capture that waited a flush interval
for the writer as an object graph (pod copies) was promoted into the oldest
generation and made full collections come sooner. The writer thread keeps
each record's bytes and writes a segment as the bytes it already holds plus
the new ones, so a flush costs the new records and the file write, not a
re-encoding of the segment. A full queue DROPS the record and counts it
(`dropped`) rather than blocking a solve.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import queue
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
from grove_tpu_torch.utils.fsio import atomic_write_chunks

# Journal schema, the JAX package's: either package reads the other's
# journals. The replayer refuses a mismatched version outright: a silent
# best-effort parse of an old journal would "replay" different solver inputs
# and report fake divergence (or fake equivalence).
SCHEMA_VERSION = 1

_SEGMENT_GLOB = "segment-*.json"
# A segment's text up to its first record.
_SEGMENT_HEAD = (json.dumps({"version": SCHEMA_VERSION})[:-1] + ', "records": [').encode()
# The parts of TraceRecorder.stats(split=True), in the order of a record's
# way to disk.
SPLIT_PARTS = ("capture", "render", "segment", "manifest")
_MANIFEST = "manifest.json"


def _wave_text(c: dict, digest: str) -> bytes:
    """The JSON text of one capture's wave record (TraceRecorder.capture_wave's
    inputs), as bytes: `json.dumps` of the record the JAX recorder builds,
    field for field and in its order, its gangs and pods rendered from the
    objects (`serde.dumpb`)."""
    gangs = c["gangs"]
    ok_by_name, valid_by_name, scores = c["ok_by_name"], c["valid_by_name"], c["scores"]
    names = {g.name for g in gangs}
    rejections = {}
    for name in names:
        if _jsonable(ok_by_name.get(name, False)):
            continue
        rejections[name] = (
            "rejected (capacity/constraints)"
            if _jsonable(valid_by_name.get(name, False))
            else "not solver-valid (gated base or unresolvable constraint)"
        )
    mesh, pruning = c["mesh"], c["pruning"]
    rec = {
        "kind": "wave",
        "now": float(c["now"]),
        "wave": c["wave"],
        "fleet": digest,
        "padNodesTo": c["pad_nodes"],
        "resources": c["resources"],
        "allocated": c["allocated"],
        "gangs": c["gangs"],
        "pods": c["pods"],
        "scheduled": sorted(c["scheduled"]),
        "boundNodes": {
            g: {grp: list(map(int, idx)) for grp, idx in per.items()}
            for g, per in c["bound_nodes"].items()
            if g in names
        },
        "reuseNodes": {
            g: list(map(int, idx)) for g, idx in c["reuse_nodes"].items() if g in names
        },
        "spreadAvoid": {
            g: list(map(int, idx)) for g, idx in c["spread_avoid"].items() if g in names
        },
        "maxGroups": c["max_groups"],
        "maxSets": c["max_sets"],
        "maxPods": c["max_pods"],
        "padGangsTo": c["pad_gangs_to"],
        "solver": {
            "params": [float(w) for w in c["params"]],
            "portfolio": int(c["portfolio"]),
            "escalatePortfolio": int(c["escalate_portfolio"]),
            # Mesh fingerprint (parallel/mesh.SolveLayout.fingerprint): the
            # device-mesh layout the recorded solve ran under. The sharded
            # solve is bitwise-equal to the unsharded one, so a replay host
            # with fewer devices still replays bitwise — but the pruning
            # candidate pad is negotiated mesh-divisible, so replay needs the
            # recorded node-axis size to rebuild the exact launch shape
            # (trace/replay.py).
            "mesh": None
            if not mesh or int(mesh.get("node", 1)) <= 1
            else {"portfolio": int(mesh.get("portfolio", 1)), "node": int(mesh["node"])},
            # Candidate-pruning fingerprint: replay must route through the
            # same pruned path (pruned placements legitimately differ from
            # dense ones) for bitwise equivalence.
            "pruning": None
            if pruning is None or not getattr(pruning, "enabled", False)
            else {
                "enabled": True,
                "maxCandidates": int(pruning.max_candidates),
                "padLadder": [int(x) for x in pruning.pad_ladder],
                "minPad": int(pruning.min_pad),
                "minFleet": int(pruning.min_fleet),
            },
        },
        "plan": {g: dict(b) for g, b in c["plan"].items()},
        "ok": {n: bool(_jsonable(ok_by_name.get(n, False))) for n in sorted(names)},
        "valid": {n: bool(_jsonable(valid_by_name.get(n, False))) for n in sorted(names)},
        "scores": {n: float(_jsonable(scores.get(n, 0.0))) for n in sorted(names)},
        "rejections": rejections,
        "solveSeconds": float(c["solve_seconds"]),
    }
    if c["free_rows"]:
        rec["freeRows"] = {
            str(n): [float(v) for v in row] for n, row in c["free_rows"].items()
        }
    if c["candidates"] is not None:
        rec["candidates"] = [int(i) for i in c["candidates"]]
    return serde.dumpb(rec)


for _m in (types_mod, pod_mod, podgang_mod, state_mod):
    serde.register_module(_m)


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
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(queue_size)))
        self._stop = threading.Event()
        self._flush_now = threading.Event()
        self._flush_done = threading.Event()
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
        # (snapshot, its fleet_digest_of) of the last wave.
        self._last_fleet: tuple | None = None
        # The recorder's cost by part, [seconds, count] each (stats(split=
        # True)), every part on one clock, time.perf_counter. On the commit
        # path: "capture" (the fleet digest, the allocated rows, the pod
        # names, the enqueue) and "render" (the wave's JSON text). On the
        # writer thread, its wall seconds, its waits for the GIL included
        # (so at most what it took from the commit path's thread): "segment"
        # (taking records off the queue, the other records' JSON, a segment
        # file written) and "manifest".
        self._split = {part: [0.0, 0] for part in SPLIT_PARTS}
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
        """Synchronous flush: block until the writer has drained what was
        enqueued before this call and persisted it (replay_verify and tests
        read the journal right after). False when no writer is running or
        the wait timed out."""
        if self._thread is None:
            return False
        self._flush_done.clear()
        self._flush_now.set()
        self._wake.set()
        return self._flush_done.wait(timeout)

    # ---- capture (reconcile thread) ----------------------------------------------

    def record(self, rec: dict) -> bool:
        """Enqueue one journal record; False (and counted) when full."""
        try:
            self._queue.put_nowait(rec)
        except queue.Full:
            self.dropped += 1
            return False
        self.recorded += 1
        if self._queue.qsize() * 2 >= self._queue.maxsize:
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
        ref_names = sorted({
            r.name
            for g in gangs
            for grp in g.spec.pod_groups
            for r in grp.pod_references
            if r.name in pods_by_name
        })
        alloc = np.asarray(snapshot.allocated if allocated_override is None
                           else allocated_override)
        n_real = len(snapshot.node_names)
        # The rows with any allocation, found in one pass (f32 -> the same
        # Python floats float() gives).
        allocated = {
            snapshot.node_names[i]: alloc[i].tolist()
            for i in np.flatnonzero(alloc[:n_real].any(axis=1)).tolist()
        }
        t1 = time.perf_counter()
        text = _wave_text({
            "now": now, "wave": wave, "pad_nodes": int(snapshot.capacity.shape[0]),
            "resources": list(snapshot.resource_names), "allocated": allocated,
            "gangs": gangs, "pods": {n: pods_by_name[n] for n in ref_names},
            "scheduled": scheduled_names, "bound_nodes": bound_nodes,
            "reuse_nodes": reuse_nodes, "spread_avoid": spread_avoid,
            "max_groups": max_groups, "max_sets": max_sets, "max_pods": max_pods,
            "pad_gangs_to": pad_gangs_to, "params": params, "portfolio": portfolio,
            "escalate_portfolio": escalate_portfolio, "pruning": pruning, "plan": plan,
            "ok_by_name": ok_by_name, "valid_by_name": valid_by_name, "scores": scores,
            "solve_seconds": solve_seconds, "free_rows": free_rows,
            "candidates": candidates, "mesh": mesh,
        }, digest)
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
        """fleet_digest_of(snapshot), or the last wave's when its snapshot
        holds the same fleet: a controller builds a new snapshot of an
        unchanged fleet for every wave, and comparing the payload's inputs
        costs a fraction of the digest's JSON."""
        last = self._last_fleet
        if last is not None and _same_fleet(snapshot, last[0]):
            return last[1]
        hit = fleet_digest_of(snapshot)
        self._last_fleet = (snapshot, hit)
        return hit

    # ---- writer thread -----------------------------------------------------------

    def _writer(self) -> None:
        cpu0 = time.thread_time()

        def read_cpu() -> None:
            self._writer_cpu[0] = time.thread_time() - cpu0
            ru = resource.getrusage(resource.RUSAGE_THREAD)
            self._writer_cpu[1:] = [ru.ru_nvcsw - ru0.ru_nvcsw, ru.ru_nivcsw - ru0.ru_nivcsw]

        ru0 = resource.getrusage(resource.RUSAGE_THREAD)
        seq = self._next_seq()
        segment: list[dict] = []  # the records (a wave: a stub)
        chunks: list[bytes] = []  # their JSON texts and the ", " between them
        seg_digests: set[str] = set()
        fleets: dict[str, dict] = {}  # every fleet payload seen this process
        fleet_texts: dict[str, bytes] = {}
        dirty = False

        last_flush = time.monotonic()
        # seq -> manifest entry for every segment currently on disk, seeded
        # from the prior process's manifest (entries for pruned files drop;
        # unmanifested segments — written before the manifest existed — are
        # summarized once from disk here, never again per write).
        try:
            manifest = self._seed_manifest()
            self._write_manifest(manifest)
        finally:
            self._ready.set()

        def add(rec: dict, text: bytes) -> None:
            if chunks:
                chunks.append(b", ")
            chunks.append(text)
            segment.append(rec)

        def write_segment() -> None:
            nonlocal dirty, last_flush, segment, chunks, seg_digests
            if segment:
                try:
                    # The `recorder.write` fault site (an injected ENOSPC
                    # takes the counting-drops path below).
                    from grove_tpu_torch import faults as faults_mod

                    faults_mod.active().maybe_raise("recorder.write", records=len(segment))
                    t0 = time.perf_counter()
                    # json.dumps of {"version", "records", <counters>}: the
                    # records' texts written as they are.
                    counters = json.dumps({
                        # Recorder-state counters AT WRITE TIME (cumulative
                        # for this process): lets an offline reader (the
                        # tuning sweep, journal_stats) tell a truncated
                        # journal — records dropped under queue pressure —
                        # from a genuinely quiet day. Additive field: replay
                        # ignores it, old segments read as 0.
                        "recorderDropped": self.dropped,
                        "recorderRecorded": self.recorded + self.fleets_recorded,
                        # Counting-drops mode ledger: segments the writer
                        # could NOT persist (ENOSPC et al). > 0 tells an
                        # offline reader the journal has a HOLE even when
                        # the queue never overflowed.
                        "recorderWriteErrors": self.write_errors,
                    })
                    atomic_write_chunks(
                        os.path.join(self.path, f"segment-{seq:06d}.json"),
                        [_SEGMENT_HEAD, *chunks, ("], " + counters[1:]).encode()],
                    )
                    self._charge("segment", t0)
                    self.segments_written += 1
                    self.degraded = False
                    manifest[seq] = _manifest_entry(seq, segment)
                    self._write_manifest(manifest)
                except OSError as e:
                    # Counting-drops mode: the journal is observability, the
                    # solve loop is the product — a full disk must cost a
                    # SEGMENT of records (counted), never the writer thread
                    # (whose death would silently drop everything after) and
                    # never a blocked solve. The segment buffer is released
                    # so memory stays bounded while the disk is sick.
                    self.write_errors += 1
                    self.degraded = True
                    self.dropped += len(segment)
                    self._last_write_error = str(e)
                    segment = []
                    chunks = []
                    seg_digests = set()
            dirty = False
            last_flush = time.monotonic()

        def rotate() -> None:
            nonlocal seq, segment, chunks, seg_digests
            write_segment()
            seq += 1
            segment = []
            chunks = []
            seg_digests = set()
            if self._prune(manifest):
                self._write_manifest(manifest)

        while True:
            self._wake.wait(timeout=self.flush_interval_seconds)
            self._wake.clear()
            t0 = time.perf_counter()
            while True:  # drain the queue before honoring flush/stop
                try:
                    rec = self._queue.get_nowait()
                except queue.Empty:
                    break
                if rec.get("kind") == "fleet":
                    fleets[rec["digest"]] = rec
                    # Emitted into a segment only when a wave references it.
                else:
                    payload = rec.pop("_fleet", None)
                    if payload is not None:
                        fleets[rec["fleet"]] = payload
                    d = rec.get("fleet")
                    if d and d not in seg_digests and d in fleets:
                        if d not in fleet_texts:
                            fleet_texts[d] = json.dumps(fleets[d]).encode()
                        add(fleets[d], fleet_texts[d])
                        seg_digests.add(d)
                    text = rec.pop("_text", None)
                    add(rec, json.dumps(rec).encode() if text is None else text)
                    dirty = True
                if len(segment) >= self.max_records_per_file:
                    self._charge("segment", t0, count=0)
                    rotate()  # charges its own write
                    t0 = time.perf_counter()
            self._charge("segment", t0, count=0)
            want_flush = self._flush_now.is_set()
            interval_due = (
                time.monotonic() - last_flush >= self.flush_interval_seconds
            )
            if dirty and (want_flush or interval_due):
                write_segment()
            read_cpu()
            if want_flush:
                self._flush_now.clear()
                self._flush_done.set()  # flush(): everything enqueued before
                # the request is now on disk (the queue drained first).
            if self._stop.is_set() and self._queue.empty():
                break
        write_segment()
        if self._prune(manifest):
            self._write_manifest(manifest)
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

    def _write_manifest(self, manifest: dict[int, dict]) -> None:
        t0 = time.perf_counter()
        entries = [manifest[s] for s in sorted(manifest)]
        last_wave = None
        for e in entries:
            rng = e.get("waveRange")
            if rng:
                last_wave = rng[1]
        try:
            atomic_write_chunks(
                os.path.join(self.path, _MANIFEST),
                [json.dumps({
                    "version": SCHEMA_VERSION,
                    "segments": entries,
                    "lastWave": last_wave,
                    "waves": sum(int(e.get("waves", 0)) for e in entries),
                    # Pruning ledger: > 0 means the journal's oldest waves
                    # were rotated away — state rebuilt from this journal is
                    # incomplete (journal_truncated / recovery flags it).
                    "prunedSegments": self.pruned_segments,
                    "prunedWaves": self.pruned_waves,
                }).encode()],
            )
            self.manifest_writes += 1
            self._charge("manifest", t0)
        except OSError:
            # Derived data: replay falls back to scanning segments; the
            # journal itself is NOT degraded by a missing manifest.
            self.manifest_write_errors += 1

    def stats(self, split: bool = False) -> dict:
        """JSON-able recorder state (the JAX recorder's keys); with `split`,
        also "split": {part: {"s": seconds, "n": count}} for each of
        SPLIT_PARTS, and the writer thread's own CPU seconds and its
        voluntary and involuntary context switches ("writerCpuSeconds",
        "writerSwitches"), as of its last pass."""
        doc = {
            "path": self.path,
            "recorded": self.recorded + self.fleets_recorded,
            "dropped": self.dropped,
            "waves": self.waves,
            "actions": self.actions,
            "segmentsWritten": self.segments_written,
            "queueDepth": self._queue.qsize(),
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
            doc["writerCpuSeconds"] = self._writer_cpu[0]
            doc["writerSwitches"] = self._writer_cpu[1:]
        return doc


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
