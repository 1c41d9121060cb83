"""One reconcile cell: a slice of the fleet with its own engine + journal.

A Cell owns a node slice (its sub-snapshot), a set of pinned queues (the
roots `partition.partition_tree` assigned to it), and runs the SAME
drain/stream engine as the monolithic control plane (`solver/stream.py`,
unchanged) over its slice — with its own warm-path cache handle, its own
flight-recorder journal directory, and (optionally) its own named lease
from `runtime/lease.LeaseSet`. Host participation is therefore O(own
slice): adding cells adds engines, it never widens any one engine's fleet.

Crash recovery is the flight-recorder contract cashed in: every journaled
wave carries its full encode closure and is bitwise-pinned by
`trace/replay.py`, so `recover()` rebuilds a dead cell's allocated/free
state and bindings purely from its journal tail — verified by replaying it
bitwise first — then warm-starts (the replay itself re-populates the
launch cache).
Gangs whose waves never reached the journal are simply NOT in the rebuilt
state; the coordinator re-offers them, so a crash loses nothing and
double-binds nothing — `bindings` (admitted gangs holding capacity) gates
re-admission, while `decided` (every journaled verdict) is the zero-lost
ledger. Journaled `cell.reclaim` actions are mirrored during the rebuild,
so a gang released before the crash stays released, and a journal whose
oldest segments were rotation-pruned recovers flagged `truncated` (never
`verified`) because the pruned admissions are unrecoverable.

The `cell.crash` fault site fires BETWEEN engine runs (the engine itself is
reused unchanged — its own sites keep covering the in-wave failure modes):
a serve() call streams its arrivals in bounded chunks and evaluates the
site before each chunk after the first, so a deterministic fault spec kills
the cell mid-stream with journaled waves behind it and undecided arrivals
ahead of it — exactly the recovery problem production restarts pose.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch import faults as faults_mod
from grove_tpu_torch.solver.stream import StreamConfig, drain_stream
from grove_tpu_torch.state.cluster import build_snapshot, pod_request_vector
from grove_tpu_torch.trace.recorder import (
    TraceRecorder,
    read_journal,
    read_manifest,
)
from grove_tpu_torch.utils import serde

_EPOCH_RE = re.compile(r"^c(\d+)-")


class CellCrash(RuntimeError):
    """The cell died mid-stream (injected via the `cell.crash` site). The
    instance is unusable; recover() builds its replacement from the
    journal. `partial` carries the bindings the interrupted call committed
    (journaled) BEFORE the crash — a caller that was admitting a family
    must treat those gangs as landed on this cell (they rebind on
    recovery), never re-admit them elsewhere."""

    def __init__(self, cell: str, partial: dict | None = None):
        super().__init__(f"cell {cell} crashed mid-stream")
        self.cell = cell
        self.partial: dict[str, dict[str, str]] = dict(partial or {})


class _CellRecorder(TraceRecorder):
    """Cell-scoped journal: every engine life numbers its waves from zero
    (`stream-000000`...), so the cell prefixes wave ids with a monotonic
    engine epoch (`c0002-stream-000003`) — ids stay unique across crashes
    and restarts and the manifest's lastWave names a real resume point."""

    def __init__(self, path: str, *, epoch: int = 0, **kw) -> None:
        super().__init__(path, **kw)
        self.epoch = int(epoch)

    def capture_wave(self, *, wave: str, **kw) -> bool:
        return super().capture_wave(wave=f"c{self.epoch:04d}-{wave}", **kw)


@dataclass
class CellStats:
    """Aggregate of every engine run this cell instance performed."""

    offered: int = 0
    admitted: int = 0
    pods_bound: int = 0
    waves: int = 0
    dispatches: int = 0
    device_roundtrips: int = 0
    host_total_s: float = 0.0  # engine host-stage ledger sum (hostTotalS)
    host_blocked_s: float = 0.0  # host time blocked on verdict fetches
    wall_s: float = 0.0
    engine_runs: int = 0
    crashes: int = 0
    recoveries: int = 0
    borrowed_in: int = 0  # gangs admitted on behalf of another cell's queue
    released: int = 0  # gangs released by cross-cell reclaim

    def to_doc(self) -> dict:
        return {
            "offered": self.offered,
            "admitted": self.admitted,
            "podsBound": self.pods_bound,
            "waves": self.waves,
            "dispatches": self.dispatches,
            "deviceRoundtrips": self.device_roundtrips,
            "hostTotalS": round(self.host_total_s, 4),
            "hostBlockedS": round(self.host_blocked_s, 4),
            "wallS": round(self.wall_s, 4),
            "engineRuns": self.engine_runs,
            "crashes": self.crashes,
            "recoveries": self.recoveries,
            "borrowedIn": self.borrowed_in,
            "released": self.released,
        }


@dataclass
class RecoveryReport:
    """What journal-tail recovery rebuilt, and the bitwise handoff proof."""

    cell: str
    waves_replayed: int = 0
    divergences: int = 0
    gangs_rebound: int = 0  # admitted gangs whose bindings were rebuilt
    gangs_reclaimed: int = 0  # cell.reclaim records mirrored (releases)
    gangs_decided: int = 0  # gangs with ANY journaled verdict (zero-lost)
    resume_point: str | None = None  # manifest lastWave (None: no manifest)
    manifest_segments: int = 0
    # Rotation pruning dropped the journal's oldest waves: the rebuilt
    # allocated/bindings state is missing their admissions, so recovery is
    # NOT sound — verified stays False even when the surviving tail
    # replays bitwise.
    truncated: bool = False
    verified: bool = False  # replay diverged nowhere AND the tail is complete

    def to_doc(self) -> dict:
        return {
            "cell": self.cell,
            "wavesReplayed": self.waves_replayed,
            "divergences": self.divergences,
            "gangsRebound": self.gangs_rebound,
            "gangsReclaimed": self.gangs_reclaimed,
            "gangsDecided": self.gangs_decided,
            "resumePoint": self.resume_point,
            "manifestSegments": self.manifest_segments,
            "truncated": self.truncated,
            "verified": self.verified,
        }


class Cell:
    """A reconcile cell: fleet slice + pinned queues + its own engine."""

    def __init__(
        self,
        name: str,
        nodes: list,
        topology,
        *,
        journal_path: str,
        owned_queues=(),
        stream_config: StreamConfig | None = None,
        params=None,
        warm_path=None,
        lease=None,  # runtime.lease.FileLease (from a LeaseSet), optional
        faults=None,  # faults.FaultInjector; None = the installed one
        crash_check_every: int = 128,  # arrivals between cell.crash checks
        scan=None,  # forwarded to drain_stream (fused/resident dispatch)
        pipeline: bool = True,
        max_records_per_file: int = 256,
        max_files: int = 512,
        epoch: int = 0,
        device=None,  # the card (None) or "cpu": the plain versions
    ) -> None:
        from grove_tpu_torch.solver.core import resolve_device
        from grove_tpu_torch.solver.warm import WarmPath

        self.name = name
        self.nodes = list(nodes)
        self.topology = topology
        self.owned_queues = frozenset(owned_queues)
        self.journal_path = journal_path
        self.snapshot = build_snapshot(self.nodes, topology)
        self.config = stream_config or StreamConfig()
        self.params = params
        self.warm_path = warm_path if warm_path is not None else WarmPath()
        self.lease = lease
        self.faults = faults
        self.crash_check_every = max(1, int(crash_check_every))
        self.scan = scan
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self.recorder = _CellRecorder(
            journal_path,
            epoch=epoch,
            max_records_per_file=max_records_per_file,
            max_files=max_files,
        )
        # bindings = admitted gangs still holding capacity — the re-admit
        # gate (zero double-bound); decided = every journaled verdict,
        # admitted or rejected — the zero-lost ledger. Rejected gangs are
        # in decided but not bindings, so they stay re-offerable.
        self.bindings: dict[str, dict[str, str]] = {}
        self.decided: set[str] = set()
        self.stats = CellStats()
        self.alive = False

    # ---- lifecycle ---------------------------------------------------------------

    def start(self, now: float | None = None) -> bool:
        """Start the journal writer and (when leased) acquire the cell's
        lease. Returns lease holdership (True when no lease is configured —
        an unleased cell is always 'leader' of itself)."""
        self.recorder.start()
        self.alive = True
        if self.lease is None:
            return True
        return self.lease.try_acquire(now)

    def close(self) -> None:
        """Graceful shutdown: flush + stop the writer, release the lease."""
        self.alive = False
        self.recorder.stop()
        if self.lease is not None:
            self.lease.release()

    def crash(self) -> None:
        """Simulated process death. The journal (what the writer thread has
        persisted/accepted) is the only survivor: the snapshot, bindings,
        and decided set die with the instance, and the lease is NOT
        released — it expires, exactly as a killed process's would."""
        self.stats.crashes += 1
        self.alive = False
        self.recorder.stop()

    # ---- admission ---------------------------------------------------------------

    def owns(self, gang) -> bool:
        """Is this gang pinned to this cell? Unquoted gangs (no queue) are
        unpinned — any cell may host them, the coordinator picks. A gang on
        a queue some OTHER cell owns must route through the coordinator."""
        queue = getattr(gang, "queue", "")
        return not queue or not self.owned_queues or queue in self.owned_queues

    def serve(self, arrivals: list, pods_by_name: dict) -> dict:
        """Stream this cell's pinned arrivals through its own engine;
        returns the new bindings ({gang: {pod: node}}). Refuses foreign
        gangs outright — cross-cell traffic is the coordinator's
        (admit_borrowed), never a cell's own call to make."""
        for _, g in arrivals:
            if not self.owns(g):
                raise ValueError(
                    f"cell {self.name}: gang {g.name} (queue {g.queue!r}) is "
                    "pinned to another cell — route it via the coordinator"
                )
        return self._stream(arrivals, pods_by_name)

    def admit_borrowed(self, arrivals: list, pods_by_name: dict) -> dict:
        """Coordinator-only entry: admit gangs pinned elsewhere onto this
        cell's spare capacity (borrowed across the subtree seam). Same
        engine, same journal; only the ownership gate is waived. The
        borrowed_in count updates even when the call dies in a CellCrash —
        the chunks committed before the crash DID land here."""
        before = self.stats.admitted
        try:
            out = self._stream(arrivals, pods_by_name)
        finally:
            self.stats.borrowed_in += self.stats.admitted - before
        return out

    def _stream(self, arrivals: list, pods_by_name: dict) -> dict:
        if not self.alive:
            raise CellCrash(self.name)
        inj = self.faults if self.faults is not None else faults_mod.active()
        fresh = [
            (t, g) for t, g in arrivals if g.name not in self.bindings
        ]  # BOUND gangs (admitted, capacity held) never re-admit — the
        # zero-double-bound gate is enforced at the cell boundary. Gangs
        # merely REJECTED stay re-offerable: once capacity frees (release,
        # reclaim) a later offer re-solves them instead of no-opping.
        new_bindings: dict[str, dict[str, str]] = {}
        for i, chunk in enumerate(
            _family_chunks(fresh, self.crash_check_every)
        ):
            if i:
                # Between-chunk crash point: deterministic, mid-stream,
                # with journaled waves behind and undecided arrivals ahead.
                try:
                    inj.maybe_raise("cell.crash", cell=self.name)
                except faults_mod.InjectedFault as e:
                    self.crash()
                    # new_bindings = the chunks this call committed (and
                    # journaled) before dying: the caller must count them
                    # as landed here, they rebind on recovery.
                    raise CellCrash(self.name, partial=new_bindings) from e
            self.recorder.epoch += 1
            bindings, stats = drain_stream(
                [(t, g) for t, g in chunk],
                pods_by_name,
                self.snapshot,
                config=self.config,
                params=self.params,
                warm_path=self.warm_path,
                recorder=self.recorder,
                pipeline=self.pipeline,
                scan=self.scan,
                faults=self.faults,
                device=self.device,
            )
            # The engine journals its waves asynchronously; a verdict only
            # counts as decided once it is on disk (crash() persists what
            # the writer accepted, so post-flush == journaled).
            self.recorder.flush()
            self._commit(bindings, chunk, pods_by_name, stats)
            new_bindings.update(bindings)
        return new_bindings

    def _commit(self, bindings, chunk, pods_by_name, stats) -> None:
        """Fold one engine run into the cell state: allocated rows advance
        by the bound pods' requests (the next run's snapshot carries them),
        every verdict latches into the `decided` ledger, admissions into
        the `bindings` gate."""
        for gang, per in bindings.items():
            self.bindings[gang] = dict(per)
            for pod_name, node_name in per.items():
                idx = self.snapshot.node_index(node_name)
                self.snapshot.allocated[idx] += pod_request_vector(
                    pods_by_name[pod_name], self.snapshot.resource_names
                )
        for _, g in chunk:
            self.decided.add(g.name)
        st = self.stats
        st.offered += stats.offered
        st.admitted += stats.admitted
        st.pods_bound += stats.pods_bound
        st.waves += stats.waves
        st.dispatches += stats.drain.dispatches
        st.device_roundtrips += stats.drain.device_roundtrips
        st.host_total_s += stats.drain.host_stages()["hostTotalS"]
        st.host_blocked_s += stats.drain.harvest_s
        st.wall_s += stats.wall_s
        st.engine_runs += 1

    def release_gang(self, gang: str, pods_by_name: dict) -> bool:
        """Cross-cell reclaim: give a borrowed gang's capacity back (the
        coordinator calls this on the HOST cell). Journaled as an action
        record so recovery (and the trace) sees the reclaim beside the
        admissions — recover() mirrors these records, or a released gang
        would resurrect with its capacity. The verdict stays in `decided`
        (it WAS decided here); only the `bindings` gate opens, so the gang
        may legitimately re-admit later."""
        per = self.bindings.pop(gang, None)
        if per is None:
            return False
        for pod_name, node_name in per.items():
            idx = self.snapshot.node_index(node_name)
            row = self.snapshot.allocated[idx]
            row -= pod_request_vector(
                pods_by_name[pod_name], self.snapshot.resource_names
            )
            np.maximum(row, 0.0, out=row)
        self.stats.released += 1
        self.recorder.capture_action(
            time.time(), "cell.reclaim", gang, cell=self.name
        )
        return True

    def status(self) -> dict:
        return {
            "name": self.name,
            "alive": self.alive,
            "nodes": len(self.nodes),
            "queues": sorted(self.owned_queues),
            "journal": self.journal_path,
            "leaseHeld": (None if self.lease is None else self.lease.held()),
            "epoch": self.recorder.epoch,
            **self.stats.to_doc(),
        }


def _family_chunks(arrivals: list, size: int) -> list[list]:
    """Split arrivals into engine-run chunks of WHOLE gang families.

    A scaled gang must share an engine run with its base (or a run where
    the base is already `scheduled`): the encoder gates a scaled gang whose
    base it cannot see, and engine instances don't share their
    scheduled-admitted sets. So chunk boundaries fall only between
    families: members group at the family's first appearance (arrival
    order within a family is preserved, so base-before-scaled holds), and
    a chunk closes once it has at least `size` arrivals. Pure in (arrival
    order, size) — chunking is as replayable as the waves it feeds."""
    order: list[str] = []
    members: dict[str, list] = {}
    for t, g in arrivals:
        key = g.base_podgang_name or g.name
        fam = members.get(key)
        if fam is None:
            fam = members[key] = []
            order.append(key)
        fam.append((t, g))
    chunks: list[list] = []
    cur: list = []
    for key in order:
        cur.extend(members[key])
        if len(cur) >= max(1, size):
            chunks.append(cur)
            cur = []
    if cur:
        chunks.append(cur)
    return chunks


# ---- journal-tail recovery ---------------------------------------------------------


def _next_epoch(records: list[dict]) -> int:
    """Highest engine epoch in the journal (wave ids carry the cell epoch
    prefix); the replacement cell starts past it — `_stream` pre-increments
    before each engine run, so passing the max yields max+1 first."""
    top = 0
    for rec in records:
        if rec.get("kind") != "wave":
            continue
        m = _EPOCH_RE.match(rec.get("wave", ""))
        if m:
            top = max(top, int(m.group(1)))
    return top


def recover(
    name: str,
    nodes: list,
    topology,
    *,
    journal_path: str,
    verify: bool = True,
    warm_path=None,
    device=None,
    **cell_kwargs,
) -> tuple[Cell, RecoveryReport]:
    """Build a crashed cell's replacement from its journal tail.

    1. The manifest names the resume point (last journaled wave id) without
       scanning segments; the tail itself loads via `read_journal`.
    2. With `verify` (the default), the tail REPLAYS bitwise first
       (`trace/replay.replay_journal`) — every wave re-solved through the
       warm path on `device` must reproduce its recorded plan exactly;
       replaying also re-populates the launch cache, so verification IS
       the warm start.
    3. Allocated/free state and bindings rebuild by walking the records in
       commit order: wave records add admitted gangs' bindings + capacity,
       `cell.reclaim` action records (journaled by release_gang) undo them
       — skipping those would resurrect a released gang's binding and
       capacity, and double-bind it if it re-admitted elsewhere after the
       reclaim. Every journaled verdict lands in `decided` (the zero-lost
       ledger); `bindings` gates re-admission, so re-offered traffic can
       neither double-bind a recovered gang nor lose an undecided one.

    A journal whose oldest segments were rotation-pruned away is flagged
    `truncated` (and never `verified`): the pruned waves' admissions are
    unrecoverable, so the rebuilt state under-counts allocation — the
    caller must treat the recovery as best-effort, not sound.

    An empty journal (the cell died before its first segment) recovers to
    a fresh cell with an empty report — nothing was decided, everything
    re-offers.
    """
    from grove_tpu_torch.trace.recorder import journal_truncated
    from grove_tpu_torch.trace.replay import replay_journal

    report = RecoveryReport(cell=name)
    manifest = read_manifest(journal_path)
    if manifest is not None:
        report.resume_point = manifest.get("lastWave")
        report.manifest_segments = len(manifest.get("segments", []))
    try:
        records = read_journal(journal_path)
    except FileNotFoundError:
        records = []
    report.truncated = journal_truncated(journal_path)
    if verify and records:
        rep = replay_journal(records, warm_path=warm_path, device=device)
        report.waves_replayed = len(rep.waves)
        report.divergences = rep.divergence_count
        report.verified = rep.divergence_count == 0 and not report.truncated
    cell = Cell(
        name,
        nodes,
        topology,
        journal_path=journal_path,
        warm_path=warm_path,
        epoch=_next_epoch(records),
        device=device,
        **cell_kwargs,
    )
    # Per-gang allocation contributions applied so far, so a later
    # cell.reclaim record can subtract exactly what its wave added.
    contrib: dict[str, list[tuple[int, np.ndarray]]] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "action" and rec.get("action") == "cell.reclaim":
            gang = rec.get("object")
            report.gangs_reclaimed += 1
            if cell.bindings.pop(gang, None) is None:
                continue  # admit wave pruned away; nothing was re-applied
            for idx, vec in contrib.pop(gang, ()):
                row = cell.snapshot.allocated[idx]
                row -= vec
                np.maximum(row, 0.0, out=row)
            continue
        if kind != "wave":
            continue
        pods_enc = rec.get("pods", {})
        for gang, ok in rec.get("ok", {}).items():
            cell.decided.add(gang)
            if not ok:
                continue
            per = rec.get("plan", {}).get(gang, {})
            cell.bindings[gang] = dict(per)
            report.gangs_rebound += 1
            rows = contrib[gang] = []
            for pod_name, node_name in per.items():
                enc = pods_enc.get(pod_name)
                if enc is None or node_name not in cell.snapshot.node_index_map:
                    continue
                pod = serde.decode(enc)
                idx = cell.snapshot.node_index(node_name)
                vec = pod_request_vector(pod, cell.snapshot.resource_names)
                cell.snapshot.allocated[idx] += vec
                rows.append((idx, vec))
    report.gangs_decided = len(cell.decided)
    cell.stats.recoveries = 1
    return cell, report


def audit_journal(records: list[dict], rel_eps: float = 1e-5) -> dict:
    """Whole-trace oversubscription audit from the journal alone: at every
    wave, entering allocated + the admitted plan's pod requests must fit
    capacity on every touched node. One (wave, node) pair is a node-tick;
    the bench gates `oversubscribed == 0` across the whole trace."""
    fleets: dict[str, dict] = {}
    ticks = 0
    oversubscribed = 0
    for rec in records:
        if rec.get("kind") == "fleet":
            fleets[rec["digest"]] = {
                nd["name"]: nd.get("capacity", {}) for nd in rec["nodes"]
            }
            continue
        if rec.get("kind") != "wave":
            continue
        caps = fleets.get(rec.get("fleet"), {})
        resources = list(rec.get("resources", []))
        load: dict[str, np.ndarray] = {
            node: np.asarray(row, dtype=np.float64)
            for node, row in rec.get("allocated", {}).items()
        }
        pods_enc = rec.get("pods", {})
        req_memo: dict[str, np.ndarray] = {}
        for gang, per in rec.get("plan", {}).items():
            if not rec.get("ok", {}).get(gang):
                continue
            for pod_name, node_name in per.items():
                req = req_memo.get(pod_name)
                if req is None:
                    enc = pods_enc.get(pod_name)
                    if enc is None:
                        continue
                    total = serde.decode(enc).spec.total_requests()
                    req = np.asarray(
                        [total.get(r, 0.0) for r in resources], dtype=np.float64
                    )
                    req_memo[pod_name] = req
                row = load.get(node_name)
                if row is None:
                    row = load[node_name] = np.zeros(len(resources))
                load[node_name] = row + req
        for node, row in load.items():
            ticks += 1
            cap = np.asarray(
                [caps.get(node, {}).get(r, 0.0) for r in resources],
                dtype=np.float64,
            )
            if np.any(row > cap * (1.0 + rel_eps) + 1e-9):
                oversubscribed += 1
    return {"nodeTicks": ticks, "oversubscribed": oversubscribed}
