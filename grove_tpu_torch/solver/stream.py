"""Streaming drain: the always-on admission loop under live arrival traffic
(grove_tpu/solver/stream.py counterpart).

`drain_backlog` answers "a backlog arrived at once"; `drain_stream` admits
gangs while they keep arriving (sim/workloads.arrival_process: bursty,
diurnally modulated, heavy-tailed, multi-tenant). The loop batches queued
arrivals into shape-bucketed waves (plan_waves) and feeds them to the drain's
engine (solver/drain.py `_WavePipeline`): while wave N solves on the card,
the host encodes wave N+1 and decodes and binds wave N - depth.

Four disciplines over one dispatch chain (the same admissions by
construction, only where the host blocks differs):

  resident   the scan's dispatch, and nothing retires until the trace is
             exhausted: scan chunks chain on the card over the whole run and
             one wait harvests every verdict, so device round trips are
             1 + escalations (saturated mode only);
  scan       pipeline + fusion: consecutive same-shape-class waves, across
             windows in saturated mode, dispatch as one scan launch (B4) per
             chunk; window composition is untouched;
  pipeline   retire wave N - depth while wave N is in flight;
  serial     retire every wave before forming the next.

Class-affine forming (ScanConfig.affinity_lookahead L > 0, saturated mode
only): planned waves of up to 1 + L consecutive windows buffer and reorder
by (rank, shape class) before dispatch, each class's gang pad raised to the
class maximum in the group, so same-class runs form under mixed traffic. The
reorder is a function of the requested scan config alone, so a serial run
given the same config sees the same wave sequence, and bindings stay
bitwise comparable.

Two clocks:

  saturated  (pace=False) arrivals are consumed flat out in arrival order:
             wave composition is a function of (arrival order, wave_size),
             so serial and pipelined runs see the same waves;
  paced      (pace=True) arrivals become visible at their trace offsets on
             the host clock; a window forms when wave_size gangs are queued,
             the oldest has waited max_wait_s, or the trace is exhausted.
             Time to bind is measured per admitted gang against its arrival
             instant; while the host waits for arrivals it retires the
             oldest wave in flight.

Bind latencies are `engine.t0 + stamp - avail[gang]` on one perf_counter
origin. On the card a wave's stamp is its completion: the CUDA event behind
its verdict copies, timed against an event recorded at t0 on the idle
stream (an escalated wave's, its re-solve's), not the moment the host
fetched it, so a latency leaves out the host's fetch, decode and bind of
the wave; on the CPU it is the host's clock at the commit, as the JAX
package stamps. A journaled stream names its waves `stream-NNNNNN`.

Warm path: each shape's launch is prepared lazily the first time the loop
meets it (`warm_shape`, and `warm_scan` for a fused run's chunk lengths),
the time counted in `DrainStats.compile_s`; the launch cache, device cache,
candidate pruning with its escalation and the recorder behave as in
drain_backlog.

The degradation ladder (`resilience`, solver/resilience.py) is where the
always-on loop earns its keep: before each dispatch the loop reconciles
the engine with the breaker states (an open `scan` rung dispatches wave by
wave, an open `pruning` rung solves dense, an open `pipeline` rung retires
serially, an open `resident` rung retires at the pipeline depth), and a
wave that fails past the engine's own watchdog and retry budget charges the
first active rung, so repeated failures walk the loop down to the dense,
serial, per-wave configuration and probation walks it back up. A dispatch
failure is resubmitted (a fused run's not-yet-enqueued waves, from
`WaveFault.pending`, one by one) under the stepped-down config; a
retirement failure leaves the wave at the queue head and retries it with
fresh budget; at the bottom of the ladder the failure re-raises. Every rung
admits the same set, so faults change latency, never placements.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.solver.core import SolverParams, resolve_device
from grove_tpu_torch.parallel.mesh import mesh_requested, resolve_layout
from grove_tpu_torch.solver.drain import (
    DrainStats,
    ScanConfig,
    WaveFault,
    _WavePipeline,
    plan_waves,
)
from grove_tpu_torch.solver.resilience import ladder_for
from grove_tpu_torch.solver.warm import default_warm_path, donation_default


@dataclass(frozen=True)
class StreamConfig:
    """The `solver.streaming` config block."""

    # Waves in flight before the host blocks on the oldest (serial ignores it).
    depth: int = 2
    # Most gangs per formed window; also the plan_waves wave size.
    wave_size: int = 64
    # Paced mode: how long the oldest queued gang waits for companions.
    max_wait_s: float = 0.05
    # Paced mode: the longest idle sleep while waiting for the next arrival.
    poll_s: float = 0.005


@dataclass
class StreamStats:
    """One streaming run, as measured (wall seconds unless noted)."""

    offered: int = 0  # gangs fed from the arrival trace
    admitted: int = 0
    pods_bound: int = 0
    waves: int = 0
    windows: int = 0  # arrival windows formed (each plans >= 1 wave)
    wall_s: float = 0.0
    gangs_per_sec: float = 0.0  # admitted / wall
    depth: int = 0
    mode: str = "pipeline"  # resident | scan | pipeline | serial
    paced: bool = False
    # Per admitted gang, enqueue -> bound seconds in commit order: against
    # the arrival instant when paced, pull -> bound when saturated.
    bind_latencies: list = field(default_factory=list)
    # The engine's phase, cache and escalation ledger for this run.
    drain: DrainStats = field(default_factory=DrainStats)

    def bind_percentiles(self, qs=(50.0, 99.0)) -> dict | None:
        """Measured time-to-bind percentiles; None when nothing was bound."""
        if not self.bind_latencies:
            return None
        return {float(q): float(np.percentile(self.bind_latencies, q)) for q in qs}

    def to_doc(self) -> dict:
        doc = {
            "streamGangs": self.offered,
            "streamAdmitted": self.admitted,
            "streamPodsBound": self.pods_bound,
            "streamWaves": self.waves,
            "streamWallS": round(self.wall_s, 4),
            "gangsPerSec": round(self.gangs_per_sec, 2),
            "depth": self.depth,
            "mode": self.mode,
            "paced": self.paced,
            "shardDevices": self.drain.shard_devices,
        }
        doc.update(self.drain.host_stages())
        pct = self.bind_percentiles((50.0, 99.0))
        if pct is not None:
            doc["bindP50S"] = round(pct[50.0], 4)
            doc["bindP99S"] = round(pct[99.0], 4)
        # The fault-recovery ledger, only when something fired.
        res = self.drain.resilience_doc()
        if any(res.values()):
            doc.update(res)
        return doc


def drain_stream(
    arrivals: list,
    pods_by_name: dict,
    snapshot,
    *,
    config: StreamConfig | None = None,
    params: SolverParams | None = None,
    warm_path=None,
    pruning=None,
    recorder=None,
    pipeline: bool = True,
    scan=None,
    pace: bool = False,
    order_key=None,
    device=None,
    mesh=None,
    faults=None,
    resilience=None,
) -> tuple[dict[str, dict[str, str]], StreamStats]:
    """Admit a live arrival trace; returns ({gang: {pod: node}}, StreamStats).

    `arrivals` is a list of (t_offset_seconds, PodGang) sorted by offset,
    base gangs before their scaled gangs (sim.workloads.expand_arrivals).
    `pipeline` False is the wave-serial baseline. `scan` (None, True or a
    ScanConfig) fuses same-class runs into scan launches (fusion needs
    `pipeline`; class-affine forming does not, see the module docstring);
    `ScanConfig.device_resident` retires nothing until the trace is
    exhausted. `pace` honours the arrival offsets on the host clock.
    `order_key` (a callable on PodGang, uniform across a base gang and its
    scaled gangs, e.g. a tenancy tier) stable-sorts the queue before each
    window is sliced. `warm_path` None is the process-shared WarmPath;
    `pruning` and `recorder` as in drain_backlog (the carry is donated on
    the card unless a plan, the recorder or resilience retains it).
    `resilience` (a ResilienceConfig or a shared DegradationLadder) and
    `faults` (a faults.FaultInjector; None = the process-installed one): see
    the module docstring; `mesh` as in drain_backlog. `device` None means
    the card; "cpu" runs the plain PyTorch versions."""
    cfg = config or StreamConfig()
    params = params or SolverParams()
    dev = resolve_device(device)
    wp = warm_path if warm_path is not None else default_warm_path()
    if pruning is not None and not getattr(pruning, "enabled", False):
        pruning = None
    ladder = ladder_for(resilience)
    if cfg.depth < 1:
        raise ValueError(f"streaming depth must be >= 1, got {cfg.depth}")
    if cfg.wave_size < 1:
        raise ValueError(f"streaming waveSize must be >= 1, got {cfg.wave_size}")
    layout = None
    shard_fallback = 0
    if mesh is not None:
        layout = resolve_layout(mesh, int(snapshot.free.shape[0]))
        shard_fallback = int(layout is None and mesh_requested(mesh))

    # Fusion needs the pipelined engine; class-affine forming does not (it is
    # a function of the requested scan config, so a serial baseline handed
    # the same config sees the same wave sequence).
    requested_scan = None
    if scan is not None:
        requested_scan = ScanConfig() if scan is True else scan
        if not requested_scan.enabled:
            requested_scan = None
    base_scan = requested_scan if pipeline else None
    affine = None
    if requested_scan is not None and not pace and int(requested_scan.affinity_lookahead) > 0:
        affine = requested_scan
    resident_req = base_scan is not None and base_scan.device_resident and not pace

    gangs_all = [g for _, g in arrivals]
    stats = StreamStats(
        offered=len(gangs_all),
        depth=cfg.depth if pipeline else 0,
        mode=("resident" if resident_req else "scan" if base_scan is not None
              else ("pipeline" if pipeline else "serial")),
        paced=bool(pace),
    )
    dstats = stats.drain
    dstats.gangs = len(gangs_all)
    dstats.harvest = stats.mode if pipeline else "wave"
    dstats.depth = stats.depth
    dstats.shard_fallbacks = shard_fallback
    if not gangs_all:
        return {}, stats

    exec0 = (wp.executables.hits, wp.executables.misses, wp.executables.lowerings)
    avail: dict[str, float] = {}  # gang name -> the instant it became visible

    def on_commit(members, wave_bindings, stamp):
        wall = engine.t0 + stamp
        for g in members:
            if g.name in wave_bindings:
                # Not clamped at 0 (the JAX package clamps): a card clock
                # anchored after t0 shows as a negative latency.
                stats.bind_latencies.append(wall - avail[g.name])

    # The ladder's starting configuration and the engine's watchdog arms.
    base_lag = cfg.depth if pipeline else 0
    base_layout, base_pruning = layout, pruning
    scan_cfg = base_scan
    watchdog_s, max_wave_retries = None, 0
    if ladder is not None:
        watchdog_s = ladder.config.watchdog_seconds
        max_wave_retries = ladder.config.max_wave_retries
        if scan_cfg is not None and not ladder.allows("scan"):
            scan_cfg = None
        if not ladder.allows("mesh"):
            layout = None
        if not ladder.allows("pruning"):
            pruning = None
        # Consulted here as the JAX stream consults it (applied through the
        # retire lag below): a consult reads the ladder's clock and can end
        # a probation, so the consults' count is part of the schedule.
        ladder.allows("pipeline")

    def _effective_lag(scan_armed: bool) -> int | None:
        """Where the host blocks: serial (0) with the pipeline rung open,
        resident (None: retire at the final flush) when requested with the
        resident rung and the scan dispatch up, else the pipelined depth."""
        if ladder is not None and not ladder.allows("pipeline"):
            return 0
        if resident_req and scan_armed and (ladder is None or ladder.allows("resident")):
            return None
        return base_lag

    engine = _WavePipeline(
        gangs=gangs_all, pods_by_name=pods_by_name, snapshot=snapshot, params=params,
        stats=dstats, dev=dev, warm_path=wp, pruning=pruning, donate=donation_default(dev),
        retire_lag=_effective_lag(scan_cfg is not None), record_stamps=True, scan=scan_cfg,
        recorder=recorder, wave_prefix="stream", on_commit=on_commit, faults=faults,
        watchdog_s=watchdog_s, max_wave_retries=max_wave_retries, layout=layout,
    )

    def _active_rungs() -> tuple:
        """The rungs at full config: the ones a new failure can step down
        (attribution order is resilience.SUBSYSTEMS)."""
        active = []
        if resident_req and engine.retire_lag is None and engine.scan is not None:
            active.append("resident")
        if engine.scan is not None:
            active.append("scan")
        if engine.layout is not None:
            active.append("mesh")
        if engine.pruning is not None:
            active.append("pruning")
        if engine.retire_lag != 0:
            active.append("pipeline")
        return tuple(active)

    def _reconcile_ladder() -> None:
        """Engine config <- breaker states: step open rungs down, step
        probation-expired rungs back up (a half-open trial: the next wave
        runs at full config; its outcome closes or re-opens the breaker).
        A layout transition flushes the in-flight waves first; a hung wave
        blocking it leaves the layout as it is this round."""
        try:
            if engine.layout is not None and not ladder.allows("mesh"):
                engine.strip_layout()
            elif engine.layout is None and base_layout is not None and ladder.allows("mesh"):
                engine.adopt_layout(base_layout)
        except WaveFault as e:
            if e.fatal:
                raise
        engine.set_scan(base_scan if ladder.allows("scan") else None)
        engine.set_pruning(base_pruning if ladder.allows("pruning") else None)
        engine.set_retire_lag(_effective_lag(engine.scan is not None))

    def _charge(e: WaveFault) -> None:
        """A wave failed past the engine's retry budget: charge the first
        active rung and step the engine down, or re-raise when there is no
        ladder, the fault is fatal, or no rung is left."""
        if ladder is None or e.fatal:
            raise e
        if ladder.record_failure(active=_active_rungs()) is None:
            raise e  # the bottom of the ladder, still failing
        _reconcile_ladder()

    def _retire_down(to_lag: bool) -> None:
        """Retire down to the pipeline depth (or everything, at the final
        flush) under the ladder: a retirement failure leaves the wave at the
        queue head, steps the ladder down, and the next attempt retries it
        with fresh watchdog budget — a hung wave degrades the loop, it never
        loses a gang."""
        if not to_lag and engine.retire_lag is None:
            engine.harvest_inflight()
        while engine.retire_due() if to_lag else engine.inflight:
            try:
                engine._retire_next()
                if ladder is not None:
                    ladder.record_success()
            except WaveFault as e:
                _charge(e)

    def _submit(ws) -> None:
        # retire=False: a failure here means the wave was NOT enqueued, so
        # the same wave is resubmitted under the stepped-down config.
        while True:
            try:
                if ladder is not None:
                    _reconcile_ladder()
                tc = time.perf_counter()  # lazy preparation of a first-seen shape
                if engine.warm_shape(ws):
                    dstats.compile_s += time.perf_counter() - tc
                engine.submit(ws, retire=False)
                if ladder is not None:
                    ladder.record_success()
                break
            except WaveFault as e:
                _charge(e)
        _retire_down(to_lag=True)

    # Fusion buffer: consecutive same-class planned waves awaiting one
    # scanned dispatch (only ever filled while saturated with the scan on).
    run_buf: list = []

    def _submit_run(run: list) -> None:
        """Dispatch a same-class run fused; a failure past the retry budget
        charges the ladder and resubmits exactly the not-yet-enqueued tail
        (wave by wave once the scan rung is open). Runs shorter than
        min_waves_per_class go wave by wave."""
        pending = run
        while pending:
            if ladder is not None:
                _reconcile_ladder()
            if engine.scan is None or len(pending) < max(1, int(engine.scan.min_waves_per_class)):
                for ws in pending:
                    _submit(ws)
                return
            try:
                tc = time.perf_counter()
                warmed = engine.warm_shape(pending[0])
                warmed = engine.warm_scan(pending) or warmed
                if warmed:
                    dstats.compile_s += time.perf_counter() - tc
                engine.submit_scan(pending, retire=False)
                if ladder is not None:
                    ladder.record_success()
                pending = []
            except WaveFault as e:
                rest = e.pending if e.pending is not None else pending
                _charge(e)
                pending = rest
            _retire_down(to_lag=True)

    def _flush_run() -> None:
        if run_buf:
            run, run_buf[:] = list(run_buf), []
            _submit_run(run)

    def _dispatch_planned(planned: list) -> None:
        """Feed planned waves to the engine in the order given: buffered into
        cross-window fused runs while the scan is on (saturated), a class
        change or a full chunk flushing the run; wave by wave otherwise."""
        if engine.scan is not None and not pace:
            # The chunk length is the requested config's: a flush below can
            # step the scan rung down mid-list (engine.scan None), and the
            # buffered run then goes wave by wave in the same order.
            max_len = max(1, int(base_scan.max_scan_len))
            for ws in planned:
                if run_buf and (run_buf[0][1:] != ws[1:] or len(run_buf) >= max_len):
                    _flush_run()
                run_buf.append(ws)
        else:
            _flush_run()
            for ws in planned:
                _submit(ws)

    def _affine_order(group: list) -> list:
        """Class-affine reorder of one look-ahead group: rank 0 before rank 1
        (every base still dispatches before any scaled gang), shape classes
        in first-appearance order within a rank, each class's waves
        contiguous in window order with the gang pad raised to the class
        maximum (padded slots are invalid gangs: binding-neutral). A
        single-window group is plan_waves' own order."""
        buckets: dict = {}
        for ws in group:
            rank = 0 if ws[0][0].base_podgang_name is None else 1
            buckets.setdefault((rank, ws[1]), []).append(ws)
        out: list = []
        for rank in (0, 1):
            for (r, _shape), members in buckets.items():
                if r != rank:
                    continue
                pad = max(ws[2] for ws in members)
                out.extend((ws[0], ws[1], pad) for ws in members)
        return out

    # Planned waves of up to (1 + affinity_lookahead) windows awaiting
    # reorder: a function of the requested scan config, never of the ladder.
    wave_buf: list = []
    buf_windows = 0
    lookahead = int(affine.affinity_lookahead) if affine is not None else 0

    def _flush_group() -> None:
        nonlocal buf_windows
        if not wave_buf:
            return
        group, wave_buf[:] = list(wave_buf), []
        buf_windows = 0
        _dispatch_planned(_affine_order(group))

    t0 = engine.start_clock()
    queue: list = []
    i, n = 0, len(arrivals)
    while i < n or queue:
        now = time.perf_counter()
        if pace:
            while i < n and arrivals[i][0] <= now - t0:
                off, g = arrivals[i]
                queue.append(g)
                avail[g.name] = t0 + off
                i += 1
        else:
            while i < n and len(queue) < cfg.wave_size:
                g = arrivals[i][1]
                queue.append(g)
                avail[g.name] = now
                i += 1
        ready = len(queue) >= cfg.wave_size or (i >= n and bool(queue))
        if pace and queue and not ready:
            # The batching window: anchored on the earliest arrival queued
            # (under order_key the sorted head need not be the oldest).
            oldest = (min(avail[g.name] for g in queue) if order_key is not None
                      else avail[queue[0].name])
            ready = (now - oldest) >= cfg.max_wait_s
        if ready:
            if order_key is not None and len(queue) > 1:
                queue.sort(key=order_key)  # stable: FIFO within equal keys
            window, queue = queue[: cfg.wave_size], queue[cfg.wave_size:]
            stats.windows += 1
            planned = plan_waves(window, cfg.wave_size)
            if affine is not None:
                wave_buf.extend(planned)
                buf_windows += 1
                if buf_windows >= 1 + lookahead:
                    _flush_group()
            else:
                _dispatch_planned(planned)
        elif pace:
            if engine.inflight:
                # The host is idle until the next arrival: retire the oldest
                # wave in flight now rather than wait on it later.
                try:
                    engine._retire_next()
                except WaveFault as e:
                    _charge(e)
            else:
                next_due = (t0 + arrivals[i][0]) if i < n else now
                time.sleep(min(cfg.poll_s, max(0.0, next_due - now)))
    _flush_group()  # the trace is exhausted: any partial look-ahead group
    _flush_run()  # ... and any fused run still buffering
    _retire_down(to_lag=False)  # resident: one wait harvests every wave first
    dstats.free_after = engine.free.cpu().numpy()
    stats.wall_s = time.perf_counter() - t0
    dstats.total_s = stats.wall_s
    stats.waves = dstats.waves
    stats.admitted = dstats.admitted
    stats.pods_bound = dstats.pods_bound
    stats.gangs_per_sec = stats.admitted / stats.wall_s if stats.wall_s > 0 else 0.0
    dstats.exec_cache_hits = wp.executables.hits - exec0[0]
    dstats.exec_cache_misses = wp.executables.misses - exec0[1]
    dstats.lowerings = wp.executables.lowerings - exec0[2]
    if dstats.pruned_waves:
        wp.prune.pruned_solves += dstats.pruned_waves
        wp.prune.escalations += dstats.escalations
        wp.prune.escalations_adopted += dstats.escalations_adopted
        wp.prune.last_candidate_nodes = dstats.candidate_nodes
        wp.prune.last_candidate_pad = dstats.candidate_pad
        wp.prune.last_fleet_nodes = int(snapshot.free.shape[0])
    wp.record_drain(dstats)
    wp.record_stream(stats.to_doc(), stats.bind_latencies)
    return engine.bindings, stats
