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

Like the port's drain_backlog, the streaming drain has no `mesh`, `faults`
or `resilience` (the degradation ladder) yet: the ladder slice of the port
brings all three to both drains. The JAX loop's ladder branches are all
guarded by `ladder is not None`, so without them it runs this loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.solver.core import SolverParams, resolve_device
from grove_tpu_torch.solver.drain import DrainStats, ScanConfig, _WavePipeline, plan_waves
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
POLL_S = 0.005


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
            "shardDevices": 0,  # one card, no mesh
        }
        doc.update(self.drain.host_stages())
        pct = self.bind_percentiles((50.0, 99.0))
        if pct is not None:
            doc["bindP50S"] = round(pct[50.0], 4)
            doc["bindP99S"] = round(pct[99.0], 4)
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
    the card unless a plan or the recorder retains it). `device` None means
    the card; "cpu" runs the plain PyTorch versions."""
    cfg = config or StreamConfig()
    params = params or SolverParams()
    dev = resolve_device(device)
    wp = warm_path if warm_path is not None else default_warm_path()
    if pruning is not None and not getattr(pruning, "enabled", False):
        pruning = None
    if cfg.depth < 1:
        raise ValueError(f"streaming depth must be >= 1, got {cfg.depth}")
    if cfg.wave_size < 1:
        raise ValueError(f"streaming waveSize must be >= 1, got {cfg.wave_size}")

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
    resident = base_scan is not None and base_scan.device_resident and not pace

    gangs_all = [g for _, g in arrivals]
    stats = StreamStats(
        offered=len(gangs_all),
        depth=cfg.depth if pipeline else 0,
        mode=("resident" if resident else "scan" if base_scan is not None
              else ("pipeline" if pipeline else "serial")),
        paced=bool(pace),
    )
    dstats = stats.drain
    dstats.gangs = len(gangs_all)
    dstats.harvest = stats.mode if pipeline else "wave"
    dstats.depth = stats.depth
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

    engine = _WavePipeline(
        gangs=gangs_all, pods_by_name=pods_by_name, snapshot=snapshot, params=params,
        stats=dstats, dev=dev, warm_path=wp, pruning=pruning, donate=donation_default(dev),
        retire_lag=None if resident else (cfg.depth if pipeline else 0),
        record_stamps=True, scan=base_scan, recorder=recorder, wave_prefix="stream",
        on_commit=on_commit,
    )

    def _submit(ws) -> None:
        # Lazy preparation of a first-seen shape's launch.
        tc = time.perf_counter()
        if engine.warm_shape(ws):
            dstats.compile_s += time.perf_counter() - tc
        engine.submit(ws)

    # Fusion buffer: consecutive same-class planned waves awaiting one
    # scanned dispatch (only ever filled while saturated with the scan on).
    run_buf: list = []

    def _submit_run(run: list) -> None:
        """Dispatch a same-class run fused; runs shorter than
        min_waves_per_class go wave by wave."""
        if engine.scan is None or len(run) < max(1, int(engine.scan.min_waves_per_class)):
            for ws in run:
                _submit(ws)
            return
        tc = time.perf_counter()
        warmed = engine.warm_shape(run[0])
        warmed = engine.warm_scan(run) or warmed
        if warmed:
            dstats.compile_s += time.perf_counter() - tc
        engine.submit_scan(run, retire=False)
        engine._retire_down()

    def _flush_run() -> None:
        if run_buf:
            run, run_buf[:] = list(run_buf), []
            _submit_run(run)

    def _dispatch_planned(planned: list) -> None:
        """Feed planned waves to the engine in the order given: buffered into
        cross-window fused runs while the scan is on (saturated), a class
        change or a full chunk flushing the run; wave by wave otherwise."""
        if engine.scan is not None and not pace:
            for ws in planned:
                if run_buf and (run_buf[0][1:] != ws[1:]
                                or len(run_buf) >= max(1, int(engine.scan.max_scan_len))):
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

    # Planned waves of up to (1 + affinity_lookahead) windows awaiting reorder.
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
                engine._retire_next()
            else:
                next_due = (t0 + arrivals[i][0]) if i < n else now
                time.sleep(min(POLL_S, max(0.0, next_due - now)))
    _flush_group()  # the trace is exhausted: any partial look-ahead group
    _flush_run()  # ... and any fused run still buffering
    engine.flush()  # resident: one wait harvests every wave first
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
