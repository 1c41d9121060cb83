"""Mass admission: drain a whole gang backlog through the solver
(grove_tpu/solver/drain.py counterpart).

  1. Shape-bucketed waves (plan_waves): gangs batch with others of their own
     padded encode shape; base gangs dispatch before scaled gangs.
  2. Every wave is encoded on the host, uploaded through pinned memory, and
     solved on the current stream. The wave carry — the fleet's `free`
     tensor and the `ok_global` verdict bitmap — stays on the card and is
     updated in place by each launch (the JAX package donates the same two
     buffers), so the host never waits between waves: a scaled gang's base
     verdict is read on the card.
  3. Right after each launch its verdict planes are copied to pinned host
     memory without blocking and a CUDA event is recorded behind them. A
     wave's fetch waits on its own event only, never on launches enqueued
     after it, so a retirement overlaps the waves still in flight.

Five HARVEST disciplines over that one dispatch chain (identical bindings by
construction: the chain is the same, only where the host blocks differs):

  - "chained":  retire nothing until every wave is dispatched, then wait on
    the newest event once (one round trip) and retire in order;
  - "wave":     retire each wave right after its dispatch: the host waits
    for every wave, and each wave's completion stamp is measured;
  - "pipeline": at most `depth` waves in flight; dispatching wave N first
    retires wave N - depth, so the host's encode and decode overlap the
    card's work, with measured stamps;
  - "scan":     each run of same-shape waves is one scan launch (B4) per
    chunk of up to `ScanConfig.max_scan_len` waves, retired as "pipeline"
    retires, one fetch per chunk: dispatches and round trips drop to
    O(chunks + escalations);
  - "resident": the scan's dispatch with the chained retirement: the card
    runs the whole backlog, then one wait harvests every chunk and wave, so
    device_roundtrips == 1 + escalations.

The engine (`_WavePipeline`) owns the carry, retirement order and the
exactness escalation of candidate pruning (`pruning`, solver/pruning.py):
each wave's plan is cut against the initial snapshot, and the wave solves on
its candidate axis (on the card the gather, the scatter back into the fleet
carry and the remap run inside the wave's launch). A pruned drain keeps each
wave's entering carry on the card. At retirement a wave holding a valid gang
that was rejected and marked lossy by its plan re-solves DENSE from that
carry: identical verdicts CONFIRM the pruned result; changed ones ADOPT the
dense result and re-dispatch every wave still in flight from the adopted
carry (as fused chunks where the scan is on), each fetched again when it
retires. Admitted sets equal the dense drain's.

Portfolio (`portfolio` P > 1, the solver.portfolio knob): every wave is
solved under P weight variants and the winner's free_after and verdicts
chain forward — on the card one stacked launch per wave. The population is
drawn once per drain. Portfolio drains never prune or scan (the JAX
package's rules: "scan" and "resident" then run as "pipeline").

Flight recorder (`recorder`, trace/recorder.py; single-variant drains
only, as in the JAX package): every wave journals at commit, in commit order
with monotonic ids, with the closure replay needs to re-solve it alone — its
exact entering free rows (each wave's entering carry is kept and copied to
the host behind its launch, beside its verdicts), the allocation entering
it, the earlier waves' admissions as `scheduled`, and a pruned wave's
candidate list. A failure to journal never breaks the drain (the JAX
package's rule); it shows as journaled_waves < waves and the recorder's
`dropped`.

Warm path (`warm_path`, solver/warm.py; the process-shared one by default):
single-variant solves go through its launch cache — on the card one
prepared launch per shape key, replayed as a CUDA graph — and a pre-pass,
which is not timed, prepares every planned shape (and, for "scan"
and "resident", every chunk length) without running it, with encodes that
bypass the row cache. The timed encodes reuse each gang's rows from the
previous drain of the same spec and snapshot (`encode_reuse_*`), node state
comes from the warm path's device cache, and `donate` (default: on for the
card) marks the carry as not retained. A second drain of a backlog then
prepares nothing: DrainStats counts `lowerings`, `exec_cache_*` and
`encode_reuse_*` per drain. Portfolio drains bypass the launch cache, as in
the JAX package; their pre-pass has nothing to prepare.

Resilience (`faults`, `resilience`; faults/__init__.py,
solver/resilience.py): the engine evaluates the `solver.dispatch` fault
site before every launch (a wave, a scan chunk, a re-chained wave or
chunk) and `solver.harvest` before every fetch. A failed dispatch is
retried up to `max_wave_retries` times from the same carry (the solve is
deterministic); exhaustion raises `WaveFault` for the caller's ladder. A
wave whose verdicts are not on the host within `watchdog_s` of its
dispatch — on the card, its CUDA event's `query()` still false, polled
without blocking; on the CPU there is no event and so no probe — or whose
injected harvest timeout fires, is cancelled and re-dispatched, on the
same stream, from its retained entering carry without advancing the live
carry (later waves already chained off the original output, and the
re-dispatch's free_after lands in a fresh buffer). The chained and
resident disciplines' one batched wait polls the newest event against the
oldest wave's deadline instead of blocking; past it, every wave retires
through its own probe. Arming faults or a
ladder retains every wave's entering carry, so donation is off and the
launch-cache keys change as the JAX package's `donate` key part does.
With resilience off (`max_wave_retries` 0 and no injector) a raw error
propagates unchanged; no path continues on a plain version after a kernel
error. `drain_backlog` consults the ladder once, at construction: open
rungs step it down (resident -> scan -> pipeline -> wave, pruning off,
portfolio 1); the streaming drain reconciles the engine with the ladder
between waves (`set_scan`, `set_retire_lag`, `set_pruning`, and the
mesh rung's `strip_layout` / `adopt_layout`). `mesh` (a parallel.mesh
SolveLayout, or a MeshConfig negotiated here) shards every single-variant
wave of the chained, wave and pipeline disciplines over the layout's
shards (kernel B7 on the card; dense or pruned, the candidate pad
negotiated divisible by the shards), `DrainStats.shard_devices` says how
many, and journaled waves record the layout's fingerprint. A requested
mesh that resolves to no layout (one device, a fleet under minNodes)
counts one fallback (`DrainStats.shard_fallbacks`) and solves unsharded.
The scan and resident disciplines under a layout raise
(parallel/mesh.py WAITS_SCAN).

The streaming drain (solver/stream.py `drain_stream`) drives the same
engine through its hooks: `submit(ws, retire)` dispatches and (by default)
retires down to the pipeline depth, `submit_scan(run, retire=False)`
enqueues a run's chunks without retiring between them, `retire_due()`
says when the stream's own loop should retire, `on_commit` is called at
each commit with the wave's bindings and stamp, and `wave_prefix` names the
journaled waves ("stream-000000", ...).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from grove_tpu_torch import faults as faults_mod
from grove_tpu_torch.solver.core import (
    SolverParams,
    decode_bindings,
    resolve_device,
    stack_on,
)
from grove_tpu_torch.solver.encode import encode_gangs, gang_shape, next_pow2, stack_batches
from grove_tpu_torch.parallel.mesh import WAITS_SCAN, mesh_requested, resolve_layout
from grove_tpu_torch.solver.pruning import (
    PruningConfig,
    lossy_rejections,
    plan_candidates,
    stack_plan_arrays,
)
from grove_tpu_torch.solver.resilience import ladder_for
from grove_tpu_torch.solver.warm import default_warm_path, donation_default, gang_row_digest

HARVEST_MODES = ("chained", "wave", "pipeline", "scan", "resident")


class WaveFault(RuntimeError):
    """A wave failed past its retry budget. `in_flight` tells the caller
    whether the wave is still queued in the engine (a retirement failure —
    do NOT resubmit) or never made it in (a dispatch failure — resubmit
    after stepping the ladder down). Callers without a ladder see it
    propagate like any other error."""

    def __init__(self, message: str, *, in_flight: bool, fatal: bool = False):
        super().__init__(message)
        self.in_flight = in_flight
        # fatal: the carry chain can no longer be trusted (an escalation
        # re-chain died past its retry budget mid-adoption); the caller must
        # surface the error, not degrade around it.
        self.fatal = fatal
        # A fused submit (submit_scan) that failed mid-run sets this to the
        # planned waves NOT yet enqueued (the failed one onward, in order):
        # the caller resubmits exactly these, wave by wave, under the
        # stepped-down config, so a chunk failure never drops arrivals.
        self.pending: list | None = None


@dataclass(frozen=True)
class ScanConfig:
    """The `solver.scan` config block: each run of same-shape waves is one
    scan launch per chunk."""

    enabled: bool = True
    # Longest run of waves in one scan launch; longer runs split into chunks.
    max_scan_len: int = 32
    # Runs (and chunks) shorter than this dispatch wave by wave.
    min_waves_per_class: int = 2
    # The streaming drain (`drain_stream`, saturated): waves planned up to
    # this many windows ahead reorder by shape class (class-affine forming).
    affinity_lookahead: int = 4
    # `drain_stream`, saturated: retire nothing until the trace is exhausted,
    # then harvest everything with one wait.
    device_resident: bool = False


@dataclass
class DrainStats:
    """Phase breakdown of one drain (host wall seconds unless noted)."""

    compile_s: float = 0.0  # the warm pre-pass: every (shape, pad) launch prepared
    encode_s: float = 0.0  # host dense encode, all waves
    prune_s: float = 0.0  # host candidate-plan cutting, all waves
    dispatch_s: float = 0.0  # upload + launch of every wave or chunk (no waiting)
    harvest_s: float = 0.0  # host time blocked on the card's verdicts
    decode_s: float = 0.0  # host decode of all bindings
    bind_s: float = 0.0  # committing decoded bindings and scores
    total_s: float = 0.0  # the timed drain: encode through the last binding
    waves: int = 0
    gangs: int = 0
    admitted: int = 0
    pods_bound: int = 0
    scores: list = field(default_factory=list)  # per admitted gang
    # Warm-path counters, as deltas of this drain (the caches are shared):
    # launch-cache traffic, entries prepared, and per-gang encode-row reuse.
    exec_cache_hits: int = 0
    exec_cache_misses: int = 0
    lowerings: int = 0
    encode_reuse_hits: int = 0
    encode_reuse_misses: int = 0
    donated: bool = False  # the carry was not retained (warm.py donation)
    # Candidate pruning: waves solved on a candidate axis, the largest
    # candidate count and pad among them, and the escalation ledger (a
    # lossy-rejected wave re-solves dense; `escalations_adopted` counts the
    # re-solves that changed a verdict).
    pruned_waves: int = 0
    candidate_nodes: int = 0
    candidate_pad: int = 0
    escalations: int = 0
    escalations_adopted: int = 0
    # Harvest discipline (HARVEST_MODES) and, for "pipeline" and "scan", the
    # waves allowed in flight before the host blocks on the oldest (else 0).
    harvest: str = "chained"
    depth: int = 0
    # Round-trip ledger: `dispatches` counts solves enqueued (per wave, per
    # scan chunk, per escalation re-solve, per re-chained wave or chunk);
    # `device_roundtrips` counts host waits on the card's verdicts (one per
    # wave fetch, per chunk fetch, per chained/resident harvest, per
    # escalation verdict).
    dispatches: int = 0
    device_roundtrips: int = 0
    # Scan ledger: chunks launched as scans and the waves they covered (the
    # rest ran wave by wave); `scan_rechains` counts chunks re-dispatched
    # from an adopted carry (kept out of scan_chunks).
    scan_chunks: int = 0
    scanned_waves: int = 0
    scan_rechains: int = 0
    # "wave", "pipeline" and "scan": (gangs admitted in the wave, its stamp:
    # seconds since the drain began at which the wave completed — on the
    # card its last event's time on the card's clock, on the CPU the host's
    # clock at its fetch), in commit order.
    wave_latencies: list = field(default_factory=list)
    portfolio: int = 1  # weight variants per wave
    # Waves journaled to a flight recorder, and the host seconds journaling
    # cost (capture at commit).
    journaled_waves: int = 0
    journal_s: float = 0.0
    # The fleet's free capacity after the last wave, as the solver left it
    # (copied to the host once every wave has retired and the card is idle).
    free_after: np.ndarray | None = None
    # Mesh: the node-axis shards every wave solved across (0 = unsharded),
    # and requested meshes that solved unsharded (never silent).
    shard_devices: int = 0
    shard_fallbacks: int = 0
    # Resilience ledger: dispatch retries paid inside the engine, watchdog
    # timeouts observed on in-flight waves, waves cancelled (timeout ->
    # cancel -> re-dispatch), and the re-dispatches. Zero on a healthy run.
    wave_retries: int = 0
    watchdog_timeouts: int = 0
    waves_cancelled: int = 0
    wave_redispatches: int = 0

    def resilience_doc(self) -> dict:
        """The fault-recovery counters of this run (the JAX package's keys)."""
        return {
            "waveRetries": self.wave_retries,
            "watchdogTimeouts": self.watchdog_timeouts,
            "wavesCancelled": self.waves_cancelled,
            "waveRedispatches": self.wave_redispatches,
        }

    def host_stages(self) -> dict:
        """The host-stage ledger: seconds per host stage (harvest is the
        wait for the card: reported, not in hostTotalS), the round-trip
        ledger, and host milliseconds per wave."""
        host_total = (self.encode_s + self.prune_s + self.dispatch_s + self.decode_s
                      + self.bind_s + self.journal_s)
        doc = {
            "hostEncodeS": round(self.encode_s, 6),
            "hostPrefilterS": round(self.prune_s, 6),
            "hostDispatchS": round(self.dispatch_s, 6),
            "hostHarvestS": round(self.harvest_s, 6),
            "hostDecodeS": round(self.decode_s, 6),
            "hostBindS": round(self.bind_s, 6),
            "hostJournalS": round(self.journal_s, 6),
            "hostTotalS": round(host_total, 6),
            "hostHotPathS": round(self.encode_s + self.prune_s + self.decode_s + self.bind_s, 6),
            "dispatches": self.dispatches,
            "deviceRoundtrips": self.device_roundtrips,
        }
        if self.scan_chunks or self.scanned_waves:
            doc["scanChunks"] = self.scan_chunks
            doc["scannedWaves"] = self.scanned_waves
        if self.scan_rechains:
            doc["scanRechains"] = self.scan_rechains
        if self.waves:
            doc["hostPerWaveMs"] = round(1000.0 * host_total / self.waves, 4)
        return doc

    def latency_percentiles(self, qs=(50.0, 99.0)) -> dict | None:
        """Measured per-gang bind-latency percentiles from `wave_latencies`
        (every gang of a wave lands at that wave's stamp). None for a drain
        that measured nothing: no wave, a chained or resident drain, or no
        wave that admitted a gang. A 1-wave drain gives its stamp at every
        percentile."""
        series = [(n, t) for n, t in self.wave_latencies if n > 0]
        if not series:
            return None
        lat = np.concatenate([np.full(n, t) for n, t in series])
        return {float(q): float(np.percentile(lat, q)) for q in qs}


def plan_waves(gangs: list, wave_size: int = 256) -> list[tuple[list, tuple, int]]:
    """Shape-bucketed, rank-ordered waves: (members, (mg, ms, mp), pad).

    Rank 0 (base gangs) precedes rank 1 (scaled gangs); within a rank, shape
    classes go in order of their first member. Full waves pad the gang axis
    to max(32, next_pow2(wave_size)); a class that fits in one wave pads to
    next_pow2 of its size; a class with a full wave pads its remainder to the
    full pad."""

    def _padded_shape(g):
        mg_g, ms_g, mp_g = gang_shape(g)
        return (mg_g, max(ms_g, 1), next_pow2(mp_g))

    full_pad = max(32, next_pow2(wave_size))
    waves: list[tuple[list, tuple, int]] = []
    for rank in (0, 1):
        classes: dict[tuple, list] = {}
        for g in gangs:
            if (g.base_podgang_name is not None) == bool(rank):
                classes.setdefault(_padded_shape(g), []).append(g)
        for shape, members in classes.items():
            n_full = len(members) // wave_size
            for i in range(0, len(members), wave_size):
                wave = members[i : i + wave_size]
                pad = full_pad
                if len(wave) < wave_size and n_full == 0:
                    pad = next_pow2(len(wave))
                waves.append((wave, shape, pad))
    return waves


class _WavePipeline:
    """The drain engine: one chain of dispatches on the device, retired in
    dispatch order.

    `retire_lag` decides where the host blocks: None — only at flush(), one
    wait for everything ("chained", "resident"); 0 — right after each
    dispatch ("wave"); k > 0 — at most k waves in flight ("pipeline",
    "scan"). A retiring pruned wave with a lossy rejection escalates (see
    the module docstring); an adoption re-chains every wave still in flight,
    so the bindings are the same under every discipline."""

    def __init__(self, *, gangs, pods_by_name, snapshot, params, stats, dev, warm_path,
                 pruning=None, portfolio=1, donate=False, retire_lag=None, record_stamps=False,
                 scan=None, recorder=None, wave_prefix="drain", on_commit=None, faults=None,
                 watchdog_s=None, max_wave_retries=0, clock=None, watchdog_poll_s=0.001,
                 layout=None):
        self.pods_by_name = pods_by_name
        self.snapshot = snapshot
        self.params = params
        self.stats = stats
        self.dev = dev
        self.wp = warm_path
        self.pruning = pruning
        self.portfolio, self.pstack = portfolio, None
        # Single-variant solves go through the launch cache; the portfolio's
        # stacked launch with its select does not (the JAX package's rule).
        self.use_exec_cache = portfolio == 1
        if portfolio > 1:
            from grove_tpu_torch.parallel.portfolio import params_population

            # Hoisted: drawn and uploaded once per drain, not per wave.
            self.pstack = stack_on(params_population(portfolio, base=params), dev)
        self.retire_lag = retire_lag
        self.record_stamps = record_stamps
        # Journaled wave ids are f"{wave_prefix}-{seq:06d}"; on_commit(members,
        # wave_bindings, stamp_s) runs at every commit (the stream's clock).
        self.wave_prefix = wave_prefix
        self.on_commit = on_commit
        self.scan = scan if portfolio == 1 else None
        self.recorder = recorder if portfolio == 1 else None
        # Node-sharded solves (parallel/mesh.py SolveLayout): every wave's
        # launch is the layout-keyed B7 entry; single-variant drains only.
        self.layout = layout if self.use_exec_cache else None
        if self.layout is not None and self.scan is not None and self.scan.enabled:
            raise NotImplementedError(f"a scanned drain under a layout waits for {WAITS_SCAN}")
        stats.shard_devices = self.layout.node_devices if self.layout else 0
        # Fault injection: the process-installed injector unless the caller
        # passed one, None when disabled (the per-wave check is one `is`).
        inj = faults if faults is not None else faults_mod.active()
        self.faults = inj if inj.enabled else None
        self.watchdog_s = watchdog_s
        self.max_wave_retries = int(max_wave_retries)
        self.clock = clock if clock is not None else time.perf_counter
        self.watchdog_poll_s = watchdog_poll_s
        # Entering carries are kept per wave for the escalation re-solves,
        # for journaling and for the watchdog's re-dispatch.
        self.retain_carries = (pruning is not None or self.recorder is not None
                               or self.faults is not None or watchdog_s is not None
                               or self.max_wave_retries > 0)
        self.donate = bool(donate and self.use_exec_cache and not self.retain_carries)
        stats.donated = self.donate
        self.gidx = {g.name: i for i, g in enumerate(gangs)}
        # Node state from the warm path's device cache: a drain of a
        # snapshot already seen uploads none of it.
        cache = warm_path.device
        self.capacity = cache.device_array(snapshot.capacity, torch.float32, dev)
        self.schedulable = cache.device_array(snapshot.schedulable, torch.bool, dev)
        self.node_domain_id = cache.device_array(snapshot.node_domain_id, torch.int32, dev)
        self.domains = cache.domain_index(snapshot.node_domain_id, dev, shards=self.shards) \
            if dev.type == "cuda" else None
        # The wave carry (a copy: the portfolio's launches update it in place).
        self.free = cache.device_array(snapshot.free, torch.float32, dev).clone()
        self.ok_g = torch.zeros((len(gangs),), dtype=torch.bool, device=dev)
        self.epoch = snapshot.encode_epoch()
        self._warmed: set = set()
        self._scan_warmed: set = set()
        self.inflight: list[dict] = []
        self.bindings: dict[str, dict[str, str]] = {}
        self._last_event = None  # the newest event behind a host copy
        self.t0 = time.perf_counter()  # the clock origin; both drains call start_clock()
        self._t0_event = None  # on the card: a timing event recorded at t0
        if self.recorder is not None:
            # Wave ids in commit order, the gangs admitted by earlier waves,
            # and the running allocation table: wave k journals the state
            # entering it, then commits its own bindings into it.
            self.commit_seq = 0
            self.scheduled_admitted: set[str] = set()
            self._alloc = np.array(snapshot.allocated, copy=True)
            self._cap_np = np.asarray(snapshot.capacity)

    @property
    def shards(self) -> int | None:
        """The layout's node-axis shards, None unsharded."""
        return None if self.layout is None else self.layout.node_devices

    def start_clock(self) -> float:
        """Set the clock origin t0 (host perf_counter) and, on the card, a
        timing event recorded at it on the idle stream: a wave's stamp is
        then its completion event's time since that event on the card's
        clock, not the moment the host fetched it."""
        if self.dev.type == "cuda":
            torch.cuda.current_stream(self.dev).synchronize()
            self._t0_event = torch.cuda.Event(enable_timing=True)
            self._t0_event.record()
        self.t0 = time.perf_counter()
        return self.t0

    # ---- encode + candidate plan ---------------------------------------------

    def encode_wave(self, ws, reuse_rows: bool = True):
        """Encode one planned wave; `reuse_rows` reads and fills the warm
        path's row cache under (spec digest, snapshot epoch) keys."""
        wave, (mg_c, ms_c, mp_c), pad = ws
        row_keys = None
        if reuse_rows:
            row_keys = [(gang_row_digest(g, self.pods_by_name), self.epoch) for g in wave]
        return encode_gangs(
            wave, self.pods_by_name, self.snapshot, max_groups=mg_c, max_sets=ms_c,
            max_pods=mp_c, pad_gangs_to=pad, global_index_of=self.gidx,
            row_cache=self.wp.encode_rows if reuse_rows else None, row_keys=row_keys,
        )

    def cut_plan(self, batch, count: bool = True):
        """The wave's candidate plan (None: solve dense), cut against the
        initial snapshot: free only shrinks while draining, so these
        candidates cover every later state. `count=False` (the warm
        pre-pass) keeps the cut out of prune_s."""
        if self.pruning is None or not self.use_exec_cache:
            return None
        tp = time.perf_counter()
        plan = plan_candidates(self.snapshot, batch, self.pruning,
                               mesh_axis=self.shards or 1)
        if count:
            self.stats.prune_s += time.perf_counter() - tp
        return plan

    def pruned_inputs(self, plan, batch) -> tuple:
        """(batch on the candidate axis, capacity, schedulable,
        node_domain_id, gather map, DomainIndex or None): the static tensors
        ride the device cache, so a plan seen before uploads nothing."""
        cache, dev = self.wp.device, self.dev
        return (
            plan.gather_batch(batch),
            cache.device_array(plan.capacity, torch.float32, dev),
            cache.device_array(plan.schedulable, torch.bool, dev),
            cache.device_array(plan.node_domain_id, torch.int32, dev),
            plan.padded_idx(),
            cache.domain_index(plan.node_domain_id, dev, shards=self.shards)
            if dev.type == "cuda" else None,
        )

    def _encode_rec(self, ws) -> dict:
        """Encode one planned wave (and cut its plan) into an in-flight
        record, not yet dispatched."""
        stats = self.stats
        te = time.perf_counter()
        batch, decode = self.encode_wave(ws)
        stats.encode_s += time.perf_counter() - te
        plan = self.cut_plan(batch)
        if plan is not None:
            stats.pruned_waves += 1
            stats.candidate_nodes = max(stats.candidate_nodes, plan.count)
            stats.candidate_pad = max(stats.candidate_pad, plan.pad)
        # `seq` is restamped at dispatch (a resubmitted wave keeps its place);
        # `pruning` is the config the plan was cut under, which the journal
        # records even if the ladder has stepped pruning down by the commit.
        return {"members": ws[0], "shape": ws[1], "pad": ws[2], "batch": batch,
                "decode": decode, "plan": plan, "escalated": False, "seq": stats.waves,
                "pruning": self.pruning if plan is not None else None}

    # ---- the warm pre-pass ---------------------------------------------------

    def warm_shape(self, ws) -> bool:
        """Prepare (never run) the launch this wave's shape needs; False
        when this engine already did, or the drain bypasses the cache. The
        encode bypasses the row cache, so the timed encodes stay a true
        measurement (they fill the cache for the next drain)."""
        if ws[1:] in self._warmed or not self.use_exec_cache:
            return False
        self._warmed.add(ws[1:])
        warm_batch, _ = self.encode_wave(ws, reuse_rows=False)
        zeros_okg = torch.zeros_like(self.ok_g)
        plan = self.cut_plan(warm_batch, count=False)
        cache = self.wp.executables
        if plan is not None:
            pb, cap_p, sched_p, ndid_p, cand, _ = self.pruned_inputs(plan, warm_batch)
            cache.ensure_compiled(self.free, cap_p, sched_p, ndid_p, pb, self.params, zeros_okg,
                                  donate=self.donate, device=self.dev, cand_idx=cand,
                                  layout=self.layout)
        else:
            cache.ensure_compiled(self.free, self.capacity, self.schedulable,
                                  self.node_domain_id, warm_batch, self.params, zeros_okg,
                                  donate=self.donate, device=self.dev, layout=self.layout)
        return True

    def warm_scan(self, class_waves: list) -> bool:
        """Prepare (never run) the scan launches a run of same-shape waves
        will need, one per padded chunk length; True when any was new to
        this engine. Sub-runs that a presence or pad split leaves can still
        be prepared at dispatch (the common uniform run is assumed)."""
        scan = self.scan
        if scan is None or not scan.enabled or not self.use_exec_cache:
            return False
        lens = {padded for _, _, padded in scan_chunks(len(class_waves), scan) if padded}
        lens = {n for n in lens if (class_waves[0][1:], n) not in self._scan_warmed}
        if not lens:
            return False
        for n in lens:
            self._scan_warmed.add((class_waves[0][1:], n))
        warm_batch, _ = self.encode_wave(class_waves[0], reuse_rows=False)
        zeros_okg = torch.zeros_like(self.ok_g)
        plan = self.cut_plan(warm_batch, count=False)
        cache = self.wp.executables
        for n in lens:
            if plan is not None:
                cache.ensure_compiled_scan(
                    self.free, plan.capacity, plan.schedulable, plan.node_domain_id,
                    plan.gather_batch(warm_batch), self.params, zeros_okg, n,
                    retain=self.retain_carries, donate=self.donate, device=self.dev,
                    cand_idx=plan.padded_idx(),
                )
            else:
                cache.ensure_compiled_scan(
                    self.free, self.capacity, self.schedulable, self.node_domain_id, warm_batch,
                    self.params, zeros_okg, n, retain=self.retain_carries, donate=self.donate,
                    device=self.dev,
                )
        return True

    # ---- dispatch ------------------------------------------------------------

    def _solve(self, rec, free, ok_g, plan):
        if self.pstack is not None:
            from grove_tpu_torch.parallel.portfolio import portfolio_solve

            if self.retain_carries:
                # The stacked launch updates its carry in place: a retained
                # entering carry must outlive it (re-dispatch, escalation).
                free, ok_g = free.clone(), ok_g.clone()
            return portfolio_solve(
                free, self.capacity, self.schedulable, self.node_domain_id, rec["batch"],
                self.params, self.portfolio, ok_g, pstack=self.pstack, device=self.dev,
                domains=self.domains,
            )
        cache = self.wp.executables
        if plan is not None:
            if "pruned_inputs" not in rec:
                rec["pruned_inputs"] = self.pruned_inputs(plan, rec["batch"])
            pb, cap_p, sched_p, ndid_p, cand, dom_p = rec["pruned_inputs"]
            return cache.solve(free, cap_p, sched_p, ndid_p, pb, self.params, ok_g,
                               donate=False, device=self.dev, domains=dom_p, cand_idx=cand,
                               cand_count=plan.count, layout=self.layout)
        return cache.solve(free, self.capacity, self.schedulable, self.node_domain_id,
                           rec["batch"], self.params, ok_g, donate=self.donate,
                           device=self.dev, domains=self.domains, layout=self.layout)

    def _stage(self, holder: dict, planes, free_in=None) -> None:
        """Copy verdict planes toward the host right behind their launch: on
        the card into pinned buffers without blocking, with an event
        recorded behind the copies (a fetch waits on that event alone). A
        journaled drain stages the entering carry `free_in` with them."""
        if self.recorder is not None and free_in is not None:
            planes = tuple(planes) + (free_in,)
        holder["ok_np"] = None
        if self.dev.type != "cuda":
            holder["host"], holder["event"] = planes, None
            return
        host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in planes]
        for h, p in zip(host, planes):
            h.copy_(p, non_blocking=True)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        holder["host"], holder["event"] = host, event
        self._last_event = event

    def _dispatch(self, rec: dict, *, free_in=None, okg_in=None, advance: bool = True) -> None:
        """Dispatch (or re-dispatch) one wave; updates the record in place.
        By default it solves from the current carry and advances it. The
        watchdog's re-dispatch passes the wave's retained entering carry and
        `advance=False`: later waves already chained off the original
        output, the solve is deterministic, and the result lands in fresh
        buffers (the launch cache copies its outputs out), so the live
        carry is never touched. A per-wave dispatch supersedes any scan
        chunk the record was part of."""
        if self.faults is not None:
            self.faults.maybe_raise("solver.dispatch", wave=rec.get("seq", -1))
        rec.pop("scan_group", None)
        rec.pop("scan_pos", None)
        if free_in is None:
            free_in, okg_in = self.free, self.ok_g
        self.stats.dispatches += 1
        if self.retain_carries:
            # The launch cache never writes its inputs: the carry itself is kept.
            rec["free_in"], rec["okg_in"] = free_in, okg_in
        res = self._solve(rec, free_in, okg_in, rec["plan"])
        self._stage(rec, (res.ok, res.placement_score, res.assigned), rec.get("free_in"))
        rec["dispatched_at"] = self.clock()
        rec["cancelled"] = False
        if advance:
            self.free, self.ok_g = res.free_after, res.ok_global

    def _dispatch_with_retry(self, attempt, what: str, *, in_flight: bool):
        """Run `attempt()`, a dispatch, with up to `max_wave_retries`
        immediate retries from the same carry (the solve is deterministic).
        Past the budget: the raw error with resilience off, else WaveFault."""
        attempts = 0
        while True:
            try:
                return attempt()
            except Exception as e:  # noqa: BLE001 — retry budget, then surface
                if attempts >= self.max_wave_retries:
                    if self.max_wave_retries == 0 and self.faults is None:
                        raise  # resilience off: the raw error, unchanged
                    raise WaveFault(f"{what} failed after {attempts} retries: {e}",
                                    in_flight=in_flight) from e
                attempts += 1
                self.stats.wave_retries += 1

    # ---- watchdog: timeout -> cancel -> re-dispatch --------------------------

    def cancel_wave(self, rec: dict) -> bool:
        """Cancel an in-flight wave: drop its host view so the next fetch
        reads the re-dispatch. A second cancel is a no-op (False)."""
        if rec.get("cancelled"):
            return False
        rec["cancelled"] = True
        rec["ok_np"] = None
        self.stats.waves_cancelled += 1
        return True

    def _redispatch(self, rec: dict) -> None:
        """Re-dispatch a cancelled wave from its retained entering carry, on
        the same stream (it queues behind the cancelled launch, whose pinned
        copies are dropped), without advancing the carry."""
        if rec.get("free_in") is None:
            raise WaveFault("cannot re-dispatch: entering carry not retained", in_flight=True)
        self.stats.wave_redispatches += 1
        self._dispatch_with_retry(
            lambda: self._dispatch(rec, free_in=rec["free_in"], okg_in=rec["okg_in"],
                                   advance=False),
            "wave dispatch", in_flight=True)

    def _wave_hung(self, rec: dict) -> bool:
        """Is this wave hung past the watchdog deadline? An injected
        `solver.harvest` timeout is checked first. On the card the probe is
        the CUDA event behind the wave's (or its chunk's) host copies:
        `query()` never blocks; a wave that completes while polled harvests
        normally. On the CPU there is no event, so no probe: the fetch
        proceeds."""
        if self.faults is not None and self.faults.maybe_timeout(
                "solver.harvest", wave=rec.get("seq", -1)):
            return True
        if self.watchdog_s is None:
            return False
        holder = rec.get("scan_group") or rec
        event = holder.get("event")
        if event is None:
            return False
        return not self._ready_by(event, rec.get("dispatched_at", 0.0) + self.watchdog_s)

    def _ready_by(self, event, deadline: float) -> bool:
        """Poll `event.query()` until the event completes (True) or the
        engine clock reaches `deadline` (False)."""
        while not event.query():
            if self.clock() >= deadline:
                return False
            time.sleep(self.watchdog_poll_s)
        return True

    def _dispatch_one(self, rec: dict) -> None:
        """Dispatch one encoded record and enqueue it for retirement;
        `stats.waves` advances only on success, so a caller resubmitting
        after WaveFault(in_flight=False) never counts a wave twice."""
        rec["seq"] = self.stats.waves
        ts = time.perf_counter()
        self._dispatch_with_retry(lambda: self._dispatch(rec), "wave dispatch", in_flight=False)
        self.stats.dispatch_s += time.perf_counter() - ts
        self.stats.waves += 1
        self.inflight.append(rec)

    def retire_due(self) -> bool:
        """Waves past the pipeline depth, waiting to retire (a caller that
        owns its retirement loop, the streaming drain, polls this)."""
        return self.retire_lag is not None and len(self.inflight) > self.retire_lag

    def _retire_down(self) -> None:
        while self.retire_due():
            self._retire_next()

    def submit(self, ws, retire: bool = True) -> None:
        """Encode + dispatch one planned wave, then (by default) retire down
        to the pipeline depth. With `retire=False` a failure unambiguously
        means the wave was not enqueued (the streaming drain resubmits it)."""
        self._dispatch_one(self._encode_rec(ws))
        if retire:
            self._retire_down()

    # ---- the scan (B4) -------------------------------------------------------

    def _scan_subkey(self, rec: dict) -> tuple:
        """Records that stack into one scan chunk: the same optional batch
        planes and, pruned, the same candidate pad and fleet."""
        b = rec["batch"]
        presence = (b.reuse_nodes is None, b.group_node_ok is None, b.spread_level is None)
        plan = rec["plan"]
        if plan is None:
            return ("dense", presence)
        return ("pruned", presence, plan.pad, plan.fleet_pad)

    def submit_scan(self, class_waves: list, retire: bool = True) -> None:
        """Encode a run of same-(shape, pad) planned waves and dispatch it as
        scan chunks of up to `max_scan_len` waves, one launch each. Runs
        (and sub-runs split by _scan_subkey) shorter than
        `min_waves_per_class` dispatch wave by wave. Records retire as
        usual (after each chunk unless `retire` is False), each chunk
        fetched once."""
        scan = self.scan
        if scan is None or not scan.enabled:
            for ws in class_waves:
                self._dispatch_one(self._encode_rec(ws))
                if retire:
                    self._retire_down()
            return
        recs = [self._encode_rec(ws) for ws in class_waves]
        i = 0
        while i < len(recs):
            j = i
            key = self._scan_subkey(recs[i])
            while j < len(recs) and self._scan_subkey(recs[j]) == key:
                j += 1
            run = recs[i:j]
            for k, m, padded in scan_chunks(len(run), scan):
                chunk = run[k : k + m]
                try:
                    if padded is None:
                        for off, rec in enumerate(chunk):
                            try:
                                self._dispatch_one(rec)
                            except WaveFault as e:
                                if not e.in_flight and e.pending is None:
                                    e.pending = class_waves[i + k + off:]
                                raise
                    else:
                        self._dispatch_scan_chunk(chunk)
                except WaveFault as e:
                    # Nothing of the failed chunk (or wave) was enqueued:
                    # hand the tail back for the caller to resubmit.
                    if not e.in_flight and e.pending is None:
                        e.pending = class_waves[i + k:]
                    raise
                if retire:
                    self._retire_down()
            i = j

    def _solve_scan_chunk(self, run: list[dict], free_in, okg_in):
        """Stack one run's batches (and plans) on a leading wave axis and
        solve the run as one scan from the given carry. The wave axis is
        padded to its next power of two with null waves (no gang valid: the
        carry passes through, nothing scatters into ok_global), so chunk
        lengths share launches the way gang pads do (drain.py
        `_solve_scan_chunk`)."""
        w_pad = next_pow2(len(run))
        cache = self.wp.executables
        if run[0]["plan"] is not None:
            cand, cap, sched, ndid, pbatch = stack_plan_arrays(
                [r["plan"] for r in run], [r["batch"] for r in run], pad_to=w_pad)
            return cache.solve_scan_pruned(
                free_in, cand, cap, sched, ndid, pbatch, self.params, okg_in,
                retain=self.retain_carries, donate=self.donate, device=self.dev,
                domains=self.wp.device.domain_index(ndid, self.dev)
                if self.dev.type == "cuda" else None,
            )
        return cache.solve_scan(
            free_in, self.capacity, self.schedulable, self.node_domain_id,
            stack_batches([r["batch"] for r in run], pad_to=w_pad), self.params, okg_in,
            retain=self.retain_carries, donate=self.donate, device=self.dev,
            domains=self.domains,
        )

    def _commit_scan_chunk(self, run: list[dict], res) -> None:
        """Bind one solved chunk's planes onto its records (one host copy
        for the chunk, every record a step of it) and advance the carry."""
        group: dict = {}
        self._stage(group, (res.ok, res.placement_score, res.assigned), res.free_in)
        now = self.clock()
        for i, rec in enumerate(run):
            rec.update(
                ok_np=None,
                # The chunk's retained step carries: escalation and
                # re-dispatch inputs of each of its waves.
                free_in=res.free_in[i] if self.retain_carries else None,
                okg_in=res.okg_in[i] if self.retain_carries else None,
                dispatched_at=now,
                cancelled=False,
                scan_group=group,
                scan_pos=i,
            )
        self.free, self.ok_g = res.free_after, res.ok_global

    def _dispatch_scan_chunk(self, run: list[dict]) -> None:
        """Dispatch one chunk as a scan (with the per-wave retry budget),
        then enqueue its records."""
        ts = time.perf_counter()
        for i, rec in enumerate(run):
            rec["seq"] = self.stats.waves + i

        def attempt():
            if self.faults is not None:
                self.faults.maybe_raise("solver.dispatch", wave=run[0]["seq"])
            return self._solve_scan_chunk(run, self.free, self.ok_g)

        res = self._dispatch_with_retry(attempt, "scan chunk dispatch", in_flight=False)
        self._commit_scan_chunk(run, res)
        self.inflight.extend(run)
        stats = self.stats
        stats.waves += len(run)
        stats.dispatches += 1
        stats.scan_chunks += 1
        stats.scanned_waves += len(run)
        stats.dispatch_s += time.perf_counter() - ts

    # ---- retirement ----------------------------------------------------------

    def _host_planes(self, holder: dict) -> None:
        """The staged planes as numpy arrays (their copies are complete) and,
        on the card, `done_s`: when the launch and copies completed, in
        seconds since t0 on the card's clock."""
        planes = [p.numpy() for p in holder.pop("host")]
        holder["ok_np"], holder["score_np"], holder["assigned_np"] = planes[:3]
        if len(planes) > 3:
            holder["free_in_np"] = planes[3]
        event = holder.pop("event", None)
        if event is not None and self._t0_event is not None:
            holder["done_s"] = self._t0_event.elapsed_time(event) / 1e3

    def _fetch(self, rec: dict) -> None:
        """Make this wave's verdicts host-visible: wait on its own event
        (later waves keep computing). A scan chunk's records share one
        fetch."""
        if rec.get("ok_np") is not None:
            return
        th = time.perf_counter()
        try:
            # The watchdog: a hung wave is cancelled and re-dispatched from
            # its retained entering carry, up to max_wave_retries times;
            # exhaustion raises WaveFault(in_flight=True) with the wave
            # still at the queue head.
            attempts = 0
            while self._wave_hung(rec):
                self.stats.watchdog_timeouts += 1
                self.cancel_wave(rec)
                if attempts >= self.max_wave_retries:
                    raise WaveFault(f"wave hung past watchdog after {attempts} re-dispatches",
                                    in_flight=True)
                attempts += 1
                self._redispatch(rec)
            group = rec.get("scan_group")
            if group is not None:
                self._fetch_scan_group(group)
                i = rec["scan_pos"]
                rec["ok_np"] = group["ok_np"][i]
                rec["score_np"] = group["score_np"][i]
                rec["assigned_np"] = group["assigned_np"][i]
                rec["done_s"] = group.get("done_s")
                if "free_in_np" in group:
                    rec["free_in_np"] = group["free_in_np"][i]
            else:
                if rec["event"] is not None:
                    rec["event"].synchronize()
                self._host_planes(rec)
                self.stats.device_roundtrips += 1
        finally:
            self.stats.harvest_s += time.perf_counter() - th

    def _fetch_scan_group(self, group: dict) -> None:
        """One wait for a scan chunk's planes (the first retiring record of
        the chunk pays it)."""
        if group.get("ok_np") is not None:
            return
        if group["event"] is not None:
            group["event"].synchronize()
        self._host_planes(group)
        self.stats.device_roundtrips += 1

    def _rechain_inflight(self) -> None:
        """Re-dispatch every wave still in flight from the current carry (the
        adoption point). With the scan on, consecutive records of one shape,
        pad and subkey re-chain as fused chunks (counted on scan_rechains,
        not scan_chunks); runs too short to fuse re-dispatch wave by wave."""
        scan = self.scan
        if scan is None or not scan.enabled or len(self.inflight) < 2:
            for rec2 in self.inflight:
                rec2["escalated"] = False
                self._dispatch(rec2)
            return

        def key(rec):
            return rec["shape"], rec["pad"], self._scan_subkey(rec)

        n = len(self.inflight)
        i = 0
        while i < n:
            j = i
            while j < n and key(self.inflight[j]) == key(self.inflight[i]):
                j += 1
            run = self.inflight[i:j]
            for k, m, padded in scan_chunks(len(run), scan):
                chunk = run[k : k + m]
                for rec2 in chunk:
                    rec2["escalated"] = False
                if padded is None:
                    for rec2 in chunk:
                        self._dispatch(rec2)
                    continue
                if self.faults is not None:
                    self.faults.maybe_raise("solver.dispatch", wave=chunk[0]["seq"])
                res = self._solve_scan_chunk(chunk, self.free, self.ok_g)
                self._commit_scan_chunk(chunk, res)
                self.stats.dispatches += 1
                self.stats.scan_rechains += 1
            i = j

    def _retire_next(self) -> None:
        rec = self.inflight[0]
        self._fetch(rec)
        self.inflight.pop(0)
        self._finalize(rec)

    def _escalate(self, rec: dict) -> None:
        """A lossy-rejected pruned wave re-solves dense from its entering
        carry: the same verdicts CONFIRM the pruned result; changed ones
        ADOPT the dense result and re-chain every wave still in flight."""
        stats = self.stats
        rec["escalated"] = True
        stats.escalations += 1
        stats.dispatches += 1
        th = time.perf_counter()
        dense = self._solve(rec, rec["free_in"], rec["okg_in"], None)
        held: dict = {}
        self._stage(held, (dense.ok, dense.placement_score, dense.assigned))
        if held["event"] is not None:
            held["event"].synchronize()
        self._host_planes(held)
        rec["done_s"] = held.get("done_s")  # stamped when its re-solve completed
        stats.device_roundtrips += 1
        stats.harvest_s += time.perf_counter() - th
        if np.array_equal(held["ok_np"], rec["ok_np"]):
            return
        stats.escalations_adopted += 1
        rec.update(held, plan=None)  # dense verdicts: fleet ordinals already

        def rechain():
            # Restarts from the adoption point on every attempt, so a
            # dispatch fault mid-re-chain retries it whole.
            self.free, self.ok_g = dense.free_after, dense.ok_global
            self._rechain_inflight()

        try:
            self._dispatch_with_retry(rechain, "escalation re-chain", in_flight=True)
        except WaveFault as e:
            e.fatal = True  # a half re-chained carry no ladder rung can fix
            raise

    def _finalize(self, rec: dict) -> None:
        """Escalate if needed, then commit: stamp, decode, bind."""
        stats = self.stats
        if rec["plan"] is not None and not rec["escalated"]:
            lossy = lossy_rejections(rec["plan"], rec["batch"].gang_valid, rec["ok_np"])
            if bool(lossy.any()):
                self._escalate(rec)
        stamp = rec.get("done_s")
        if stamp is None:
            stamp = time.perf_counter() - self.t0
        if self.record_stamps:
            stats.wave_latencies.append((int(rec["ok_np"].sum()), stamp))
        td = time.perf_counter()
        wave_bindings = decode_bindings(rec["ok_np"], rec["assigned_np"], rec["decode"],
                                        self.snapshot)
        stats.decode_s += time.perf_counter() - td
        tb = time.perf_counter()
        stats.scores.extend(rec["score_np"][rec["ok_np"]].tolist())
        for gang_name, pod_bindings in wave_bindings.items():
            self.bindings[gang_name] = pod_bindings
            stats.admitted += 1
            stats.pods_bound += len(pod_bindings)
        stats.bind_s += time.perf_counter() - tb
        if self.recorder is not None:
            tj = time.perf_counter()
            self._journal(rec, wave_bindings)
            self.scheduled_admitted.update(wave_bindings)
            self.commit_seq += 1
            stats.journal_s += time.perf_counter() - tj
        if self.on_commit is not None:
            tb = time.perf_counter()
            self.on_commit(rec["members"], wave_bindings, stamp)
            stats.bind_s += time.perf_counter() - tb

    def _journal(self, rec: dict, wave_bindings: dict) -> None:
        """Journal the committed wave (drain.py `_journal`): a monotonic id
        and the closure replay needs to re-solve it alone — the exact
        entering free rows (the rows that differ from capacity), the
        allocation entering it, the earlier waves' admissions as
        `scheduled` (cross-wave base gates resolve without ok_global), and
        a pruned wave's candidate list (plans are cut against the initial
        free, so replay must not re-cut them against the entering free).
        A failure to journal never breaks the drain."""
        from grove_tpu_torch.state.cluster import pod_request_vector

        snap = self.snapshot
        members = rec["members"]
        try:
            free_in = np.asarray(rec["free_in_np"], dtype=np.float32)
            n_real = len(snap.node_names)
            diff_rows = np.flatnonzero((free_in[:n_real] != self._cap_np[:n_real]).any(axis=1))
            free_rows = {snap.node_names[i]: free_in[i].tolist() for i in diff_rows.tolist()}
            mg_c, ms_c, mp_c = rec["shape"]
            plan = rec["plan"]
            journaled = self.recorder.capture_wave(
                now=time.time(),
                wave=f"{self.wave_prefix}-{self.commit_seq:06d}",
                snapshot=snap,
                gangs=members,
                pods_by_name=self.pods_by_name,
                scheduled_names=set(self.scheduled_admitted),
                bound_nodes={},
                reuse_nodes={},
                spread_avoid={},
                max_groups=mg_c,
                max_sets=ms_c,
                max_pods=mp_c,
                pad_gangs_to=rec["pad"],
                params=self.params,
                portfolio=1,
                escalate_portfolio=1,
                pruning=rec["pruning"] if plan is not None else None,
                plan=wave_bindings,
                ok_by_name={g.name: bool(rec["ok_np"][i]) for i, g in enumerate(members)},
                valid_by_name={g.name: bool(rec["batch"].gang_valid[i])
                               for i, g in enumerate(members)},
                scores={g.name: float(rec["score_np"][i]) for i, g in enumerate(members)},
                solve_seconds=0.0,  # asynchronous dispatch: no per-wave solve wall
                allocated_override=self._alloc,
                free_rows=free_rows,
                candidates=plan.idx.tolist() if plan is not None else None,
                mesh=self.layout.fingerprint() if self.layout else None,
            )
            if journaled:
                self.stats.journaled_waves += 1
        except Exception:  # noqa: BLE001 — journaling never breaks the drain
            pass
        # Commit this wave's bindings into the running allocation table, so
        # the next journaled wave records the state entering it.
        for pod_bindings in wave_bindings.values():
            for pod_name, node_name in pod_bindings.items():
                self._alloc[snap.node_index(node_name)] += pod_request_vector(
                    self.pods_by_name[pod_name], snap.resource_names)

    def harvest_inflight(self) -> None:
        """Make every in-flight wave's verdicts host-visible with one wait on
        the newest event (every earlier copy is ahead of it on the stream):
        the single round trip of the chained and resident disciplines. A
        no-op when nothing is unfetched. With the watchdog armed, the wait
        polls that event against the oldest unfetched wave's deadline; past
        it nothing is fetched here, and each wave retires through `_fetch`,
        whose watchdog probes the wave's own event."""
        unfetched = [r for r in self.inflight if (r.get("scan_group") or r).get("ok_np") is None]
        if not unfetched:
            return
        holders = list({id(h): h for h in (r.get("scan_group") or r for r in unfetched)}.values())
        th = time.perf_counter()
        try:
            if self._last_event is not None:
                if self.watchdog_s is None:
                    self._last_event.synchronize()
                elif not self._ready_by(self._last_event, self.watchdog_s + min(
                        r.get("dispatched_at", 0.0) for r in unfetched)):
                    return
            for holder in holders:
                self._host_planes(holder)
            self.stats.device_roundtrips += 1
        finally:
            self.stats.harvest_s += time.perf_counter() - th

    def flush(self) -> None:
        """Retire everything still in flight; the chained and resident
        disciplines harvest it first with one wait."""
        if self.retire_lag is None:
            self.harvest_inflight()
        while self.inflight:
            self._retire_next()

    # ---- degradation-ladder hooks (solver/resilience.py) ---------------------
    #
    # Each rung maps to one engine mutation, applied between waves by the
    # streaming drain; every one preserves the admitted set (scanned == per-wave
    # bitwise, pruned == dense admitted-equal through escalation, and the
    # retire lag only moves where the host blocks).

    def set_scan(self, scan) -> None:
        """scan <-> per-wave dispatch for runs submitted from now on."""
        if scan is not None and scan.enabled and self.layout is not None:
            raise NotImplementedError(f"a scanned drain under a layout waits for {WAITS_SCAN}")
        self.scan = scan if self.use_exec_cache else None

    def set_retire_lag(self, lag: int | None) -> None:
        """pipeline <-> serial: where the host blocks, never what it binds."""
        self.retire_lag = lag

    def set_pruning(self, pruning) -> None:
        """pruned <-> dense for waves submitted from now on (plans are cut
        against the initial snapshot, a superset of every later state)."""
        self.pruning = pruning if self.use_exec_cache else None

    def strip_layout(self) -> None:
        """mesh-sharded -> unsharded (drain.py `strip_layout`): retire
        everything in flight, then solve unsharded from the same carry (the
        sharded and unsharded solves give the same verdicts, so only the
        launches change). Counted on shard_fallbacks: a degradation is a
        fallback that must not be silent."""
        if self.layout is None:
            return
        self.flush()
        self.layout = None
        self.domains = self.wp.device.domain_index(self.snapshot.node_domain_id, self.dev) \
            if self.dev.type == "cuda" else None
        self.stats.shard_devices = 0
        self.stats.shard_fallbacks += 1

    def adopt_layout(self, layout) -> None:
        """unsharded -> mesh-sharded (the ladder stepping back up): retire
        in-flight waves, then solve every later wave under `layout` — the
        inverse of strip_layout."""
        if self.layout is not None or layout is None or not self.use_exec_cache:
            return
        if self.scan is not None and self.scan.enabled:
            raise NotImplementedError(f"a scanned drain under a layout waits for {WAITS_SCAN}")
        self.flush()
        self.layout = layout
        self.domains = self.wp.device.domain_index(self.snapshot.node_domain_id, self.dev,
                                                   shards=layout.node_devices) \
            if self.dev.type == "cuda" else None
        self.stats.shard_devices = layout.node_devices


def scan_chunks(n: int, scan: ScanConfig) -> list[tuple[int, int, int | None]]:
    """The chunks a run of `n` same-shape waves splits into under `scan`:
    (start, length, padded length), the padded length the next power of two
    of a chunk fused into one scan launch, or None for a chunk shorter than
    min_waves_per_class, which dispatches wave by wave."""
    min_run = max(1, int(scan.min_waves_per_class))
    max_len = max(1, int(scan.max_scan_len))
    out = []
    for k in range(0, n, max_len):
        length = min(max_len, n - k)
        out.append((k, length, next_pow2(length) if length >= min_run else None))
    return out


def class_runs(planned):
    """Consecutive same-(shape, pad) runs of planned waves: plan_waves emits
    each class's waves together within a rank, so these are the scan's
    groups."""
    i = 0
    while i < len(planned):
        j = i
        while j < len(planned) and planned[j][1:] == planned[i][1:]:
            j += 1
        yield planned[i:j]
        i = j


def drain_backlog(
    gangs: list,
    pods_by_name: dict,
    snapshot,
    *,
    wave_size: int = 256,
    params: SolverParams | None = None,
    harvest: str = "chained",
    depth: int = 2,
    scan: ScanConfig | None = None,
    pruning: PruningConfig | None = None,
    portfolio: int = 1,
    recorder=None,
    device=None,
    warm_path=None,
    donate: bool | None = None,
    mesh=None,
    faults=None,
    resilience=None,
) -> tuple[dict[str, dict[str, str]], DrainStats]:
    """Admit a whole backlog; returns ({gang: {pod: node}}, DrainStats).

    All-or-nothing per gang; scaled gangs wait for their base's verdict on
    the device. `harvest` picks the discipline (HARVEST_MODES, see the module
    docstring), `depth` the waves in flight under "pipeline" and "scan", and
    `scan` the ScanConfig of "scan" and "resident" (None = defaults; with a
    disabled config, or `portfolio` > 1, both run as "pipeline"). `pruning`
    (enabled) solves each wave on its candidate axis, with the escalation
    described in the module docstring; `portfolio` > 1 solves every wave
    under that many weight variants (pruning is then off). `recorder` (a
    trace.recorder.TraceRecorder; single-variant drains only) journals every
    committed wave, as the module docstring says.

    `warm_path` (solver.warm.WarmPath; None = the process-shared one) holds
    the launch cache, the encode rows and the device cache the drain goes
    through; an untimed pre-pass prepares every planned shape first
    (DrainStats.compile_s); `donate` None means on for the card.
    `device` None means the card; "cpu" runs the plain PyTorch versions.

    `resilience` (a solver.resilience ResilienceConfig or a shared
    DegradationLadder) arms the engine's watchdog and dispatch retries, and
    the ladder's open rungs step the drain down once, at construction
    (resident -> scan -> pipeline -> wave, pruning off, portfolio 1);
    stepping down mid-run is the streaming drain's. `faults` (a
    faults.FaultInjector; None = the process-installed one) threads the
    engine's fault sites. `mesh` (None | parallel.mesh.SolveLayout |
    MeshConfig) shards every wave of a single-variant drain over the
    layout (the module docstring); a requested mesh that resolves to none
    solves unsharded and counts one fallback. Portfolio drains ignore it
    (the JAX package's rule), and "scan" or "resident" under a layout
    raise."""
    if harvest not in HARVEST_MODES:
        raise ValueError(f"harvest must be one of {'|'.join(HARVEST_MODES)}, got {harvest!r}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = resolve_device(device)
    params = params or SolverParams()
    wp = warm_path if warm_path is not None else default_warm_path()
    if pruning is not None and not pruning.enabled:
        pruning = None
    ladder = ladder_for(resilience)
    watchdog_s, max_wave_retries = None, 0
    if ladder is not None:
        watchdog_s = ladder.config.watchdog_seconds
        max_wave_retries = ladder.config.max_wave_retries
        # The open rungs, applied once (the JAX drain's order of consults).
        if not ladder.allows("mesh"):
            mesh = None
        if not ladder.allows("pruning"):
            pruning = None
        if harvest == "resident" and not ladder.allows("resident"):
            harvest = "scan"
        if harvest == "scan" and not ladder.allows("scan"):
            harvest = "pipeline"
        if harvest == "pipeline" and not ladder.allows("pipeline"):
            harvest = "wave"
        if portfolio > 1 and not ladder.allows("portfolio"):
            portfolio = 1
    scan_cfg = None
    if harvest in ("scan", "resident"):
        scan_cfg = scan if scan is not None else ScanConfig()
        if not scan_cfg.enabled or portfolio > 1:
            # The same pipelined semantics, no fusion on the card.
            harvest, scan_cfg = "pipeline", None
    if portfolio > 1:
        pruning = None  # the JAX package never prunes a portfolio solve
    if donate is None:
        donate = donation_default(dev)
    layout = None
    shard_fallback = 0
    if mesh is not None and portfolio == 1:
        layout = resolve_layout(mesh, int(snapshot.free.shape[0]))
        shard_fallback = int(layout is None and mesh_requested(mesh))
    stats = DrainStats(gangs=len(gangs), harvest=harvest,
                       depth=depth if harvest in ("pipeline", "scan") else 0,
                       portfolio=portfolio, shard_fallbacks=shard_fallback)
    if not gangs:
        return {}, stats
    # The warm path's counters are shared: report this drain's deltas.
    exec0 = (wp.executables.hits, wp.executables.misses, wp.executables.lowerings)
    rows0 = (wp.encode_rows.hits, wp.encode_rows.misses)
    waves = plan_waves(gangs, wave_size)
    retire_lag = {"chained": None, "wave": 0, "pipeline": depth, "scan": depth,
                  "resident": None}[harvest]
    engine = _WavePipeline(
        gangs=gangs, pods_by_name=pods_by_name, snapshot=snapshot, params=params, stats=stats,
        dev=dev, warm_path=wp, pruning=pruning, portfolio=portfolio, donate=bool(donate),
        retire_lag=retire_lag, record_stamps=harvest in ("wave", "pipeline", "scan"),
        scan=scan_cfg, recorder=recorder, faults=faults, watchdog_s=watchdog_s,
        max_wave_retries=max_wave_retries, layout=layout,
    )
    fused = harvest in ("scan", "resident")
    t0 = time.perf_counter()
    for ws in waves:
        engine.warm_shape(ws)
    if fused:
        for run in class_runs(waves):
            engine.warm_scan(run)
    stats.compile_s = time.perf_counter() - t0
    t0 = engine.start_clock()
    if fused:
        for run in class_runs(waves):
            engine.submit_scan(run)
    else:
        for ws in waves:
            engine.submit(ws)
    engine.flush()
    stats.free_after = engine.free.cpu().numpy()
    stats.total_s = time.perf_counter() - t0
    stats.exec_cache_hits = wp.executables.hits - exec0[0]
    stats.exec_cache_misses = wp.executables.misses - exec0[1]
    stats.lowerings = wp.executables.lowerings - exec0[2]
    stats.encode_reuse_hits = wp.encode_rows.hits - rows0[0]
    stats.encode_reuse_misses = wp.encode_rows.misses - rows0[1]
    if stats.pruned_waves:
        wp.prune.pruned_solves += stats.pruned_waves
        wp.prune.escalations += stats.escalations
        wp.prune.escalations_adopted += stats.escalations_adopted
        wp.prune.last_candidate_nodes = stats.candidate_nodes
        wp.prune.last_candidate_pad = stats.candidate_pad
        wp.prune.last_fleet_nodes = int(snapshot.free.shape[0])
    wp.record_drain(stats)
    return engine.bindings, stats
