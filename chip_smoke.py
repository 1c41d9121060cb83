"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc); imports nothing of
JAX or of the grove_tpu package. Phases, each fatal on failure:

  1. card     nvidia-smi's name and power limit, the torch device name/count
  2. build    the place_wave kernel from grove_tpu_torch/kernels/csrc (nvcc
              runs while the host builds the scenarios and runs phase 3's
              plain versions, which need none of the port's kernels)
     profile  the profiled instantiation on the seven waves of the 5120-node
              drain (chained) and on wave 0 at 20480 nodes, dense and
              pruned: clock64 cycles per section of the chain kernel, on
              lines of their own; fails if a gang whose sets require no level
              spent a cycle on tables (`--profile-only` stops after it)
  3. exact    the place_wave kernel against its plain PyTorch version, both
              on the card, tolerance 0 (torch.equal on ok, assigned,
              placement_score, free_after and ok_global), on: the first
              wave (256 gangs) of the full-width bench backlog on the
              5120-node snapshot; at a depth of 64 gangs (their plain
              versions cost 15-25 ms a gang): the same wave with seeded
              group_node_ok/reuse_nodes planes, a scaled-gang wave gated by
              a seeded ok_global bitmap, the first wave on a 5120-node
              snapshot whose free capacity is not dyadic, and the first wave
              of the bench backlog with a quarter of its PodCliqueSets
              spread across zones; the contended and mixed-quality
              scenarios as single batches; the first wave launched 20 times, every
              launch bitwise equal; then the first wave on the 20480-node
              fleet (its walks staged in chunks),
              and the same wave candidate-pruned to its 8192-row plan (B3
              fused: assigned in fleet ordinals, the whole fleet free_after)
  4. drain    the full 5120-node, ~10k-pod backlog through drain_backlog
              (chained harvest): launches == waves, every gang admitted,
              the kernel's free_after equal to the snapshot's free minus
              every bound pod's request recomputed on the host, no node
              over capacity; then the per-wave kernel times, whose sum
              must fall below the earlier design's (WAVE_MS_BEFORE)
  5. scale    the same backlog on 10240 and 20480 nodes, drained dense and
              candidate-pruned: all 1250 gangs admitted by each, the same
              set, free_after consistent with the bindings, no node over
              capacity; the walls and stages of each drain
  6. escalate a small contended fleet whose clipped candidate budget strands
              gangs, drained pruned on the card and with the plain versions
              on the CPU: equal bindings and escalation ledgers, at least
              one escalation adopted
  7. portfolio the stacked launch (B5) on the bench's first wave at 5120
              nodes under params_population(4) and (8): every row bitwise
              equal to a single place_wave launch under that row (free_after
              included); at K = 4 the plain portfolio (every row, then the
              select) against the kernel's rows, winner, objectives and the
              carry it chains; 20 select launches bitwise equal; CUDA-event
              times of the stacked launch at K = 1, 4 and 8 beside the single
              chain, and of the select kernel alone; the full drain at
              portfolio=4 (one "portfolio" launch per wave, every gang
              admitted, the set the single-variant drain admits, free_after
              consistent with the bindings, its wall and stages); solve()
              with escalate_portfolio=4 on the bin-packing trap and the
              contended scenario, card against the plain versions on the CPU
  8. scan     the scan (B4) and the five harvest disciplines: the 5120-node
              backlog drained "chained", "wave", "pipeline", "scan" and
              "resident" at wave_size 256 and "scan" at 32, each with the
              counts set to 0 before it: the chained drain's bindings (order
              included), every gang admitted, free_after consistent with the
              bindings, the round-trip ledger of its discipline (dispatches,
              device_roundtrips == 1 + escalations when resident), one
              "scan" launch per chunk; the first chunk at each wave size (2
              and 11 waves) with retained carries against the plain scan on
              the card, tolerance 0, and each step against a single
              place_wave launch on the carry it entered with; a pruned chunk
              at 20480 nodes likewise, and the pruned scan drain's bindings
              equal to the pruned chained drain's; CUDA-event times of each
              chunk beside the sum of its steps' single launches, kernel ms
              per drain, and the wave harvest's measured p50/p99
  9. sweep    the flight recorder, replay and the tuning sweep (B6): the
              5120-node backlog drained "scan" at wave_size 32 with the
              port's recorder attached (the chained drain's bindings, 40
              waves journaled, none dropped, the record overhead against
              the same drain unrecorded), replayed on the card with 0
              divergences, and swept at K = 4 and 16 (the incumbent row:
              0 divergences, the journal's admitted count; each run of
              same-shape waves one "stacked_scan" launch, counts set to 0
              before each sweep); every B6 launch's rows equal B5 stacked
              launches of its waves and sampled rows single place_wave
              launches, bit for bit; at K = 16 sampled rows of every B6
              launch (first and last real waves, last wave, first and last
              weight rows) against the plain version on the same card
              inputs, tolerance 0; B6 against its plain version at a cut
              depth as well (3 waves of 64 gangs in all, padded to 4 with a
              null wave, K = 2; the plain version runs while nvcc builds);
              each B6 launch's CUDA-event time beside its rows as
              single launches and its waves as B5 launches, and the first
              launch's beside its rounds of the slowest row; the 20480-node
              pruned chained drain recorded, replayed and swept at K = 4
              (candidate waves: the recorded gather, one dense B5 launch on
              its arrays), and the JAX-recorded journal committed under
              tests/data replayed and swept, all with 0 divergences
 10. warm     the warm path (solver/warm.py): the 5120-node backlog drained
              twice, chained, through a fresh WarmPath whose shape history
              lies in a temporary directory — both drains bind what phase 4
              bound, their free_after bitwise equal; the cold drain prepares
              one launch per distinct (shape, pad) (lowerings ==
              exec_cache_misses), the warm drain none, every lookup a hit
              (waves + keys), every gang's rows reused (1250 hits), the
              carry donated; the first wave through the cache against a
              direct place_wave launch and phase 3's plain version on the
              same inputs, and the same entry replayed on the non-dyadic
              snapshot against its direct launch, tolerance 0; phase 3's
              spread backlog, its 8 waves chained twice through one fresh
              cache (waves 0 and 1 share a spread entry), every wave and
              the final carry equal to direct launches; the
              wave_size 32 scan drain (chunks padded to 16, 8, 16, 16) and
              the 20480-node pruned chained drain, cold then warm: the
              bindings of phases 8 and 5, no preparation when warm; a second
              WarmPath prewarmed from the history file prepares every
              recorded shape and then drains with none; the cold and warm
              walls, encode, dispatch and compile seconds, capture ms per
              entry, and per-wave dispatch, direct launch against replay
 11. stream   bench.py's stream scenario (solver/stream.py drain_stream):
              the 25 s trace at base rate 12 (433 gangs, 2819 pods) on a
              1280-node fleet at wave_size 64, depth 2, saturated, through
              one WarmPath, each run with the counts set to 0 before it: a
              warm-up; serial and pipelined (the same admitted set, every
              gang admitted, one "dense" launch per wave, no preparation
              after the warm-up, free_after == the bound requests, no node
              over capacity, the set drain_backlog admits for the same gangs
              in arrival order); scan and resident (class-affine forming)
              bitwise equal to the formed serial run, the scan fused (a chunk
              or more, half the waves or more, one "scan" launch per chunk),
              resident in 1 + escalations round trips; serial and pipelined
              bindings, free_after and ledger equal to a plain serial run on
              the CPU, formed serial, scan and resident to a plain formed
              serial run (the kernels held to their plain versions at the
              stream's own shapes); pruned at 64 candidates (escalations
              forced): the dense run's admitted set, bindings and ledger
              equal to the plain versions on the CPU; paced over the trace's
              first 10 s: a latency for every admitted gang, none negative
              (not clamped: the card's completion stamps against the host's
              arrival instants), bind_p50_s / bind_p99_s printed
 12. tune     bench.py's sweep scenario's stream journal (64 nodes, the
              10 s trace at rate 3, wave_size 8: 27 waves) recorded on the
              card and replayed with 0 divergences; successive halving at
              K = 16, rungs 4 (16, 8, 4, 2 survivors, the incumbent kept);
              recommend valid with 0 bitwise and 0 journal divergences;
              what-if +1 rack and three config variants (0 replay
              divergences); the committed JAX stream journal
              (tests/data/jax_stream_journal.json) replayed and swept with 0
              divergences and recommended with the winner, gates and
              survivors the JAX package computed (jax_stream_recommend.json),
              the document equal to the plain versions' on the CPU
 13. chaos    bench.py's chaos scenario on the card (run_chaos_bench: 192
              nodes, the 12 s trace at rate 8, wave_size 32, resident
              scanned dispatch with forming and pruning, the standard fault
              schedule, the ladder armed) through one WarmPath: the chaos
              run binds as the fault-free baseline (no wave is pruned at
              192 nodes: the same bindings and free capacity after; with a
              pruned wave, the same admitted set), binds no pod twice,
              journals every fire as a `fault.injected` record, explains
              every retry, timeout and ladder failure by the fires, steps
              each of resident, scan, pruning and pipeline down at least
              once and ends with the ladder closed; the armed run without
              faults has zero retries, timeouts and step-downs and the
              baseline's bindings; the chaos journal replays on the card
              with 0 divergences; the recorder survives an injected ENOSPC
              (degraded latched, then cleared, drops counted); baseline and
              chaos bind_p99_s and their ratio printed. Then the same
              schedule on phase 11's 1280-node, 433-gang trace (wave_size
              64): the armed run without faults quiet and with the
              baseline's bindings (its wall beside the baseline's), the
              chaos run with no pruned wave and the baseline's bindings and
              free capacity after, no double bind, the fault accounting,
              the ladder's counters printed. Then a real hang: a spin
              (torch.cuda._sleep) enqueued ahead of one launch of a
              pipelined drain and of a resident one, the watchdog at a third
              of the spin: timeouts counted through the wave's event
              query(), the fault-free bindings
 14. defrag   bench.py's defrag scenario at scale 1 (256 nodes, 32
              squatters): the big gang refused before the plan and admitted
              after it, the warm re-plan preparing no launch, the plan's
              moves equal to the plain versions' on the CPU; plan_rescue of
              the squatters on two cordoned racks, hold_usage True and
              False: moves onto schedulable nodes only, no node over
              capacity, equal to the plain versions'; then at scale 20
              (5120 nodes, 640 squatters) on the card alone: plan_solve_s,
              candidates_evaluated, pods_migrated, the admission gates
 15. serving  the port's GroveController (recorder on) under the Simulator
              on the card: (a) bench.py's default backlog (900 sets, 1250
              gangs, 10,000 pods) on its 5120-node fleet until every pod is
              Ready — every gang's base scheduled, no node over capacity as
              the sum of its pods' requests, every set Available, the
              journal replayed on the CPU's plain versions with 0
              divergences (the first floors wave alone if it took more
              than 60 s); per tick its wall, reconcile phases and host
              stages, the solve passes and launches printed; (b) bench.py's
              replay scenario (16 nodes of 8 cpus, 5 rack-packed jobs): 0
              divergences, at least one "portfolio" launch for the
              rejected job, the document equal to the CPU run's, seconds
              aside, and bench.py's record-overhead gate: 24 rounds of
              0.25 s windows of back-to-back drains, OFF, ON, ON, OFF and
              ON, OFF, OFF, ON in turn (an untimed calibration window sets the count; the warm-up runs
              one recorded drain; each ON window timed through its
              recorder's flush, so the render at capture (the C renderer,
              utils/csrc/serde_render.c) and the writer's I/O are inside;
              every window printed with the draining thread's CPU seconds
              and context switches, and the recorder's split with the
              writer thread's CPU; the draining thread's flush per drain
              with its parts (the wait for the writer's lock, the queue's
              drain, the segment and manifest writes, the rest), capture +
              render, and the writer's file steps), (ON - OFF) / OFF over
              the summed walls
              below 0.05
              (a failed gate fails the run after the last phase); (c) a
              256-node churn world (contended
              backlog with priority classes, a node death, a cordon, a
              revocation notice, defrag on) under a card controller and a
              CPU controller in lockstep: the stores equal after every
              step, the journals equal, seconds aside
 16. sidecar  the port's GREP-375 sidecar (run_sidecar_bench) served over
              gRPC on 127.0.0.1 with the card, driven by the port's
              BackendClient at bench.py's default size: Init, UpdateCluster
              with 5120 nodes, 1250 SyncPodGang (10,000 pods), Solve;
              ReleasePods of one pod and of a whole gang, its
              OnPodGangDelete and re-sync, the incremental Solve (64
              SyncPodGang RPCs answered while the first Solve's device
              phase is parked on its gRPC worker thread); then a
              contended Solve (the replay world, escalation to a portfolio
              of 4). Every gang admitted by the first Solve, no node over
              capacity, 0 new lowerings in the second, at least one
              "portfolio" launch; then the same sequence on a tenth of
              the backlog (5120 nodes, 125 gangs), every gate, every
              SolveResponse equal to an in-process CPU servicer's (the CPU
              side at a cut depth, to keep the run within its time); each
              Solve's solve_micros, host stages and CUDA-event ms, and the
              syncs' count and wall printed
 17. cells    bench.py's cells scenario (run_cells_bench: 32 nodes, the
              25 s trace at rate 4, chunks of 12) with every cell's stream
              drain on the card: every gate (zero lost, zero double-bound,
              zero oversubscribed node-ticks, the recovery replay verified
              with 0 divergences, bindings disjoint, the busiest cell's
              share shrinking over 1, 2 and 4 cells), the document equal
              to the CPU run's, wall-clock keys aside
 18. operator (a) bench.py's tenancy scenario (run_tenancy_bench: 192
              nodes, 200 tenants, the 75 s trace at 1.6 arrivals a second,
              an org quota of 64 CPU, the chaos and the recorder) through
              the port's Manager on the card: every gate, the journal
              replayed on the card and on the CPU's plain versions with 0
              divergences, the document equal to the CPU run's, wall-clock
              keys aside; (b) the operator binary (`python -m
              grove_tpu_torch.runtime`, examples/operator-config.yaml with
              `cluster.source: kwok`) in a subprocess on the card: its
              probes answer, examples/simple1.yaml goes in through the
              admission webhook over TLS and is scheduled and Ready on the
              KWOK fleet, /statusz shows the solves on the card and the
              child's launches, SIGTERM stops it with exit code 0
 19. kubernetes (a) bench.py's rollout scenario (run_rollout_bench: 64
              nodes, every other one revocable, the 90 s trace at 1.2
              arrivals a second from 60 tenants, a make-before-break
              rollout of a 36-pod resident under two revocation storms, the
              recorder) through the port's Manager on the card: every gate,
              the journal replayed on the card and on the CPU's plain
              versions with 0 divergences, the document equal to the CPU
              run's, wall-clock keys aside; (b) the operator binary on
              `cluster.source: kubernetes` in a subprocess on the card
              against tests/fixture_apiserver.py (loaded by path; stdlib
              only): leader election through a KubeLease, the webhook
              configurations' caBundle patched at boot, examples/simple1.yaml
              applied as a PodCliqueSet CR and admitted by the binary's
              webhooks (TLS verified against that caBundle), watched in,
              solved, its 13 pods created and bound through the binding
              subresource, Ready with its status written back; `python -m
              grove_tpu_torch.cli get pods` lists them; /statusz shows the
              solves on the card; SIGTERM releases the lease and exits 0;
              (c) `cli tune sweep --k 4 --rungs 2` over phase 15 (b)'s
              journal on the card, its document equal to `--device cpu`'s,
              seconds aside; the phase prints its own seconds
 20. quality  bench.py's quality scenario (run_quality_bench: the mixed
              Required/Preferred backlog on the 32-node quality cluster, 12
              gangs, scored against the greedy baseline, drained in waves
              of 4, and the 12-node, 4-gang exact bound) on the card at
              portfolio 1 (B1+B2, "dense" launches) and 4 (B5, "portfolio"
              launches), each document equal to the same call's on the
              CPU's plain versions, the measured wave latencies aside; the
              documents, the launches and the phase's seconds printed
 21. shard    the node-sharded solve (B7) on S = 2, 4 and 8 virtual shards of
              the card: (a) place_wave_sharded against sharded_solve_ref on
              the same card inputs, tolerance 0, and bitwise against the
              single launch (B1), dense on bench wave 0 at 5120 nodes and
              pruned on 8191 candidates of 20480 nodes in a pad of 8192,
              each S's launch time beside B1's; on phase 3's 64-gang wave
              on non-dyadic free capacity B7 == sharded_solve_ref, and
              whether it also == B1 is printed; (b) bench.py's shard
              scenario (run_shard_bench: 5120 nodes, a quarter of the
              backlog, waves of 64, the ladder 1, 2, 4, 8) on the card,
              every step's bindings digest equal, and equal to a plain
              drain of the same problem on the CPU; (c) a pruned pipelined
              drain journaled under S = 4 (bindings == the same drain
              unsharded), replayed on the card with 0 divergences with the
              layout rebuilt and unsharded
 22. mesh     the portfolio mesh (B5 x B7) and the scan over shards (B4 x
              B7) on virtual shards of the card: (a) on 8 virtual devices,
              solver_mesh_for's (4, 2), (2, 4) and (8, 1) at P = 4, 2, 8 on
              bench wave 0 (5120 nodes): the portfolio launch under each
              (place_wave_stacked_sharded; the plain B5 at (8, 1)) == the
              unsharded B5 on every output, winner and objectives included,
              and == its plain version on the wave's first 64 (P = 8: 32)
              gangs, each timed beside B5; (b) the drain's first two-wave
              chunk: place_wave_scan_sharded dense at S = 2, 4, 8 (5120
              nodes) and pruned at S = 4 (8191 of 20480 nodes in a pad of
              8192) == B4 on every output and == its plain version on the
              steps cut to 32 gangs, each timed beside B4; (c) the shard
              scenario's 313 gangs drained "scan" and "resident" under 4
              shards (digests == phase 21's plain CPU drain), streamed in
              "scan" mode under them (== the CPU's plain formed-serial
              stream), drained pruned in "scan" under them and at portfolio
              4 under the (4, 2) mesh (each == the unsharded card drain):
              the phase's main path; (d), before (c): on the non-dyadic
              fleet (sim/workloads.py `nondyadic_cluster`, 160 nodes, 24
              gangs; free values and their sums inexact in f32)
              place_wave_sharded at S = 2, 4, 8 dense and pruned, the
              (4, 2) portfolio launch and the 3-step scan at S = 4 == their
              plain versions and == B1, B5 and B4
 then         one JSON line: per kernel variant its launches on the main
              path (phases 4-9 as before, plus `launches_stream`,
              `launches_tune`, `launches_chaos`, `launches_defrag`,
              `launches_serving`, `launches_sidecar`, `launches_cells`,
              `launches_tenancy`, `launches_operator`, `launches_rollout`,
              `launches_kubernetes`, `launches_quality`, `launches_shard`
              and `launches_mesh`, the launches of phases 11-22 ((b) and (c)
              in `launches_kubernetes` and `launches_shard`, (c) in
              `launches_mesh`), added to the first row of their variant), its
              error against the plain version, its time, the plain
              version's time, its bound and a library call's time; then
              the run's seconds, phase 15 (b)'s overhead reading again and
              nvidia-smi's card line; then the last line:
              {"ok": true, "device": {...}}
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
# Per-wave times of the kernel's earlier design (carry in shared memory, every
# domain table built, walks over global memory) on the 5120-node drain (H100
# 80GB HBM3, 700.00 W; PERF.md section 5): the yardstick the drain's per-wave
# times are held against.
WAVE_MS_BEFORE = (113.929, 42.452, 138.592, 103.108, 18.229, 113.476, 42.446)
SCALE_PRUNING = dict(enabled=True, max_candidates=8191, min_fleet=256)


# Gates that fail the run only after every phase has run and printed.
GATE_FAILURES: list[str] = []
# Phase 15 (b)'s overhead reading, repeated on the line before the last.
RECORD_OVERHEAD: list[float] = []
# Phase 15 (b)'s record-overhead reading: an untimed calibration window of
# REPLAY_WINDOW_S seconds of drains sets the count, then REPLAY_ROUNDS rounds
# of windows of that count, OFF, ON, ON, OFF and ON, OFF, OFF, ON in turn: 96
# short windows in about 24 s, each side in each place of a round equally
# often, so the host's drift over the reading and any bias of the place
# cancel and its window-to-window noise averages over twice the windows of a
# 12 s reading, each ON window
# still flushed inside its timing (a quarter of the recorder's 1 s flush
# interval: four times the writes per drain that production pays).
# Phase 16: the share of bench.py's default backlog whose sidecar sequence is
# held against the CPU servicer (the full-size run keeps every other gate).
SIDECAR_CPU_FRAC = 0.1
REPLAY_WINDOW_S = 0.25
REPLAY_ROUNDS = 24
# Phase 18 (a): bench.py's tenancy trace, at its full 75 s.
TENANCY_DURATION_S = 75.0
# Phase 15 (b) keeps its recorded drain's journal here for phase 19 (c).
PHASE15_JOURNAL = os.path.join(tempfile.gettempdir(), f"chip-smoke-replay-{os.getpid()}")


def check(ok: bool, message: str) -> None:
    """Fail the run (an assert statement would vanish under python -O)."""
    if not ok:
        raise AssertionError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from grove_tpu_torch.api import Container, Pod, PodSpec
    from grove_tpu_torch.bench import (
        admitted_free,
        build_backlog,
        build_fleet,
        build_scenario,
        stage_fields,
    )
    from grove_tpu_torch.kernels import build
    from grove_tpu_torch.kernels.place_wave import (
        SECTIONS,
        VARIANTS,
        domain_index,
        place_wave,
        place_wave_stacked,
        reset_launches,
    )
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim import workloads as W
    from grove_tpu_torch.solver.core import SolverParams, batch_to, solve, stack_on
    from grove_tpu_torch.solver.drain import drain_backlog, plan_waves
    from grove_tpu_torch.solver.encode import encode_gangs
    from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates
    from grove_tpu_torch.parallel.portfolio import params_population
    from grove_tpu_torch.solver.reference import (
        solve_batch_ref,
        solve_pruned_ref,
        stacked_scan_solve_ref,
    )
    from grove_tpu_torch.state import build_snapshot

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card -------------------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------------
    # nvcc runs in a thread while the host builds the scenarios below; the
    # first launch waits for it (a failed build raises there, again).
    import threading

    t_build = time.perf_counter()
    nvcc_thread = threading.Thread(target=build.compile_source, args=("place_wave",), daemon=True)
    nvcc_thread.start()

    def phase_done(name):
        print(f"phase {name}: done at {time.perf_counter() - t_start:.1f}s")

    params = SolverParams()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def node_tensors(snap):
        return (
            torch.as_tensor(snap.free, dtype=torch.float32, device=dev),
            torch.as_tensor(snap.capacity, device=dev),
            torch.as_tensor(snap.schedulable, device=dev),
            torch.as_tensor(snap.node_domain_id, device=dev),
        )

    def scenario(cluster, backlog):
        topo = W.bench_topology()
        gangs, pods = [], {}
        for pcs in backlog:
            ds = expand_podcliqueset(pcs, topo)
            gangs.extend(ds.podgangs)
            pods.update({p.name: p for p in ds.pods})
        bound = None
        if isinstance(cluster, tuple):
            cluster, bound = cluster
        return gangs, pods, build_snapshot(cluster, topo, bound_pods=bound)

    def timed(fn):
        """(result, ms) of one call, timed with CUDA events."""
        torch.cuda.synchronize()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    def compare(label, got, want):
        """Tolerance 0 on every output; returns the largest float error (0)."""
        err = 0.0
        for nm, a, b in zip(NAMES, got, want):
            check(torch.equal(a, b),
                  f"exact[{label}]: kernel != plain on {nm} at {torch.nonzero(a != b)[:8].tolist()}")
            if a.dtype.is_floating_point and a.numel():
                err = max(err, float((a - b).abs().max()))
        return err

    gangs_b, pods_b, snap_b, n_nodes, _ = build_scenario(1.0)
    gidx_b = {g.name: i for i, g in enumerate(gangs_b)}
    plan_b = plan_waves(gangs_b, 256)
    dom_b = domain_index(snap_b.node_domain_id, dev)

    def encode_wave(ws, snap=snap_b, pods=pods_b, gidx=gidx_b):
        wave, (mg, ms, mp), pad = ws
        batch, _ = encode_gangs(
            wave, pods, snap, max_groups=mg, max_sets=ms, max_pods=mp,
            pad_gangs_to=pad, global_index_of=gidx,
        )
        return batch

    snap_4 = build_fleet(4.0)
    n_4 = snap_4.capacity.shape[0]
    dom_4 = domain_index(snap_4.node_domain_id, dev)
    first = encode_wave(plan_b[0])
    first_4 = encode_wave(plan_b[0], snap_4)
    pruning = PruningConfig(**SCALE_PRUNING)
    plan4 = plan_candidates(snap_4, first_4, pruning)
    check(plan4 is not None and plan4.pad == 8192, "exact: the 20480-node wave did not prune to 8192")
    pt4 = plan4.tensors(dev)
    pb4 = plan4.gather_batch(first_4)

    # The bench's quantities are dyadic rationals, which any summation order
    # adds exactly. This 5120-node snapshot's are not — 31.7-cpu hosts, a
    # third of them part-filled in 0.3-cpu / 300Mi steps — so the order of
    # every domain sum shows in its last bits.
    nd_nodes = W.synthetic_cluster(cpu=31.7, memory=100.3 * 2**30)
    squatters = [
        Pod(name=f"squat-{k}", node_name=node.name, spec=PodSpec(containers=[Container(
            name="c", requests={"cpu": 0.3 * (k % 7 + 1), "memory": 300 * 2**20 * (k % 3 + 1)})]))
        for k, node in enumerate(nd_nodes[::3])
    ]
    snap_nd = build_snapshot(nd_nodes, W.bench_topology(), bound_pods=squatters)

    # A quarter of the backlog's PodCliqueSets at two replicas spread across
    # zones: the first wave carries the replica-spread planes.
    gangs_sp, pods_sp = build_backlog(1.0, spread_every=4)
    gidx_sp = {g.name: i for i, g in enumerate(gangs_sp)}
    spread_ws = plan_waves(gangs_sp, 256)[0]

    rng = np.random.default_rng(0)
    scaled_ws = next(ws for ws in plan_b if ws[0][0].base_podgang_name is not None)

    def cut(ws, k=64):
        """A wave's first k gangs: the variant cases below run at this depth
        (their plain versions cost 15-25 ms a gang), the full wave above."""
        return ws[0][:k], ws[1], k

    first64 = encode_wave(cut(plan_b[0]))
    spread_first = encode_wave(cut(spread_ws), pods=pods_sp, gidx=gidx_sp)
    check(spread_first.spread_level is not None and (spread_first.spread_level >= 0).any(),
          "exact: the spread wave carries no spread planes")
    g0, mg0 = first64.group_total.shape
    cases = [
        ("bench wave 0", snap_b, first, np.zeros(len(gangs_b), bool)),
        (
            "bench wave 0's first 64 gangs + group_node_ok/reuse_nodes",
            snap_b,
            first64._replace(
                group_node_ok=rng.random((g0, mg0, n_nodes)) < 0.9,
                reuse_nodes=rng.random((g0, n_nodes)) < 0.01,
            ),
            np.zeros(len(gangs_b), bool),
        ),
        ("bench scaled wave's first 64 gangs, gated by ok_global", snap_b,
         encode_wave(cut(scaled_ws)), rng.random(len(gangs_b)) < 0.7),
        ("bench wave 0's first 64 gangs on non-dyadic free capacity", snap_nd,
         encode_wave(cut(plan_b[0]), snap_nd), np.zeros(len(gangs_b), bool)),
    ]
    for label, cluster, backlog in (
        ("contended", W.contended_cluster(), W.contended_backlog(48)),
        ("mixed quality", W.quality_cluster(), W.mixed_backlog()),
    ):
        gangs_s, pods_s, snap_s = scenario(cluster, backlog)
        batch_s, _ = encode_gangs(
            gangs_s, pods_s, snap_s, global_index_of={g.name: i for i, g in enumerate(gangs_s)}
        )
        cases.append((label, snap_s, batch_s, np.zeros(len(gangs_s), bool)))
    cases.append(("bench wave 0's first 64 gangs with spread planes", snap_b, spread_first,
                  np.zeros(len(gangs_sp), bool)))

    # ---- phase 3's plain versions, while nvcc builds --------------------------
    # (PyTorch on the card and the host, none of the port's kernels: they fill
    # the build's wait; their times are taken beside the running nvcc)
    okg0 = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    tb4 = batch_to(first_4, dev)
    ptb4 = batch_to(pb4, dev)
    pruned_args = (pt4.capacity, pt4.schedulable, pt4.node_domain_id, ptb4, params)
    profile_only = "--profile-only" in sys.argv
    plain = {}
    if not profile_only:
        for label, snap, batch, okg_np in cases:
            tb = batch_to(batch, dev)
            okg = torch.as_tensor(okg_np, device=dev)
            plain[label] = timed(lambda: solve_batch_ref(*node_tensors(snap), tb, params,
                                                         okg.clone()))
        plain["20480 dense"] = timed(
            lambda: solve_batch_ref(*node_tensors(snap_4), tb4, params, okg0.clone()))
        plain["20480 pruned"] = timed(lambda: solve_pruned_ref(
            node_tensors(snap_4)[0], *pruned_args, okg0.clone(), pt4.cand_idx, plan4.count))
        b6_case = sweep_case(dev, snap_b, gangs_b, pods_b)
        plain["B6"] = timed(lambda: stacked_scan_solve_ref(*b6_case))

    nvcc_thread.join()
    build.load("place_wave")
    info = build.build_info.get("place_wave", {})
    print(f"build: place_wave.cu in {info.get('seconds', 0.0):.2f}s (nvcc), ready "
          f"{time.perf_counter() - t_build:.2f}s after the start\n{info.get('ptxas', '')}")

    # ---- profile: cycles per section of the kernel ---------------------------
    def profile_wave(label, batch, free, okg, node_rest, domains, **extra):
        """One launch of the profiled instantiation; prints its cycles per
        section (summed over the wave's gangs and its head and tail) and
        checks that no gang whose valid sets require no level builds a
        table."""
        prof = {}
        tb = batch_to(batch, dev)
        _, ms_w = timed(lambda: place_wave(free, *node_rest, tb, params, okg, domains=domains,
                                           profile=prof, **extra))
        cyc = prof["prof"].cpu().numpy()
        tot = cyc.sum(axis=0)
        total = int(tot.sum())
        print(f"profile[{label}]: G={cyc.shape[0] - 1} valid {int(np.asarray(batch.gang_valid).sum())} "
              f"cycles {total} in {ms_w:.3f} ms ({total / ms_w / 1e6:.3f} GHz) on {card}")
        print("profile[" + label + "] sections: " + "; ".join(
            f"{nm} {int(c)} ({100 * c / max(total, 1):.1f}%)" for nm, c in zip(SECTIONS, tot)))
        col = SECTIONS.index("tables + feas2")
        levels = (np.asarray(batch.set_req_level) >= 0) & np.asarray(batch.set_valid, bool)
        no_level = ~levels.any(axis=1)
        check(not cyc[:-1][no_level, col].any(),
              f"profile[{label}]: a gang whose sets require no level built a table")
        print(f"profile[{label}]: {int(no_level.sum())} gangs require no level, table cycles 0; "
              f"{int((cyc[:-1, col] > 0).sum())} gangs built a table")
        return cyc

    free_w = node_tensors(snap_b)[0]
    okg_w = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    for k, ws in enumerate(plan_b):
        profile_wave(f"{n_nodes} dense, wave {k}", encode_wave(ws), free_w, okg_w,
                     node_tensors(snap_b)[1:], dom_b)
    okg_4 = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    profile_wave(f"{n_4} dense, wave 0", first_4, node_tensors(snap_4)[0], okg_4.clone(),
                 node_tensors(snap_4)[1:], dom_4)
    profile_wave(f"{n_4} pruned to {plan4.count}/{plan4.pad}, wave 0", pb4,
                 node_tensors(snap_4)[0], okg_4.clone(),
                 (pt4.capacity, pt4.schedulable, pt4.node_domain_id), pt4.domains,
                 cand_idx=pt4.cand_idx, cand_count=plan4.count)
    # The walk's pace: wave 0 with every required set moved to the zone
    # level (no preferences), so each gang walks the broadest domains once
    # per set; stage-1 walk cycles over (walks x the largest zone) is the
    # cost of one node step, against the ~4-cycle latency of a dependent add.
    for snap, batch, domains in ((snap_b, first, dom_b), (snap_4, first_4, dom_4)):
        req = np.asarray(batch.set_req_level)
        walks = np.asarray(batch.set_valid, bool) & (req >= 0)
        walks &= np.asarray(batch.gang_valid, bool)[:, None]
        zb = batch._replace(set_req_level=np.where(walks, 0, req).astype(np.int32),
                            set_pref_level=np.full_like(req, -1))
        zone = np.asarray(snap.node_domain_id[0])
        longest = int(np.bincount(zone[zone >= 0]).max())
        nn = snap.capacity.shape[0]
        cyc = profile_wave(f"{nn} zone walks", zb, node_tensors(snap)[0], okg_4.clone(),
                           node_tensors(snap)[1:], domains)
        per_step = cyc[:, SECTIONS.index("stage-1 walks")].sum() / (int(walks.sum()) * longest)
        print(f"walk pace[{nn} nodes]: {int(walks.sum())} zone walks of up to {longest} nodes, "
              f"{per_step:.2f} cycles per node step (a dependent f32 add: ~4) on {card}")
    if profile_only:
        return 0  # the breakdown alone: no result line
    phase_done("2, build + profile")

    # ---- 3. kernel vs plain, exact, on the card ------------------------------

    err = {"dense": 0.0, "dense_scale": 0.0, "pruned": 0.0}
    verdicts = {}  # label -> the plain version's ok, for the bounds below
    for label, snap, batch, okg_np in cases:
        tb = batch_to(batch, dev)
        okg = torch.as_tensor(okg_np, device=dev)
        domains = dom_b if snap is snap_b else domain_index(snap.node_domain_id, dev)
        want, plain_ms = plain[label]
        if label == "bench wave 0":
            dense_plain_ms = plain_ms
        got = place_wave(*node_tensors(snap), tb, params, okg.clone(), domains=domains)
        torch.cuda.synchronize()
        err["dense"] = max(err["dense"], compare(label, got, want))
        verdicts[label] = want[1].cpu().numpy()
        print(f"exact[{label}]: G={batch.gang_valid.shape[0]} N={snap.capacity.shape[0]} "
              f"admitted {int(want[1].sum())}/{int(np.asarray(batch.gang_valid).sum())} "
              f"valid — kernel == plain on {', '.join(NAMES)}")

    # The first full wave launched 20 times: bitwise-equal outputs every
    # time (a race between the warps of the take loop would show here).
    tb0 = batch_to(first, dev)
    runs = [place_wave(*node_tensors(snap_b), tb0, params, okg0.clone(), domains=dom_b)
            for _ in range(20)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        compare("bench wave 0, 20 launches", run, runs[0])
    print(f"exact[bench wave 0, 20 launches, N={n_nodes}]: every launch equal on {', '.join(NAMES)}")

    # Times at the 5120-node main path's shape: the first full wave.
    dense_ms0, _ = time_variant(place_wave, timed, node_tensors(snap_b), tb0, okg0, params, dom_b,
                                {}, None)
    dense_bound = place_wave_bound(first, snap_b.node_domain_id, snap_b.capacity.shape[1],
                                   np.zeros(len(gangs_b), bool), verdicts["bench wave 0"])
    print(f"timing[bench wave 0, G={first.gang_valid.shape[0]}, N={n_nodes}]: kernel {dense_ms0:.3f} ms/wave, plain "
          f"{dense_plain_ms:.1f} ms, bound {dense_bound[0]:.6f} ms ({dense_bound[1]}) on {card}")

    # The first wave on the 20480-node fleet (snap_4, first_4): dense, then
    # candidate-pruned to its plan (B3 fused into the launch).
    want, dense4_plain_ms = plain["20480 dense"]
    got = place_wave(*node_tensors(snap_4), tb4, params, okg0.clone(), domains=dom_4)
    torch.cuda.synchronize()
    err["dense_scale"] = compare("bench wave 0 on 20480 nodes", got, want)
    ok4 = want[1].cpu().numpy()
    print(f"exact[bench wave 0, N={n_4}]: admitted {int(want[1].sum())}/"
          f"{int(first_4.gang_valid.sum())} valid — kernel == plain on {', '.join(NAMES)}")
    dense4_ms, _ = time_variant(place_wave, timed, node_tensors(snap_4), tb4, okg0, params,
                                dom_4, {}, None)
    dense4_bound = place_wave_bound(first_4, snap_4.node_domain_id, snap_4.capacity.shape[1],
                                    np.zeros(len(gangs_b), bool), ok4)

    want, pruned_plain_ms = plain["20480 pruned"]
    got = place_wave(node_tensors(snap_4)[0], *pruned_args, okg0.clone(), domains=pt4.domains,
                     cand_idx=pt4.cand_idx, cand_count=plan4.count)
    torch.cuda.synchronize()
    err["pruned"] = compare("bench wave 0 on 20480 nodes, pruned", got, want)
    ok4p = want[1].cpu().numpy()
    print(f"exact[bench wave 0, N={n_4}, pruned to {plan4.count}/{plan4.pad}]: admitted "
          f"{int(want[1].sum())}/{int(first_4.gang_valid.sum())} valid — kernel == plain on "
          f"{', '.join(NAMES)} (assigned in fleet ordinals, the whole fleet free_after)")
    pruned_ms, _ = time_variant(
        place_wave, timed, (node_tensors(snap_4)[0],) + pruned_args[:3], ptb4, okg0, params,
        pt4.domains, {"cand_idx": pt4.cand_idx, "cand_count": plan4.count}, None,
    )
    # The pruned launch moves the fleet carry only through B3's gather and
    # scatter: count its bytes once, there, and not again on the pad axis.
    pruned_bound = place_wave_bound(plan4.gather_batch(first_4), pt4.node_domain_id, 4,
                                    np.zeros(len(gangs_b), bool), ok4p,
                                    carry_bytes=b3_bytes(plan4.pad, plan4.count, 4))
    b3_bound_ms = b3_bytes(plan4.pad, plan4.count, 4) / H100_BYTES_PER_S * 1e3
    # B3's gather and scatter as library calls, on the plan's candidate rows.
    free_l = node_tensors(snap_4)[0]
    idx_l = torch.as_tensor(plan4.idx, dtype=torch.long, device=dev)
    library_ms = min(timed(lambda: free_l.index_copy_(0, idx_l, free_l.index_select(0, idx_l)))[1]
                     for _ in range(5))
    print(f"timing[bench wave 0, N={n_4}]: dense {dense4_ms:.3f} ms (plain "
          f"{dense4_plain_ms:.1f} ms, bound {dense4_bound[0]:.6f} ms {dense4_bound[1]}); "
          f"pruned {pruned_ms:.3f} ms (plain {pruned_plain_ms:.1f} ms, bound "
          f"{pruned_bound[0]:.6f} ms {pruned_bound[1]}; B3 alone: bound {b3_bound_ms:.6f} ms, "
          f"index_select + index_copy_ {library_ms:.4f} ms, {idx_l.numel()} rows) on {card}")

    phase_done("3, exact")

    # ---- 4. the main path: full drain through the kernel ---------------------
    # (the garbage of the phases above collected first, outside the timing)
    gc.collect()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    bindings, stats = drain_backlog(gangs_b, pods_b, snap_b, wave_size=256, params=params)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = dict(place_wave.variant_launches)
    check(launches == {**dict.fromkeys(VARIANTS, 0), "dense": stats.waves}
          and stats.waves > 0, f"drain: launches {launches} for {stats.waves} waves")
    check(stats.admitted == len(gangs_b), f"drain: admitted {stats.admitted}/{len(gangs_b)}")
    free_host = admitted_free(bindings, pods_b, snap_b)
    check(
        stats.free_after is not None and np.array_equal(stats.free_after, free_host),
        "drain: kernel free_after != snapshot free minus bound pods' requests",
    )
    check(bool((free_host >= 0).all()), "drain: a node is over capacity")
    n_pods = sum(len(b) for b in bindings.values())
    print(f"drain: gangs {len(gangs_b)} gangs_admitted {stats.admitted} pods {len(pods_b)} "
          f"pods_bound {stats.pods_bound} ({n_pods} bindings) waves {stats.waves} "
          f"launches {launches['dense']} wall {drain_s:.4f} (the warm pre-pass compile_s "
          f"{stats.compile_s:.4f} + drain_s {stats.total_s:.4f}: encode {stats.encode_s:.4f}, "
          f"dispatch {stats.dispatch_s:.4f}, harvest {stats.harvest_s:.4f}, "
          f"decode {stats.decode_s:.4f}) on {card}")

    # Per-wave kernel time over the drain's own waves (after the warm-up above).
    wave_ms = []
    free_w = node_tensors(snap_b)[0]
    okg_w = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    batches = [batch_to(encode_wave(ws), dev) for ws in plan_b]
    for tb in batches:
        wave_ms.append(timed(lambda: place_wave(free_w, *node_tensors(snap_b)[1:], tb, params,
                                                okg_w, domains=dom_b))[1])
    print(f"drain kernels: per-wave ms {[round(x, 3) for x in wave_ms]} sum {sum(wave_ms):.3f} "
          f"ms; the earlier design: {list(WAVE_MS_BEFORE)} sum {sum(WAVE_MS_BEFORE):.3f} ms "
          f"({sum(WAVE_MS_BEFORE) / sum(wave_ms):.2f}x) on {card}")
    check(sum(wave_ms) < sum(WAVE_MS_BEFORE),
          f"drain kernels: {sum(wave_ms):.3f} ms per drain, not below the earlier design's "
          f"{sum(WAVE_MS_BEFORE):.3f} ms")

    phase_done("4, drain")

    # ---- 5. the scale drains: 10240 and 20480 nodes, dense and pruned --------
    torch.cuda.synchronize()
    reset_launches()
    scale_runs = []
    scale_bindings = {}
    for scale in (2.0, 4.0):
        snap = build_fleet(scale)
        admitted = {}
        for mode, cfg in (("dense", None), ("pruned", pruning)):
            t0 = time.perf_counter()
            b_s, st = drain_backlog(gangs_b, pods_b, snap, wave_size=256, params=params,
                                    pruning=cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            label = f"scale[{snap.capacity.shape[0]} nodes, {mode}]"
            check(st.admitted == len(gangs_b), f"{label}: admitted {st.admitted}/{len(gangs_b)}")
            free_s = admitted_free(b_s, pods_b, snap)
            check(np.array_equal(st.free_after, free_s),
                  f"{label}: free_after != snapshot free minus bound pods' requests")
            check(bool((free_s >= 0).all()), f"{label}: a node is over capacity")
            if cfg is not None:
                check(st.pruned_waves == st.waves, f"{label}: {st.pruned_waves}/{st.waves} pruned")
            admitted[mode] = set(b_s)
            scale_bindings[scale, mode] = b_s
            row = stage_fields(st)
            scale_runs.append((label, row))
            print(f"{label}: wall {wall:.4f} s, drain_s {row['drain_s']:.4f} (encode "
                  f"{row['encode_s']:.4f}, prune {row['prune_s']:.4f}, dispatch "
                  f"{row['dispatch_s']:.4f}, harvest {row['harvest_s']:.4f}, decode "
                  f"{row['decode_s']:.4f}), waves {row['waves']}, pruned waves "
                  f"{row['pruned_waves']}, candidates {row['candidate_nodes']}/"
                  f"{row['candidate_pad']}, escalations {row['escalations']} (adopted "
                  f"{row['escalations_adopted']}), round trips {row['device_roundtrips']}, "
                  f"admitted {row['admitted']}/{len(gangs_b)} on {card}")
        check(admitted["dense"] == admitted["pruned"],
              f"scale[{scale}]: dense and pruned admit different gang sets")
    scale_launches = dict(place_wave.variant_launches)
    check(scale_launches["dense"] > 0 and scale_launches["pruned"] > 0,
          f"scale: launches {scale_launches}: a variant of the path never ran")
    print(f"scale launches: {scale_launches}")

    # Per-wave kernel times over the 20480-node drains' own waves, dense and
    # pruned, each variant chained through its own carry.
    free_d, free_p = node_tensors(snap_4)[0], node_tensors(snap_4)[0]
    okg_d, okg_p = (torch.zeros(len(gangs_b), dtype=torch.bool, device=dev) for _ in range(2))
    dense_ms, pruned_ms_w = [], []
    for ws in plan_b:
        batch = encode_wave(ws, snap_4)
        tb = batch_to(batch, dev)
        dense_ms.append(timed(lambda: place_wave(free_d, *node_tensors(snap_4)[1:], tb, params,
                                                 okg_d, domains=dom_4))[1])
        plan = plan_candidates(snap_4, batch, pruning)
        pt = plan.tensors(dev)
        ptb = batch_to(plan.gather_batch(batch), dev)
        pruned_ms_w.append(timed(lambda: place_wave(
            free_p, pt.capacity, pt.schedulable, pt.node_domain_id, ptb, params, okg_p,
            domains=pt.domains, cand_idx=pt.cand_idx, cand_count=plan.count))[1])
    print(f"scale kernels[{n_4} nodes]: dense per-wave ms "
          f"{[round(x, 3) for x in dense_ms]} sum {sum(dense_ms):.3f} ms; pruned per-wave ms "
          f"{[round(x, 3) for x in pruned_ms_w]} sum {sum(pruned_ms_w):.3f} ms on {card}")

    phase_done("5, scale")

    # ---- 6. escalation on the card against the plain drain on the CPU -------
    esc_nodes = W.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2)
    gangs_e, pods_e, snap_e = scenario(esc_nodes, W.synthetic_backlog(10, 10, 10))
    esc_cfg = PruningConfig(enabled=True, max_candidates=24, min_fleet=16, min_pad=8)
    b_card, st_card = drain_backlog(gangs_e, pods_e, snap_e, wave_size=8, pruning=esc_cfg)
    b_cpu, st_cpu = drain_backlog(gangs_e, pods_e, snap_e, wave_size=8, pruning=esc_cfg,
                                  device="cpu")
    ledger = lambda st: (st.escalations, st.escalations_adopted)  # noqa: E731
    check(b_card == b_cpu, "escalate: card bindings != plain CPU bindings")
    check(ledger(st_card) == ledger(st_cpu),
          f"escalate: card ledger {ledger(st_card)} != CPU ledger {ledger(st_cpu)}")
    check(st_card.escalations >= 1 and st_card.escalations_adopted >= 1,
          f"escalate: ledger {ledger(st_card)} has no adopted escalation")
    check(np.array_equal(st_card.free_after, st_cpu.free_after), "escalate: free_after differs")
    print(f"escalate: {len(gangs_e)} gangs on {snap_e.capacity.shape[0]} nodes, admitted "
          f"{st_card.admitted}, escalations {st_card.escalations} adopted "
          f"{st_card.escalations_adopted} — card == plain CPU drain")

    phase_done("6, escalate")

    # ---- 7. portfolio: the stacked launch (B5) ------------------------------
    pf = portfolio_phase(dev, card, timed, compare, node_tensors, snap_b, first, dom_b,
                         len(gangs_b))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    b_pf, st_pf = drain_backlog(gangs_b, pods_b, snap_b, wave_size=256, params=params,
                                portfolio=4)
    torch.cuda.synchronize()
    pf_wall = time.perf_counter() - t0
    pf_launches = dict(place_wave.variant_launches)
    check(pf_launches == {**dict.fromkeys(VARIANTS, 0), "portfolio": st_pf.waves}
          and st_pf.waves == stats.waves,
          f"portfolio drain: launches {pf_launches} for {st_pf.waves} waves")
    check(st_pf.admitted == len(gangs_b),
          f"portfolio drain: admitted {st_pf.admitted}/{len(gangs_b)}")
    check(set(b_pf) == set(bindings), "portfolio drain: admits another set than the drain")
    free_pf = admitted_free(b_pf, pods_b, snap_b)
    check(np.array_equal(st_pf.free_after, free_pf),
          "portfolio drain: free_after != snapshot free minus bound pods' requests")
    check(bool((free_pf >= 0).all()), "portfolio drain: a node is over capacity")
    row = stage_fields(st_pf)
    print(f"portfolio drain[P=4, {n_nodes} nodes]: wall {pf_wall:.4f} s, drain_s "
          f"{row['drain_s']:.4f} (encode {row['encode_s']:.4f}, dispatch "
          f"{row['dispatch_s']:.4f}, harvest {row['harvest_s']:.4f}, decode "
          f"{row['decode_s']:.4f}), waves {row['waves']}, launches {pf_launches['portfolio']}, "
          f"admitted {row['admitted']}/{len(gangs_b)}, the single drain's set, on {card}")
    # Per-wave kernel time over the portfolio drain's own waves, chained
    # through one carry (measured as phase 4 measures the single drain's).
    pstack4 = stack_on(params_population(4), dev)
    free_w = node_tensors(snap_b)[0]
    okg_w = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    pf_wave_ms = [timed(lambda: place_wave_stacked(free_w, *node_tensors(snap_b)[1:], tb, pstack4,
                                                   okg_w, domains=dom_b, select=True))[1]
                  for tb in batches]
    print(f"portfolio drain kernels[P=4]: per-wave ms {[round(x, 3) for x in pf_wave_ms]} sum "
          f"{sum(pf_wave_ms):.3f} ms; the single drain's sum {sum(wave_ms):.3f} ms on {card}")
    for label, (cluster, backlog) in (
        ("bin-packing trap", (W.binpack_trap_cluster(), W.binpack_trap_backlog())),
        ("contended", (W.contended_cluster(), W.contended_backlog(48))),
    ):
        g_e, p_e, s_e = scenario(cluster, backlog)
        batch_e, _ = encode_gangs(g_e, p_e, s_e)
        on_card = solve(s_e, batch_e, params, escalate_portfolio=4)
        on_cpu = solve(s_e, batch_e, params, escalate_portfolio=4, device="cpu")
        single = solve(s_e, batch_e, params, device="cpu")
        compare(f"escalation, {label}", [x.cpu() for x in on_card[:4]], on_cpu[:4])
        print(f"escalation[{label}]: G={len(g_e)} N={s_e.capacity.shape[0]} admitted "
              f"{int(single.ok.sum())} by the base solve, {int(on_card.ok.sum())} after "
              f"escalate_portfolio=4 — card == plain CPU on ok, assigned, placement_score, "
              f"free_after")

    phase_done("7, portfolio")

    # ---- 8. scan: B4 and the five harvest disciplines ------------------------
    sc = scan_phase(dev, card, timed, node_tensors, encode_wave, snap_b, gangs_b, pods_b,
                    bindings, dom_b, snap_4, scale_bindings[4.0, "pruned"], pruning, wave_ms)

    phase_done("8, scan")

    # ---- 9. sweep: the flight recorder, replay and the tuning sweep (B6) -------
    sw = sweep_phase(dev, card, timed, snap_b, gangs_b, pods_b, sc["chained32"], snap_4,
                     scale_bindings[4.0, "pruned"], pruning, b6_case, plain["B6"])

    phase_done("9, sweep")

    # ---- 10. warm: the launch cache, row reuse and device-resident state -----
    warm_phase(dev, card, snap_b, gangs_b, pods_b, bindings, stats, plan_b, encode_wave,
               dom_b, plain["bench wave 0"][0], snap_nd, sc["chained32"], snap_4,
               scale_bindings[4.0, "pruned"], pruning, (gangs_sp, pods_sp))

    phase_done("10, warm")

    # ---- 11. stream: the streaming drain under live arrivals -----------------
    stream_launches = stream_phase(dev, card)

    phase_done("11, stream")

    # ---- 12. tune: halving, recommend with its exact audit, what-if ----------
    tune_launches = tune_phase(dev, card)

    phase_done("12, tune")

    # ---- 13. chaos: faults, the ladder and the watchdog on the card ----------
    chaos_launches = chaos_phase(dev, card)

    phase_done("13, chaos")

    # ---- 14. defrag: the migration and rescue planners on the card -----------
    defrag_launches = defrag_phase(dev, card)

    phase_done("14, defrag")

    # ---- 15. serving: GroveController under the Simulator on the card ---------
    serving_launches = serving_phase(dev, card)

    phase_done("15, serving")

    # ---- 16. sidecar: the GREP-375 backend over gRPC on the card --------------
    sidecar_launches = sidecar_phase(dev, card)

    phase_done("16, sidecar")

    # ---- 17. cells: sharded reconcile cells with journal recovery ------------
    cells_launches = cells_phase(dev, card)

    phase_done("17, cells")

    # ---- 18. the operator: the tenancy bench and the Manager binary ---------
    tenancy_launches, operator_launches = operator_phase(dev, card)

    phase_done("18, operator")

    # ---- 19. kubernetes: the rollout bench, the apiserver source, the CLI ---
    rollout_launches, kubernetes_launches = kubernetes_phase(dev, card)

    phase_done("19, kubernetes")

    # ---- 20. quality: bench.py's quality scenario at portfolio 1 and 4 -------
    quality_launches = quality_phase(dev, card)

    phase_done("20, quality")

    # ---- 21. shard: the node-sharded solve (B7) on virtual shards -------------
    nondyadic = next((snap, batch) for label, snap, batch, _ in cases if snap is snap_nd)
    sh = shard_phase(dev, card, timed, compare, node_tensors, snap_b, first, gangs_b, snap_4,
                     first_4, plan4, dense_bound, pruned_bound, nondyadic)

    phase_done("21, shard")

    # ---- 22. mesh: the portfolio mesh (B5 x B7) and the scan over shards ------
    mh = mesh_phase(dev, card, timed, node_tensors, snap_b, gangs_b, encode_wave, plan_b, cut,
                    snap_4, pruning, sh["cpu_digest"])

    phase_done("22, mesh")

    # ---- kernels line --------------------------------------------------------
    src = "grove_tpu_torch/kernels/csrc/place_wave.cu"
    print(json.dumps({"kernels": add_path_launches([
        {"name": "place_wave(B1+B2, dense, 5120 nodes)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:537", "launches": launches["dense"],
         "max_abs_err": err["dense"], "ms": dense_ms0, "plain_ms": dense_plain_ms,
         "bound_ms": dense_bound[0], "bound_by": dense_bound[1], "library_ms": None},
        {"name": "place_wave(B1+B2, dense, 10240/20480 nodes)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:537", "launches": scale_launches["dense"],
         "max_abs_err": err["dense_scale"], "ms": dense4_ms, "plain_ms": dense4_plain_ms,
         "bound_ms": dense4_bound[0], "bound_by": dense4_bound[1], "library_ms": None},
        {"name": "place_wave(B1+B2+B3, pruned)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/pruning.py:166", "launches": scale_launches["pruned"],
         "max_abs_err": err["pruned"], "ms": pruned_ms, "plain_ms": pruned_plain_ms,
         "bound_ms": pruned_bound[0], "bound_by": pruned_bound[1], "library_ms": library_ms},
        {"name": "place_wave_stacked(B5, K=4, select)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:650", "launches": pf_launches["portfolio"],
         "max_abs_err": pf["err"], "ms": pf["ms"], "plain_ms": pf["plain_ms"],
         "bound_ms": pf["bound"][0], "bound_by": pf["bound"][1], "library_ms": None},
        *sc["rows"],
        sw["row"],
        *sh["rows"],
        *mh["rows"],
    ], {"stream": stream_launches, "tune": tune_launches, "chaos": chaos_launches,
        "defrag": defrag_launches, "serving": serving_launches, "sidecar": sidecar_launches,
        "cells": cells_launches, "tenancy": tenancy_launches,
        "operator": operator_launches, "rollout": rollout_launches,
        "kubernetes": kubernetes_launches, "quality": quality_launches,
        "shard": sh["launches"], "mesh": mh["launches"]})}))
    print(f"elapsed {time.perf_counter() - t_start:.1f}s; phase 15 (b) record overhead "
          f"{', '.join(f'{x:.4f}' for x in RECORD_OVERHEAD)} (gate < 0.05); card: {card_line()}")
    check(not GATE_FAILURES, "; ".join(GATE_FAILURES))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


NAMES = ("assigned", "ok", "placement_score", "free_after", "ok_global")


def warm_phase(dev, card, snap, gangs, pods, chained, chained_stats, planned, encode_wave,
               domains, plain_wave0, snap_nd, chained32, snap_4, pruned_chained_4, pruning,
               spread_backlog):
    """Phase 10: the warm path on the card (see the module docstring)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from grove_tpu_torch.kernels.place_wave import domain_index, place_wave, reset_launches
    from grove_tpu_torch.solver.core import SolverParams, batch_to, decode_bindings
    from grove_tpu_torch.solver.drain import (
        ScanConfig,
        class_runs,
        drain_backlog,
        plan_waves,
        scan_chunks,
    )
    from grove_tpu_torch.solver.warm import ExecutableCache, WarmPath

    from grove_tpu_torch.solver.encode import encode_gangs

    params = SolverParams()
    n_keys = len({ws[1:] for ws in planned})
    gidx = {g.name: i for i, g in enumerate(gangs)}

    def encode_gangs_wave(ws):
        wave, (mg, ms, mp), pad = ws
        return encode_gangs(wave, pods, snap, max_groups=mg, max_sets=ms, max_pods=mp,
                            pad_gangs_to=pad, global_index_of=gidx)
    tmp = tempfile.mkdtemp(prefix="grove-warm-")
    try:
        wp = WarmPath()
        wp.executables.history_path = os.path.join(tmp, "solve-shapes.json")

        def drain(label, path, fleet=snap, **kw):
            gc.collect()  # the phases' garbage, outside the timing
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            b, st = drain_backlog(gangs, pods, fleet, params=params, warm_path=path, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(place_wave.variant_launches)
            check(sum(launches.values()) == st.dispatches,
                  f"warm[{label}]: launches {launches} for {st.dispatches} dispatches")
            print(f"warm[{label}]: wall {wall:.4f} s (compile_s {st.compile_s:.4f} + drain_s "
                  f"{st.total_s:.4f}: encode {st.encode_s:.4f}, prune {st.prune_s:.4f}, dispatch "
                  f"{st.dispatch_s:.4f}, harvest {st.harvest_s:.4f}, decode {st.decode_s:.4f}), "
                  f"waves {st.waves}, lowerings {st.lowerings}, exec hits {st.exec_cache_hits} "
                  f"misses {st.exec_cache_misses}, encode reuse {st.encode_reuse_hits}/"
                  f"{st.encode_reuse_hits + st.encode_reuse_misses}, donated {st.donated}, "
                  f"launches {launches} on {card}")
            return b, st

        # 1. The bench pair, chained, 5120 nodes.
        b_cold, cold = drain("cold, 5120 nodes", wp, wave_size=256)
        captures_cold = list(wp.executables.capture_seconds())
        b_warm, warm = drain("warm, 5120 nodes", wp, wave_size=256)
        for label, b, st in (("cold", b_cold, cold), ("warm", b_warm, warm)):
            check(b == chained and list(b) == list(chained),
                  f"warm[{label}]: bindings differ from phase 4's chained drain")
            check(st.waves == chained_stats.waves and st.admitted == len(gangs),
                  f"warm[{label}]: {st.admitted}/{len(gangs)} admitted in {st.waves} waves")
        check(np.array_equal(cold.free_after, warm.free_after)
              and np.array_equal(cold.free_after, chained_stats.free_after),
              "warm: free_after differs between the cold, the warm and phase 4's drain")
        check(cold.lowerings == cold.exec_cache_misses == n_keys,
              f"warm[cold]: {cold.lowerings} lowerings, {cold.exec_cache_misses} misses for "
              f"{n_keys} distinct (shape, pad)")
        check(warm.lowerings == 0 and warm.exec_cache_misses == 0
              and warm.exec_cache_hits == warm.waves + n_keys,
              f"warm[warm]: {warm.lowerings} lowerings, {warm.exec_cache_misses} misses, "
              f"{warm.exec_cache_hits} hits (expected {warm.waves + n_keys})")
        check(warm.encode_reuse_hits == len(gangs) and warm.encode_reuse_misses == 0
              and warm.donated, f"warm[warm]: encode reuse {warm.encode_reuse_hits}/"
              f"{warm.encode_reuse_misses}, donated {warm.donated}")
        print(f"warm[capture]: {len(captures_cold)} entries, ms per capture "
              f"{[round(1e3 * x, 3) for x in captures_cold]}; cold drain compile_s "
              f"{cold.compile_s:.4f} beside its drain_s {cold.total_s:.4f}, warm encode_s "
              f"{warm.encode_s:.4f} against cold {cold.encode_s:.4f} on {card}")

        # 2. A replay against a direct launch and the plain version, tolerance
        # 0: the first wave through the drain's entry (donated key), then the
        # same entry on the non-dyadic snapshot.
        cache = wp.executables
        t_len = len(gangs)
        for label, fleet, want in (("bench wave 0", snap, plain_wave0),
                                   ("bench wave 0 on non-dyadic free", snap_nd, None)):
            tb = batch_to(encode_wave(planned[0], fleet), dev)
            free = torch.as_tensor(fleet.free, dtype=torch.float32, device=dev)
            node = (torch.as_tensor(fleet.capacity, device=dev),
                    torch.as_tensor(fleet.schedulable, device=dev),
                    torch.as_tensor(fleet.node_domain_id, device=dev))
            dom = domains if fleet is snap else domain_index(fleet.node_domain_id, dev)
            okg = torch.zeros(t_len, dtype=torch.bool, device=dev)
            lowerings = cache.lowerings
            got = cache.solve(free, *node, tb, params, okg, donate=True, device=dev,
                              domains=dom)
            direct = place_wave(free.clone(), *node, tb, params, okg.clone(), domains=dom)
            torch.cuda.synchronize()
            check(cache.lowerings == lowerings, f"warm[{label}]: the replay prepared an entry")
            for nm, a, b in zip(NAMES, got, direct):
                check(torch.equal(a, b), f"warm[{label}]: replay != direct launch on {nm}")
            if want is not None:
                for nm, a, b in zip(NAMES, got, want):
                    check(torch.equal(a, b), f"warm[{label}]: replay != plain on {nm}")
            print(f"warm[{label}]: replay == direct launch"
                  + (" == plain version" if want is not None else "")
                  + f" on {', '.join(NAMES)}, tolerance 0")

        # The 7 waves chained through one carry, every wave enqueued before
        # any is read (several waves of one entry in flight): direct launches
        # against replays, per-wave dispatch (host seconds to enqueue) and
        # every wave's planes and the final carry compared bit for bit; the
        # direct chain decodes to phase 4's bindings.
        waves = [encode_gangs_wave(ws) for ws in planned]
        node = tuple(torch.as_tensor(x, device=dev)
                     for x in (snap.capacity, snap.schedulable, snap.node_domain_id))
        dispatch, outs = {}, {}
        for mode in ("direct", "replay", "direct", "replay"):
            free = torch.as_tensor(snap.free, dtype=torch.float32, device=dev)
            okg = torch.zeros(t_len, dtype=torch.bool, device=dev)
            tbs = [batch_to(b, dev) for b, _ in waves]
            torch.cuda.synchronize()
            times, planes = [], []
            for tb in tbs:
                t0 = time.perf_counter()
                if mode == "direct":
                    out = place_wave(free, *node, tb, params, okg, domains=domains)
                else:
                    out = cache.solve(free, *node, tb, params, okg, donate=True, device=dev,
                                      domains=domains)
                    free, okg = out.free_after, out.ok_global
                times.append(time.perf_counter() - t0)
                planes.append(out[:3])
            torch.cuda.synchronize()
            dispatch[mode], outs[mode] = times, (planes, free, okg)
        (d_planes, d_free, d_okg), (r_planes, r_free, r_okg) = outs["direct"], outs["replay"]
        for w, (a, b) in enumerate(zip(d_planes, r_planes)):
            for nm, x, y in zip(NAMES, a, b):
                check(torch.equal(x, y), f"warm[chain]: wave {w} {nm}: replay != direct")
        check(torch.equal(d_free, r_free) and torch.equal(d_okg, r_okg),
              "warm[chain]: the final carry differs between replays and direct launches")
        direct_bindings = {}
        for (_, decode), (asg, ok, _) in zip(waves, d_planes):
            direct_bindings.update(decode_bindings(ok.cpu().numpy(), asg.cpu().numpy(), decode,
                                                   snap))
        check(direct_bindings == chained,
              "warm[chain]: the direct launches' bindings differ from the cached drain's")
        print(f"warm[chain of {len(waves)} waves]: replays == direct launches on every wave's "
              f"assigned, ok, placement_score and the final free and ok_global; the direct "
              f"chain binds what the cached drain bound")
        print(f"warm[dispatch per wave]: direct ms {[round(1e3 * x, 4) for x in dispatch['direct']]}"
              f" (sum {1e3 * sum(dispatch['direct']):.4f}); replay ms "
              f"{[round(1e3 * x, 4) for x in dispatch['replay']]} (sum "
              f"{1e3 * sum(dispatch['replay']):.4f}) on {card}")

        # The spread backlog of phase 3 (a quarter of its sets spread across
        # zones), its 8 waves chained twice through one fresh cache against
        # direct launches. Waves 0 and 1 share an entry and both carry
        # spread planes, and every entry replays again in the second round:
        # a replay that did not zero the family rows its entry's last replay
        # marked would differ.
        gangs_sp, pods_sp = spread_backlog
        gidx_sp = {g.name: i for i, g in enumerate(gangs_sp)}
        sp_plan = plan_waves(gangs_sp, 256)
        sp_tbs = [batch_to(encode_wave(ws, snap, pods=pods_sp, gidx=gidx_sp), dev)
                  for ws in sp_plan]
        check(sp_plan[0][1:] == sp_plan[1][1:] and all(
            tb.spread_level is not None and bool((tb.spread_level >= 0).any())
            for tb in sp_tbs[:2]), "warm[spread]: waves 0 and 1 do not share a spread key")
        sp_cache = ExecutableCache()

        def sp_chain(solve_one):
            free = torch.as_tensor(snap.free, dtype=torch.float32, device=dev)
            okg = torch.zeros(len(gangs_sp), dtype=torch.bool, device=dev)
            planes = []
            for tb in sp_tbs:
                out = solve_one(free, tb, okg)
                free, okg = out[3], out[4]
                planes.append(out[:3])
            return planes, free, okg

        sp_direct = sp_chain(lambda f, tb, o: place_wave(f, *node, tb, params, o,
                                                         domains=domains))
        for rnd in (1, 2):
            sp_replay = sp_chain(lambda f, tb, o: sp_cache.solve(
                f, *node, tb, params, o, device=dev, domains=domains))
            for w, (a, b) in enumerate(zip(sp_direct[0], sp_replay[0])):
                for nm, x, y in zip(NAMES, a, b):
                    check(torch.equal(x, y),
                          f"warm[spread, round {rnd}]: wave {w} {nm}: replay != direct launch")
            check(torch.equal(sp_direct[1], sp_replay[1]) and torch.equal(sp_direct[2],
                                                                          sp_replay[2]),
                  f"warm[spread, round {rnd}]: the final carry differs from direct launches")
        sp_keys = len({(ws[1:], tb.spread_level is not None) for ws, tb in zip(sp_plan, sp_tbs)})
        check(sp_cache.lowerings == sp_keys
              and sp_cache.hits == 2 * len(sp_plan) - sp_keys,
              f"warm[spread]: {sp_cache.lowerings} lowerings, {sp_cache.hits} hits for "
              f"{len(sp_plan)} waves x 2 over {sp_keys} keys")
        print(f"warm[spread, {len(sp_plan)} waves x 2 rounds, {sp_keys} entries]: replays == "
              f"direct launches on every wave's assigned, ok, placement_score and the final "
              f"free and ok_global, tolerance 0")

        # 3. The scan drain at wave_size 32 (B4 entries, chunks padded with
        # null waves) and the 20480-node pruned chained drain, cold then warm.
        runs32 = [len(r) for r in class_runs(plan_waves(gangs, 32))]
        padded = sorted({p for n in runs32 for _, _, p in scan_chunks(n, ScanConfig()) if p})
        wp32 = WarmPath()
        for label in ("cold", "warm"):
            b, st = drain(f"scan, wave_size 32, {label}", wp32, wave_size=32, harvest="scan")
            check(b == chained32 and list(b) == list(chained32),
                  f"warm[scan 32, {label}]: bindings differ from phase 8's chained drain")
            check(label == "cold" or (st.lowerings == 0 and st.exec_cache_misses == 0),
                  f"warm[scan 32, warm]: {st.lowerings} lowerings")
        lens = sorted({dict(k[6])["gang_valid"][0] for k in wp32.executables._entries
                       if k[2] is not None})
        check(lens == padded == [8, 16], f"warm[scan 32]: scan entries of lengths {lens}, "
                                         f"expected {padded} (runs {runs32})")
        wp4 = WarmPath()
        for label in ("cold", "warm"):
            b, st = drain(f"20480 nodes, pruned, {label}", wp4, fleet=snap_4, wave_size=256,
                          pruning=pruning)
            check(b == pruned_chained_4 and list(b) == list(pruned_chained_4),
                  f"warm[20480 pruned, {label}]: bindings differ from phase 5's pruned drain")
            check(label == "cold" or (st.lowerings == 0 and st.exec_cache_misses == 0),
                  f"warm[20480 pruned, warm]: {st.lowerings} lowerings")

        # 4. Prewarm: a fresh WarmPath prepares every recorded shape from the
        # history file, then drains with no preparation.
        with open(wp.executables.history_path) as f:
            recorded = len(json.load(f)["shapes"])
        fresh = WarmPath()
        fresh.executables.history_path = wp.executables.history_path
        t0 = time.perf_counter()
        prepared = fresh.executables.prewarm_from_history(top_k=64)
        prewarm_s = time.perf_counter() - t0
        check(prepared == fresh.executables.prewarmed == recorded,
              f"warm[prewarm]: {prepared} prepared, {recorded} recorded")
        b, st = drain("prewarmed", fresh, wave_size=256)
        check(b == chained and st.lowerings == 0,
              f"warm[prewarmed]: {st.lowerings} lowerings, bindings equal {b == chained}")
        print(f"warm[prewarm]: {prepared} of {recorded} recorded shapes in {prewarm_s:.4f} s, "
              f"then a drain with 0 lowerings on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def time_variant(place_wave, timed, node, tb, okg, params, domains, extra, plain):
    """(kernel ms per launch, plain ms or None) at one wave's shape: one
    warm-up launch, then the mean of three, each on a fresh copy of the
    carry (the kernel updates it in place)."""
    import torch

    free, rest = node[0], node[1:]
    copies = [free.clone() for _ in range(4)]
    place_wave(copies[0], *rest, tb, params, okg.clone(), domains=domains, **extra)
    okgs = [okg.clone() for _ in copies[1:]]

    def run():
        for f, o in zip(copies[1:], okgs):
            place_wave(f, *rest, tb, params, o, domains=domains, **extra)

    _, ms = timed(run)
    plain_ms = None
    if plain is not None:
        torch.cuda.synchronize()
        _, plain_ms = timed(plain)
    return ms / len(okgs), plain_ms


def portfolio_phase(dev, card, timed, compare, node_tensors, snap, batch, domains,
                    t_len) -> dict:
    """Phase 7's checks and times on one wave (the bench's first, 5120
    nodes); returns the kernels line's numbers for the K = 4 select."""
    import ctypes

    import numpy as np
    import torch

    from grove_tpu_torch.kernels import build
    from grove_tpu_torch.kernels.place_wave import (
        PlaceWaveArgs,
        build_args,
        place_wave,
        place_wave_stacked,
    )
    from grove_tpu_torch.parallel.portfolio import params_population
    from grove_tpu_torch.solver.core import batch_to, stack_on
    from grove_tpu_torch.solver.reference import (
        params_row,
        portfolio_select_ref,
        stacked_solve_ref,
    )

    tb = batch_to(batch, dev)
    n, r = snap.capacity.shape
    okg0 = torch.zeros(t_len, dtype=torch.bool, device=dev)
    rest = node_tensors(snap)[1:]
    err = 0.0

    def stacked(pstack, select, free=None, okg=None):
        free = node_tensors(snap)[0] if free is None else free
        okg = okg0.clone() if okg is None else okg
        return place_wave_stacked(free, *rest, tb, pstack, okg, domains=domains, select=select)

    # Every row equals a single launch under that row, bit for bit.
    stacks = {k: stack_on(params_population(k), dev) for k in (1, 4, 8)}
    rows4 = None
    for k in (4, 8):
        rows = stacked(stacks[k], False)
        for j in range(k):
            single = place_wave(node_tensors(snap)[0], *rest, tb, params_row(stacks[k][j]),
                                okg0.clone(), domains=domains)
            torch.cuda.synchronize()
            err = max(err, compare(f"portfolio K={k}, row {j} vs a single launch",
                                   single[:4], [x[j] for x in rows]))
        rows4 = rows if k == 4 else rows4
        print(f"portfolio[K={k}, G={tb.gang_valid.shape[0]}, N={n}]: every row == a single "
              f"place_wave launch under its weights; admitted per row "
              f"{rows[1].sum(dim=1).tolist()}")
    # The plain portfolio (every row, then the select) against the kernel.
    free_k, okg_k = node_tensors(snap)[0], okg0.clone()
    got = stacked(stacks[4], True, free_k, okg_k)
    torch.cuda.synchronize()

    def plain():
        rows_p = stacked_solve_ref(node_tensors(snap)[0], *rest, tb, stacks[4], okg0)
        return rows_p, portfolio_select_ref(*rows_p, tb, okg0.clone())

    (rows_p, want), plain_ms = timed(plain)
    for j in range(4):  # odd rows worst-fit
        err = max(err, compare(f"portfolio K=4, row {j} vs plain", [x[j] for x in rows4],
                               [x[j] for x in rows_p]))
    err = max(err, compare("portfolio K=4 select vs plain", got[:5], want[:5]))
    check(torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]),
          f"portfolio: winner {int(got[5])} / objectives {got[6].tolist()} != plain "
          f"{int(want[5])} / {want[6].tolist()}")
    print(f"portfolio[K=4 select]: winner {int(got[5])}, objectives {got[6].tolist()} — "
          f"kernel == plain on rows, winner, objectives, its rows, the chained carry and "
          f"ok_global; plain {plain_ms:.1f} ms")
    runs = [[x.clone() for x in stacked(stacks[4], True)] for _ in range(20)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        compare("portfolio K=4 select, 20 launches", run, runs[0])
    print("portfolio[K=4 select, 20 launches]: every launch equal")

    def launch_ms(fn, reps=3):
        """ms per launch of fn(free, okg): a warm-up, then the mean of
        `reps`, each on its own copy of the carry made before the clock
        starts."""
        copies = [(node_tensors(snap)[0], okg0.clone()) for _ in range(reps + 1)]
        fn(*copies[0])
        _, ms = timed(lambda: [fn(*c) for c in copies[1:]])
        return ms / reps

    ms = {"single": launch_ms(lambda f, o: place_wave(f, *rest, tb, params_row(stacks[1][0]), o,
                                                      domains=domains))}
    for k in (1, 4, 8):
        ms[f"K={k}"] = launch_ms(lambda f, o: stacked(stacks[k], False, f, o))
    ms["K=4 select"] = launch_ms(lambda f, o: stacked(stacks[4], True, f, o))
    args, smem, _out, keep = build_args(node_tensors(snap)[0], *rest, tb, None, okg0.clone(),
                                        domains, params_stack=stacks[4], select=True)
    lib = build.load("place_wave")
    stream = torch.cuda.current_stream().cuda_stream
    for fn, extra in ((lib.place_wave_stacked_launch, [ctypes.c_int, ctypes.c_int]),
                      (lib.place_wave_select_launch, [])):
        fn.argtypes = [ctypes.POINTER(PlaceWaveArgs), ctypes.c_void_p] + extra
        fn.restype = ctypes.c_int
    check(lib.place_wave_stacked_launch(ctypes.byref(args), stream, smem, 1) == 0,
          "portfolio: stacked launch failed")
    ms["select alone"] = launch_ms(
        lambda f, o: check(lib.place_wave_select_launch(ctypes.byref(args), stream) == 0,
                           "portfolio: select launch failed"), reps=20)
    print("timing[portfolio, bench wave 0, N=%d]: " % n + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items()) + f" on {card}")
    # Bound: place_wave's work for every row under its own verdicts, plus
    # each row's copy of the carry (read and written once).
    okg_np = np.zeros(t_len, bool)
    work = [place_wave_work(batch, snap.node_domain_id, r, okg_np, rows4[1][j].cpu().numpy())
            for j in range(4)]
    nbytes = sum(w[0] for w in work) + 4 * 2 * 4 * n * r
    bound = bound_of(nbytes, sum(w[1] for w in work))
    return {"err": err, "ms": ms["K=4 select"], "plain_ms": plain_ms, "bound": bound}


def scan_phase(dev, card, timed, node_tensors, encode_wave, snap, gangs, pods, chained, domains,
               snap_4, pruned_chained_4, pruning, wave_ms) -> dict:
    """Phase 8's drains, checks and times (the 5120-node fleet `snap`, the
    20480-node `snap_4`); returns the kernels line's two scan rows."""
    import math

    import numpy as np
    import torch

    from grove_tpu_torch.bench import admitted_free
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches
    from grove_tpu_torch.solver.core import SolverParams, batch_to, scan_pruned_solve, scan_solve
    from grove_tpu_torch.solver.drain import HARVEST_MODES, class_runs, drain_backlog, plan_waves
    from grove_tpu_torch.solver.encode import stack_batches
    from grove_tpu_torch.solver.pruning import plan_candidates, stack_plans
    from grove_tpu_torch.solver.reference import scan_pruned_solve_ref, scan_solve_ref

    params = SolverParams()
    t_len, r = len(gangs), snap.capacity.shape[1]
    okg0 = torch.zeros(t_len, dtype=torch.bool, device=dev)

    def drain(fleet, ws, harvest, cfg=None):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        b, st = drain_backlog(gangs, pods, fleet, wave_size=ws, params=params, harvest=harvest,
                              pruning=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(place_wave.variant_launches)
        n = fleet.capacity.shape[0]
        label = f"scan[{n} nodes, wave_size {ws}, {harvest}{', pruned' if cfg else ''}]"
        check(st.admitted == len(gangs), f"{label}: admitted {st.admitted}/{len(gangs)}")
        free = admitted_free(b, pods, fleet)
        check(np.array_equal(st.free_after, free) and bool((free >= 0).all()),
              f"{label}: free_after != snapshot free minus bound pods' requests")
        # The ledger of the discipline: one dispatch per wave, or per chunk
        # of a run of >= 2 same-shape waves (max 32) plus its short runs.
        planned = plan_waves(gangs, ws)
        runs = [len(x) for x in class_runs(planned)]
        chunks = unfused = 0
        for n_run in runs:
            for k in range(0, n_run, 32):
                part = min(32, n_run - k)
                chunks, unfused = (chunks + 1, unfused) if part >= 2 else (chunks, unfused + part)
        fused = harvest in ("scan", "resident")
        want_disp = (chunks + unfused if fused else len(planned)) + st.escalations
        want_rt = 1 + st.escalations if harvest in ("chained", "resident") else want_disp
        got = (st.dispatches, st.device_roundtrips)
        check(got == (want_disp, want_rt) or (st.escalations_adopted and got >= (want_disp, 1)),
              f"{label}: dispatches {st.dispatches} / round trips {st.device_roundtrips}, "
              f"expected {want_disp} / {want_rt} (runs {runs})")
        kind = "scan_pruned" if cfg else "scan"
        check(launches[kind] == st.scan_chunks + st.scan_rechains
              and st.scan_chunks == (chunks if fused else 0)
              and sum(launches.values()) == st.dispatches,
              f"{label}: launches {launches} for {st.scan_chunks} chunks, {st.dispatches} "
              f"dispatches")
        pct = st.latency_percentiles()
        print(f"{label}: wall {wall:.4f} s, drain_s {st.total_s:.4f} (encode {st.encode_s:.4f}, "
              f"prune {st.prune_s:.4f}, dispatch {st.dispatch_s:.4f}, harvest "
              f"{st.harvest_s:.4f}, decode {st.decode_s:.4f}, bind {st.bind_s:.4f}), waves "
              f"{st.waves} in runs {runs}, dispatches {st.dispatches}, round trips "
              f"{st.device_roundtrips}, chunks {st.scan_chunks} ({st.scanned_waves} waves), "
              f"escalations {st.escalations}, launches {launches}"
              + (f", wave_p50_s {pct[50.0]:.4f} wave_p99_s {pct[99.0]:.4f}" if pct else "")
              + f" on {card}")
        return b, st, launches

    runs256 = {}
    for harvest in HARVEST_MODES:
        b, st, launches = drain(snap, 256, harvest)
        check(b == chained and list(b) == list(chained),
              f"scan[{harvest}]: bindings differ from the chained drain's")
        runs256[harvest] = (st, launches)
    pct = runs256["wave"][0].latency_percentiles()
    print(f"harvest[wave, {snap.capacity.shape[0]} nodes]: wave_p50_s {pct[50.0]:.6f} wave_p99_s {pct[99.0]:.6f} "
          f"over {runs256['wave'][0].waves} waves (chained: p50 = p99 = drain_s "
          f"{runs256['chained'][0].total_s:.6f}) on {card}")
    chained32, _, _ = drain(snap, 32, "chained")
    b32, st32, launches32 = drain(snap, 32, "scan")
    check(b32 == chained32 and list(b32) == list(chained32),
          "scan[wave_size 32]: bindings differ from the chained drain's at that wave size")
    b_p, st_p, launches_p = drain(snap_4, 256, "scan", pruning)
    check(b_p == pruned_chained_4 and list(b_p) == list(pruned_chained_4),
          "scan[20480 nodes, pruned]: bindings differ from the pruned chained drain's")
    check(st_p.pruned_waves == st_p.waves, "scan[20480 nodes, pruned]: a wave did not prune")

    def exact(label, got, want):
        for nm, a, b in zip(("assigned", "ok", "placement_score", "free_in", "okg_in",
                             "free_after", "ok_global"), got, want):
            check(torch.equal(a, b), f"scan[{label}]: kernel != plain on {nm} at "
                                     f"{torch.nonzero(a != b)[:8].tolist()}")

    def per_call_ms(fn, reps=3):
        """ms per call of fn(free, okg), each on its own carry copy, after a
        warm-up."""
        copies = [(fresh_free(), okg0.clone()) for _ in range(reps + 1)]
        fn(*copies[0])
        _, ms = timed(lambda: [fn(*c) for c in copies[1:]])
        return ms / reps

    rows = {}
    # The first chunk of the dense scan drain at each wave size.
    cap, sched, ndid = node_tensors(snap)[1:]
    for ws in (256, 32):
        chunk = next(class_runs(plan_waves(gangs, ws)))[:32]
        steps = [encode_wave(w) for w in chunk]
        tb = batch_to(stack_batches(steps), dev)
        label = f"{len(steps)}-wave chunk, wave_size {ws}, {snap.capacity.shape[0]} nodes"
        fresh_free = lambda: node_tensors(snap)[0]  # noqa: E731
        got = scan_solve(fresh_free(), cap, sched, ndid, tb, params, okg0.clone(), retain=True,
                         device=dev, domains=domains)
        torch.cuda.synchronize()
        want, plain_ms = timed(lambda: scan_solve_ref(fresh_free(), cap, sched, ndid, tb, params,
                                                      okg0.clone(), True))
        exact(label, got, want)
        singles = []
        for w, b in enumerate(steps):
            one = place_wave(want[3][w].clone(), cap, sched, ndid, batch_to(b, dev), params,
                             want[4][w].clone(), domains=domains)
            nxt = (want[5], want[6]) if w == len(steps) - 1 else (want[3][w + 1], want[4][w + 1])
            for nm, a, c in zip(("assigned", "ok", "placement_score", "free_after", "ok_global"),
                                one, (want[0][w], want[1][w], want[2][w]) + nxt):
                check(torch.equal(a, c), f"scan[{label}]: step {w} {nm} != a single launch")
            singles.append(batch_to(b, dev))
        scan_ms = per_call_ms(lambda f, o: scan_solve(f, cap, sched, ndid, tb, params, o,
                                                      retain=True, device=dev, domains=domains))
        single_ms = per_call_ms(lambda f, o: [place_wave(f, cap, sched, ndid, b, params, o,
                                                         domains=domains) for b in singles])
        work = [place_wave_work(s, snap.node_domain_id, r, want[4][w].cpu().numpy(),
                                want[1][w].cpu().numpy()) for w, s in enumerate(steps)]
        nbytes = sum(x[0] for x in work) + len(steps) * (4 * snap.capacity.size + t_len)
        bound = bound_of(nbytes, sum(x[1] for x in work))
        print(f"scan[{label}]: kernel == plain on every output, every step == a single "
              f"place_wave launch on its entering carry; scan launch {scan_ms:.3f} ms, its "
              f"steps as single launches {single_ms:.3f} ms ({scan_ms / single_ms:.4f}x), "
              f"plain {plain_ms:.1f} ms, bound {bound[0]:.6f} ms ({bound[1]}) on {card}")
        rows[ws] = {"ms": scan_ms, "plain_ms": plain_ms, "bound": bound, "single_ms": single_ms}

    # A pruned chunk at 20480 nodes: the first run of the pruned scan drain.
    chunk = next(class_runs(plan_waves(gangs, 256)))
    steps = [encode_wave(w, snap_4) for w in chunk]
    plans = [plan_candidates(snap_4, b, pruning) for b in steps]
    check(all(p is not None for p in plans), "scan[pruned chunk]: a wave did not prune")
    sp = stack_plans(plans, steps, dev)
    fresh_free = lambda: node_tensors(snap_4)[0]  # noqa: E731
    pargs = (sp.cand_idx, sp.capacity, sp.schedulable, sp.node_domain_id, sp.batch, params)
    label = f"{len(steps)}-wave pruned chunk, {snap_4.capacity.shape[0]} nodes"
    got = scan_pruned_solve(fresh_free(), *pargs, okg0.clone(), retain=True, device=dev,
                            domains=sp.domains)
    torch.cuda.synchronize()
    want, pplain_ms = timed(lambda: scan_pruned_solve_ref(fresh_free(), *pargs, okg0.clone(),
                                                          True))
    exact(label, got, want)
    singles = []
    for w, (b, plan) in enumerate(zip(steps, plans)):
        pt = plan.tensors(dev)
        pb = batch_to(plan.gather_batch(b), dev)
        single = (pt.capacity, pt.schedulable, pt.node_domain_id, pb,
                  {"domains": pt.domains, "cand_idx": pt.cand_idx, "cand_count": plan.count})
        one = place_wave(want[3][w].clone(), *single[:4], params, want[4][w].clone(), **single[4])
        nxt = (want[5], want[6]) if w == len(steps) - 1 else (want[3][w + 1], want[4][w + 1])
        for nm, a, c in zip(("assigned", "ok", "placement_score", "free_after", "ok_global"),
                            one, (want[0][w], want[1][w], want[2][w]) + nxt):
            check(torch.equal(a, c), f"scan[{label}]: step {w} {nm} != a single launch")
        singles.append(single)
    pscan_ms = per_call_ms(lambda f, o: scan_pruned_solve(f, *pargs, o, retain=True, device=dev,
                                                          domains=sp.domains))
    psingle_ms = per_call_ms(lambda f, o: [place_wave(f, *x[:4], params, o, **x[4])
                                           for x in singles])
    work = [place_wave_work(plan.gather_batch(b), plan.node_domain_id, r,
                            want[4][w].cpu().numpy(), want[1][w].cpu().numpy(),
                            carry_bytes=b3_bytes(plan.pad, plan.count, r))
            for w, (b, plan) in enumerate(zip(steps, plans))]
    nbytes = sum(x[0] for x in work) + len(steps) * (4 * snap_4.capacity.size + t_len)
    pbound = bound_of(nbytes, sum(x[1] for x in work))
    print(f"scan[{label}]: kernel == plain on every output (assigned in fleet ordinals, "
          f"free_in fleet-shaped), every step == a single pruned launch; scan launch "
          f"{pscan_ms:.3f} ms, its steps as single launches {psingle_ms:.3f} ms "
          f"({pscan_ms / psingle_ms:.4f}x), plain {pplain_ms:.1f} ms, bound {pbound[0]:.6f} ms "
          f"({pbound[1]}) on {card}")

    # Kernel ms per drain: each drain's dispatch units (chunks and short
    # runs) launched in order on one carry, against phase 4's per-wave sum.
    for ws in (256, 32):
        free_k, okg_k = node_tensors(snap)[0], okg0.clone()
        total = 0.0
        for run in class_runs(plan_waves(gangs, ws)):
            for k in range(0, len(run), 32):
                part = [encode_wave(w) for w in run[k : k + 32]]
                if len(part) >= 2:
                    tb = batch_to(stack_batches(part), dev)
                    total += timed(lambda: scan_solve(free_k, cap, sched, ndid, tb, params, okg_k,
                                                      device=dev, domains=domains))[1]
                else:
                    tb = batch_to(part[0], dev)
                    total += timed(lambda: place_wave(free_k, cap, sched, ndid, tb, params,
                                                      okg_k, domains=domains))[1]
        print(f"scan kernels per drain[wave_size {ws}, {snap.capacity.shape[0]} nodes]: "
              f"{total:.3f} ms "
              + (f"(per-wave launches, phase 4: {sum(wave_ms):.3f} ms) " if ws == 256 else "")
              + f"on {card}")
        rows[ws]["per_drain_ms"] = total
    check(math.isfinite(rows[256]["per_drain_ms"]), "scan: no kernel time per drain")
    src = "grove_tpu_torch/kernels/csrc/place_wave.cu"
    return {"chained32": chained32, "rows": [
        {"name": "place_wave_scan(B4, dense)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:790", "launches": runs256["scan"][1]["scan"],
         "max_abs_err": 0.0, "ms": rows[256]["ms"], "plain_ms": rows[256]["plain_ms"],
         "bound_ms": rows[256]["bound"][0], "bound_by": rows[256]["bound"][1],
         "library_ms": None},
        {"name": "place_wave_scan(B4, pruned)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:873", "launches": launches_p["scan_pruned"],
         "max_abs_err": 0.0, "ms": pscan_ms, "plain_ms": pplain_ms, "bound_ms": pbound[0],
         "bound_by": pbound[1], "library_ms": None},
    ]}


def sweep_case(dev, snap, gangs, pods, wave_size=32):
    """B6's inputs at a cut depth, on the card: the first three waves of the
    first run of the backlog at wave_size 32, cut to 64 gangs (22, 21, 21) in waves of 32
    slots, encoded as a journal's waves are (earlier admissions resolved on
    the host), each from its own entering free (a
    seeded quarter of the nodes at half their free capacity, a different
    quarter each wave), then a null wave (zero free, all-invalid batch);
    K = 2, the first two rows of the sweep's default grid. Returns the
    arguments of stacked_scan_solve (free_stack, capacity, schedulable,
    node_domain_id, stacked_batch, params_stack)."""
    import numpy as np
    import torch

    from grove_tpu_torch.solver.core import SolverParams, batch_to
    from grove_tpu_torch.solver.drain import class_runs, plan_waves
    from grove_tpu_torch.solver.encode import GangBatch, encode_gangs, stack_batches
    from grove_tpu_torch.tuning import SweepConfig, default_grid

    rng = np.random.default_rng(6)
    steps, frees = [], []
    run = next(r for r in class_runs(plan_waves(gangs, wave_size)) if len(r) >= 3)
    for cut, (wave, (mg, ms, mp), pad) in zip((22, 21, 21), run):
        batch, _ = encode_gangs(wave[:cut], pods, snap, max_groups=mg, max_sets=ms,
                                max_pods=mp, pad_gangs_to=pad)
        steps.append(batch)
        free = np.array(snap.free, dtype=np.float32)
        half = rng.random(free.shape[0]) < 0.25
        free[half] *= np.float32(0.5)
        frees.append(free)
    steps.append(GangBatch(*(None if x is None else np.zeros_like(x) for x in steps[0])))
    frees.append(np.zeros_like(frees[0]))
    grid = default_grid(SweepConfig("incumbent", tuple(SolverParams())), 2)
    pstack = np.asarray([c.weights for c in grid], dtype=np.float32)
    return (
        torch.as_tensor(np.stack(frees), device=dev),
        torch.as_tensor(snap.capacity, device=dev),
        torch.as_tensor(snap.schedulable, device=dev),
        torch.as_tensor(snap.node_domain_id, device=dev),
        batch_to(stack_batches(steps), dev),
        torch.as_tensor(pstack, device=dev),
    )


def sweep_phase(dev, card, timed, snap, gangs, pods, chained32, snap_4, pruned_chained_4,
                pruning, b6_case, b6_plain) -> dict:
    """Phase 9: record, replay and sweep on the card (the 5120-node fleet
    `snap`, the 20480-node `snap_4`); B6 against its plain version on
    `b6_case` (whose plain outputs and time, `b6_plain`, were taken while
    nvcc built); returns the kernels line's B6 row."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from grove_tpu_torch.bench import record_drain
    from grove_tpu_torch.kernels.place_wave import domain_index, place_wave, reset_launches
    from grove_tpu_torch.solver.core import SolverParams, stacked_scan_solve, stacked_solve_batch
    from grove_tpu_torch.solver.warm import ExecutableCache
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.solver.encode import GangBatch
    from grove_tpu_torch.solver.reference import params_row, stacked_scan_solve_ref
    from grove_tpu_torch.trace.recorder import journal_stats, read_journal
    from grove_tpu_torch.trace.replay import replay_journal
    from grove_tpu_torch.tuning import default_grid, incumbent_config, sweep_journal

    params = SolverParams()
    n, r = snap.capacity.shape
    root = tempfile.mkdtemp(prefix="chip-smoke-journal-")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def admitted_of(records):
        return sum(1 for w in records if w.get("kind") == "wave" for v in w["ok"].values() if v)

    def replay(label, records):
        reset_launches()
        rep, s = wall(lambda: replay_journal(records))
        waves = sum(1 for x in records if x.get("kind") == "wave")
        check(len(rep.waves) == waves and rep.divergence_count == 0,
              f"sweep[{label}]: replay of {waves} waves: {rep.divergence_count} divergences")
        print(f"replay[{label}]: {waves} waves, 0 divergences, wall {s:.4f} s, launches "
              f"{dict(place_wave.variant_launches)} on {card}")
        return s

    # The sweep's B6 launches go through its warm path's launch cache; the
    # comparisons and times below launch B6 directly (real_b6).
    captured = []
    real_b6 = stacked_scan_solve
    cached_b6 = ExecutableCache.solve_scan_stacked

    def capture(cache, *args, **kw):
        out = cached_b6(cache, *args, **kw)
        captured.append((args, kw, out))
        return out

    def sweep(label, records, k):
        """One sweep with the counts set to 0 before it; the incumbent row
        must reproduce the journal."""
        captured.clear()
        grid = default_grid(incumbent_config(records), k)
        reset_launches()
        ExecutableCache.solve_scan_stacked = capture
        try:
            engine, s = wall(lambda: sweep_journal(records, grid))
        finally:
            ExecutableCache.solve_scan_stacked = cached_b6
        launches = dict(place_wave.variant_launches)
        inc = engine.tallies["incumbent"]
        check(inc.divergences == 0 and inc.admitted == admitted_of(records),
              f"sweep[{label}, K={k}]: incumbent {inc.divergences} divergences, admitted "
              f"{inc.admitted} / {admitted_of(records)} in the journal")
        check(launches["stacked_scan"] == engine.scan_stacked_solves
              and launches["stacked"] == engine.stacked_solves,
              f"sweep[{label}, K={k}]: launches {launches} for {engine.to_doc()}")
        doc = engine.to_doc()
        print(f"sweep[{label}, K={k}]: wall {s:.4f} s, waves {doc['waves']}, stackedSolves "
              f"{doc['stackedSolves']}, scanStackedSolves {doc['scanStackedSolves']}, "
              f"fallbackSolves {doc['fallbackSolves']}, incumbent 0 divergences, admitted "
              f"{inc.admitted}; best {doc['configs'][0]['config']['name']} admitted "
              f"{doc['configs'][0]['admitted']}; launches {launches} on {card}")
        return engine, s, launches

    try:
        # ---- record: the scan drain at wave_size 32, journaled by the port -----
        kw = dict(wave_size=32, params=params, harvest="scan")
        _, unrec_s = wall(lambda: drain_backlog(gangs, pods, snap, **kw))
        path = os.path.join(root, "scan32")
        reset_launches()
        b_rec, st_rec, rec, records, rwalls = record_drain(gangs, pods, snap, path, **kw)
        rec_s = rwalls["drain_s"]
        launches = dict(place_wave.variant_launches)
        check(b_rec == chained32 and list(b_rec) == list(chained32),
              "sweep[record]: the recorded drain's bindings differ from the chained drain's")
        check(st_rec.waves == st_rec.journaled_waves == 40 and rec.dropped == 0
              and journal_stats(path)["dropped"] == 0,
              f"sweep[record]: {st_rec.journaled_waves}/{st_rec.waves} waves journaled, "
              f"{rec.dropped} dropped")
        check(launches["scan"] == st_rec.scan_chunks > 0,
              f"sweep[record]: launches {launches} for {st_rec.scan_chunks} chunks")
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        print(f"record[{n} nodes, wave_size 32, scan]: {st_rec.journaled_waves} waves journaled, "
              f"0 dropped, {nbytes} bytes; drain wall {rec_s:.4f} s against {unrec_s:.4f} s "
              f"unrecorded ({rec_s / unrec_s:.4f}x; capture journal_s {st_rec.journal_s:.4f}, "
              f"encode {st_rec.encode_s:.4f}, harvest {st_rec.harvest_s:.4f}), then the "
              f"writer's flush {rwalls['flush_s']:.4f} s and the read back "
              f"{rwalls['read_s']:.4f} s; the chained drain's bindings; launches {launches} "
              f"on {card}")

        # ---- replay, then the sweep at K = 4 and 16 ------------------------------
        replay_s = replay(f"{n} nodes, scan", records)
        walls, b6_rows, sampled, err = {}, None, [], 0.0
        for k in (4, 16):
            engine, walls[k], launches_k = sweep(f"{n} nodes, scan", records, k)
            check(engine.scan_stacked_solves > 0, f"sweep[K={k}]: no B6 launch")
            calls = list(captured)
            # Every B6 launch's rows against B5 launches of its waves, and
            # sampled rows against single launches, bit for bit.
            for ci, (args, bkw, out) in enumerate(calls):
                free_stack, cap, sched, ndid, sbatch, pstack = args
                w_len = free_stack.shape[0]
                pst = torch.as_tensor(pstack, device=dev)
                for w in range(w_len):
                    bw = GangBatch(*(None if x is None else x[w] for x in sbatch))
                    b5 = stacked_solve_batch(free_stack[w], cap, sched, ndid, bw, pst,
                                             domains=bkw["domains"])
                    for nm, a, c in zip(("assigned", "ok", "placement_score"), out, b5):
                        check(torch.equal(a[w], c),
                              f"sweep[K={k}]: B6 launch {ci} wave {w} {nm} != a B5 launch")
                    if w in (0, w_len - 1):
                        for j in (0, pst.shape[0] - 1):
                            one = place_wave(torch.as_tensor(free_stack[w], device=dev), cap_t(cap),
                                             sched_t(sched), ndid_t(ndid), batch_t(bw),
                                             params_row(pst[j]), None, domains=bkw["domains"])
                            for nm, a, c in zip(("assigned", "ok", "placement_score"), out, one):
                                check(torch.equal(a[w, j], c),
                                      f"sweep[K={k}]: B6 row ({w}, {j}) {nm} != a single launch")
            print(f"sweep[K={k}]: {len(calls)} B6 launches (W = "
                  f"{[c[0][0].shape[0] for c in calls]}), every row == a B5 launch of its wave, "
                  f"sampled rows == single place_wave launches")
            if k == 16:
                # Sampled rows of every B6 launch against the plain version
                # on the same card inputs, tolerance 0: the first and last
                # real waves and the last (null, where padded) wave under
                # the first and last weight rows; row (10, 15) of a 16-wave
                # launch is block 175, in the second round of 132.
                for ci, (args, bkw, out) in enumerate(calls):
                    free_stack, cap, sched, ndid, sbatch, pstack = args
                    tb = batch_t(sbatch)
                    w_len, kk = tb.gang_valid.shape[0], pstack.shape[0]
                    real = [w for w in range(w_len) if bool(tb.gang_valid[w].any())]
                    wi = torch.tensor(sorted({0, real[-1], w_len - 1}), device=dev)
                    ki = torch.tensor(sorted({0, kk - 1}), device=dev)
                    sub = (cap_t(free_stack)[wi], cap_t(cap), sched_t(sched), ndid_t(ndid),
                           GangBatch(*(None if x is None else x[wi].contiguous() for x in tb)),
                           cap_t(pstack)[ki])
                    want, p_ms = timed(lambda: stacked_scan_solve_ref(*sub))
                    for nm, a, c in zip(("assigned", "ok", "placement_score"), out, want):
                        got = a[wi][:, ki]
                        check(torch.equal(got, c),
                              f"sweep[K=16]: B6 launch {ci} rows {wi.tolist()} x {ki.tolist()} "
                              f"{nm} != the plain version at "
                              f"{torch.nonzero(got != c)[:8].tolist()}")
                        if got.dtype.is_floating_point and got.numel():
                            err = max(err, float((got - c).abs().max()))
                    sampled.append((w_len * kk, len(wi) * len(ki), p_ms))
                    print(f"exact[B6 vs plain, K=16, launch {ci}, W={w_len}]: rows "
                          f"{wi.tolist()} x {ki.tolist()} == the plain version on assigned, ok, "
                          f"placement_score; plain {p_ms:.1f} ms on {card}")
            # Times: each B6 launch beside its rows as single launches and its
            # waves as B5 launches, all from the same inputs.
            times = []
            for args, bkw, out in calls:
                free_stack, cap, sched, ndid, sbatch, pstack = args
                w_len, kk = free_stack.shape[0], pstack.shape[0]
                fs_t = torch.as_tensor(free_stack, device=dev)
                pst = torch.as_tensor(pstack, device=dev)
                node = (cap_t(cap), sched_t(sched), ndid_t(ndid))
                tb = batch_t(sbatch)
                waves_t = [GangBatch(*(None if x is None else x[w] for x in tb))
                           for w in range(w_len)]
                real_b6(fs_t, *node, tb, pst, device=dev, domains=bkw["domains"])  # warm-up
                _, b6_ms = timed(lambda: real_b6(fs_t, *node, tb, pst, device=dev,
                                                 domains=bkw["domains"]))
                _, b5_ms = timed(lambda: [stacked_solve_batch(fs_t[w], *node, waves_t[w], pst,
                                                              domains=bkw["domains"])
                                          for w in range(w_len)])
                copies = [fs_t[w].clone() for w in range(w_len) for _ in range(kk)]
                rows = [params_row(pst[j]) for j in range(kk)]
                _, single_ms = timed(lambda: [
                    place_wave(copies[w * kk + j], *node, waves_t[w], rows[j], None,
                               domains=bkw["domains"])
                    for w in range(w_len) for j in range(kk)])
                slowest = 0.0
                if len(times) == 0:
                    # The prediction's yardstick: the slowest row of the first
                    # launch as one single launch (each timed alone).
                    for w in range(w_len):
                        for j in range(kk):
                            f1 = fs_t[w].clone()
                            slowest = max(slowest, timed(lambda: place_wave(
                                f1, *node, waves_t[w], rows[j], None,
                                domains=bkw["domains"]))[1])
                    rounds = -(-w_len * kk // torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
                    print(f"timing[sweep B6, K={k}, first launch]: {b6_ms:.3f} ms against "
                          f"{rounds} round(s) x the slowest row as a single launch "
                          f"{slowest:.3f} ms = {rounds * slowest:.3f} ms "
                          f"({b6_ms / (rounds * slowest):.4f}x) on {card}")
                times.append((w_len, b6_ms, b5_ms, single_ms))
                if k == 16 and len(times) == 1:
                    # The kernels line's bound: the first launch's W * K
                    # rows, each under its own verdicts.
                    ok_rows = out[1].cpu().numpy()
                    work = [place_wave_work(GangBatch(*(None if x is None else x[w].cpu().numpy()
                                                        for x in tb)),
                                            ndid, r, np.zeros(1, bool), ok_rows[w, j])
                            for w in range(w_len) for j in range(kk)]
                    main_bound = bound_of(sum(x[0] for x in work), sum(x[1] for x in work))
            print(f"timing[sweep B6, K={k}, {n} nodes]: per launch (W, B6 ms, its waves as B5 "
                  f"launches ms, its W*K rows as single launches ms): "
                  + "; ".join(f"({w}, {a:.3f}, {b:.3f}, {c:.3f})" for w, a, b, c in times)
                  + f" on {card}")
            if k == 16:
                b6_rows = (times, launches_k)

        # ---- B6 against its plain version on the card, at a cut depth -----------
        times, launches16 = b6_rows
        want, plain_ms = b6_plain
        b4 = b6_case[4]
        dom4 = domain_index(snap.node_domain_id, dev)
        real_b6(*b6_case, device=dev, domains=dom4)  # warm-up
        got, cut_ms = timed(lambda: real_b6(*b6_case, device=dev, domains=dom4))
        for nm, a, c in zip(("assigned", "ok", "placement_score"), got, want):
            check(torch.equal(a, c), f"sweep[B6 vs plain]: {nm} differs at "
                                     f"{torch.nonzero(a != c)[:8].tolist()}")
            if a.dtype.is_floating_point:
                err = max(err, float((a - c).abs().max()))
        check(bool(want[1][:3].any()) and not bool(want[1][3].any()),
              "sweep[B6 vs plain]: the null wave admitted, or no real wave did")
        g = b4.gang_valid.shape[1]
        work = []
        for w in range(4):
            bw = GangBatch(*(None if x is None else x[w].cpu().numpy() for x in b4))
            for j in range(2):
                work.append(place_wave_work(bw, snap.node_domain_id, r, np.zeros(1, bool),
                                            want[1][w, j].cpu().numpy()))
        bound = bound_of(sum(x[0] for x in work), sum(x[1] for x in work))
        print(f"exact[B6, 3 waves (64 gangs) + a null wave, {g} slots a wave, K=2, {n} nodes]: "
              f"kernel == plain "
              f"on assigned, ok, placement_score; kernel {cut_ms:.3f} ms, plain {plain_ms:.1f} "
              f"ms, bound {bound[0]:.6f} ms ({bound[1]}) on {card}")

        # ---- the 20480-node pruned drain, and the committed JAX journal ---------
        n4 = snap_4.capacity.shape[0]
        path4 = os.path.join(root, "pruned20480")
        b_p, st_p, rec_p, records_p, rwalls_p = record_drain(
            gangs, pods, snap_4, path4, wave_size=256, params=params, pruning=pruning)
        rec_p_s = rwalls_p["drain_s"]
        check(b_p == pruned_chained_4, "sweep[pruned]: recorded bindings differ from the drain's")
        check(st_p.journaled_waves == st_p.waves == st_p.pruned_waves and rec_p.dropped == 0,
              f"sweep[pruned]: {st_p.journaled_waves}/{st_p.waves} journaled, "
              f"{st_p.pruned_waves} pruned")
        cands = sum(1 for w in records_p if w.get("kind") == "wave" and w.get("candidates"))
        print(f"record[{n4} nodes, pruned, chained]: {st_p.journaled_waves} waves journaled "
              f"({cands} with candidates), drain wall {rec_p_s:.4f} s (capture "
              f"{st_p.journal_s:.4f}), flush {rwalls_p['flush_s']:.4f} s on {card}")
        replay(f"{n4} nodes, pruned", records_p)
        engine_p, _, _ = sweep(f"{n4} nodes, pruned", records_p, 4)
        check(engine_p.stacked_solves >= cands > 0,
              f"sweep[pruned]: {engine_p.stacked_solves} stacked solves for {cands} candidate waves")
        jax_records = read_journal(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                "tests", "data", "jax_card_journal.json"))
        replay("JAX-recorded journal", jax_records)
        sweep("JAX-recorded journal", jax_records, 4)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    print(f"sweep walls[{n} nodes, 40 waves]: record {rec_s:.4f} s (unrecorded {unrec_s:.4f} s), "
          f"replay {replay_s:.4f} s, sweep K=4 {walls[4]:.4f} s, K=16 {walls[16]:.4f} s "
          f"({walls[16] / replay_s:.4f}x the replay) on {card}")
    src = "grove_tpu_torch/kernels/csrc/place_wave.cu"
    # The row is the K = 16 sweep's first launch: its time and bound over
    # its W * K rows; the plain version's time over its sampled rows
    # (plain_rows of rows); the cut case with its null wave beside it.
    n_rows, plain_rows, sampled_ms = sampled[0]
    return {"row": {
        "name": "place_wave_stacked_scan(B6)", "route": "cuda", "source": src,
        "replaces": "grove_tpu/solver/core.py:977", "launches": launches16["stacked_scan"],
        "max_abs_err": err, "ms": times[0][1], "plain_ms": sampled_ms,
        "bound_ms": main_bound[0], "bound_by": main_bound[1], "library_ms": None,
        "w": times[0][0], "k": 16, "rows": n_rows, "plain_rows": plain_rows,
        "cut_ms": cut_ms, "cut_plain_ms": plain_ms, "cut_bound_ms": bound[0],
    }}


STREAM_PRUNING = dict(enabled=True, max_candidates=64, min_fleet=256)
TUNE_VARIANTS = [
    {"weights": {"wTight": 2.0}, "name": "tight2"},
    {"weights": {"wPref": 0.25, "wReserve": 3.0}},
    {"escalatePortfolio": 1, "name": "noesc"},
]


def stream_phase(dev, card) -> dict:
    """Phase 11: bench.py's stream scenario on the card (1280 nodes, the
    25 s trace at base rate 12, wave_size 64, depth 2) through one WarmPath;
    returns the launches per variant the stream runs made."""
    import numpy as np
    import torch

    from grove_tpu_torch.bench import admitted_free, stream_world
    from grove_tpu_torch.kernels.place_wave import VARIANTS, place_wave, reset_launches
    from grove_tpu_torch.solver.drain import ScanConfig, drain_backlog
    from grove_tpu_torch.solver.pruning import PruningConfig
    from grove_tpu_torch.solver.stream import StreamConfig, drain_stream
    from grove_tpu_torch.solver.warm import WarmPath

    events, arrivals, pods, snap = stream_world(20260804, 25.0, 12.0, 2, 16, 20)
    n = snap.capacity.shape[0]
    check(n == 1280 and len(events) == 317 and len(arrivals) == 433 and len(pods) == 2819,
          f"stream: the trace is {len(events)} events, {len(arrivals)} gangs, {len(pods)} pods "
          f"on {n} nodes")
    cfg = StreamConfig(depth=2, wave_size=64)
    wp = WarmPath()
    total = dict.fromkeys(VARIANTS, 0)

    def run(label, arr=arrivals, **kw):
        """One stream on the card, the counts set to 0 before it and read after."""
        torch.cuda.synchronize()
        reset_launches()
        b, s = drain_stream(arr, pods, snap, config=cfg, warm_path=wp, **kw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in place_wave.variant_launches.items() if v}
        for k, v in launches.items():
            total[k] += v
        d = s.drain
        print(f"stream[{label}, {n} nodes]: wall {s.wall_s:.4f} s, {s.gangs_per_sec:.2f} gangs/s, "
              f"admitted {s.admitted}/{s.offered}, waves {s.waves}, windows {s.windows}, "
              f"dispatches {d.dispatches}, round trips {d.device_roundtrips}, scan chunks "
              f"{d.scan_chunks} ({d.scanned_waves} waves), escalations {d.escalations} "
              f"({d.escalations_adopted} adopted), encode {d.encode_s:.4f}, dispatch "
              f"{d.dispatch_s:.4f}, harvest {d.harvest_s:.4f}, compile {d.compile_s:.4f} s, "
              f"lowerings {d.lowerings}, launches {launches} on {card}")
        check(sum(launches.values()) >= d.dispatches - d.escalations > 0,
              f"stream[{label}]: {launches} launches for {d.dispatches} dispatches")
        return b, s, launches

    run("warm-up, pipelined")
    b_ser, s_ser, _ = run("serial", pipeline=False)
    b_pipe, s_pipe, l_pipe = run("pipelined")
    check(set(b_pipe) == set(b_ser), "stream: pipelined admits another set than serial")
    check(s_pipe.admitted == len(arrivals), f"stream: admitted {s_pipe.admitted}/{len(arrivals)}")
    check(l_pipe.get("dense", 0) == s_pipe.waves, f"stream: launches {l_pipe} for {s_pipe.waves} waves")
    check(s_pipe.drain.lowerings == 0, "stream: the pipelined run prepared a launch after warm-up")
    # Stamps are the waves' completion events on the card's clock, from an
    # event at t0: in commit order they never decrease and fall in the wall.
    stamps = [t for _, t in s_pipe.drain.wave_latencies]
    check(len(stamps) == s_pipe.waves and stamps[0] >= 0.0 and stamps[-1] <= s_pipe.wall_s
          and all(a <= b for a, b in zip(stamps, stamps[1:])),
          f"stream: wave stamps {stamps[:3]}..{stamps[-1:]} against a wall of {s_pipe.wall_s}")
    free = admitted_free(b_pipe, pods, snap)
    check(np.array_equal(s_pipe.drain.free_after, free),
          "stream: free_after != snapshot free minus bound pods' requests")
    check(bool((free >= 0).all()), "stream: a node is over capacity")
    b_back, _ = drain_backlog([g for _, g in arrivals], pods, snap, wave_size=64,
                              harvest="pipeline", warm_path=wp)
    check(set(b_back) == set(b_pipe), "stream: drain_backlog admits another set than the stream")
    print(f"stream: serial {s_ser.wall_s:.4f} s against pipelined {s_pipe.wall_s:.4f} s "
          f"({s_ser.wall_s / s_pipe.wall_s:.4f}x), the same set, the set drain_backlog admits; "
          f"free_after == the bound requests, no node over capacity")

    b_scan, s_scan, l_scan = run("scan", scan=True)
    b_formed, s_formed, _ = run("formed serial", pipeline=False, scan=True)
    check(b_scan == b_formed, "stream: scan binds another way than formed serial")
    check(s_scan.drain.scan_chunks >= 1 and 2 * s_scan.drain.scanned_waves >= s_scan.waves,
          f"stream: the scan fused {s_scan.drain.scanned_waves}/{s_scan.waves} waves")
    check(l_scan.get("scan", 0) == s_scan.drain.scan_chunks,
          f"stream: launches {l_scan} for {s_scan.drain.scan_chunks} scan chunks")
    b_res, s_res, l_res = run("resident", scan=ScanConfig(device_resident=True))
    check(b_res == b_formed, "stream: resident binds another way than formed serial")
    check(s_res.drain.device_roundtrips == 1 + s_res.drain.escalations,
          f"stream: resident made {s_res.drain.device_roundtrips} round trips")
    check(l_res.get("scan", 0) >= 1, f"stream: resident launched {l_res}")
    # The plain versions on the CPU at the stream's own shapes (1280 nodes,
    # the class-max gang pads of class-affine forming, the scan's chunk
    # lengths): the card's serial and pipelined runs bind what a plain serial
    # run binds, its formed-serial, scan and resident runs what a plain
    # formed-serial run binds, with the same free_after and ledger.
    cpu_ser_b, cpu_ser = drain_stream(arrivals, pods, snap, config=cfg, pipeline=False,
                                      warm_path=WarmPath(), device="cpu")
    cpu_formed_b, cpu_formed = drain_stream(arrivals, pods, snap, config=cfg, pipeline=False,
                                            scan=True, warm_path=WarmPath(), device="cpu")
    s_ledger = ("admitted", "pods_bound", "waves", "windows")
    for label, b, s, want_b, want_s in (
        ("serial", b_ser, s_ser, cpu_ser_b, cpu_ser),
        ("pipelined", b_pipe, s_pipe, cpu_ser_b, cpu_ser),
        ("formed serial", b_formed, s_formed, cpu_formed_b, cpu_formed),
        ("scan", b_scan, s_scan, cpu_formed_b, cpu_formed),
        ("resident", b_res, s_res, cpu_formed_b, cpu_formed),
    ):
        check(b == want_b and np.array_equal(s.drain.free_after, want_s.drain.free_after)
              and all(getattr(s, k) == getattr(want_s, k) for k in s_ledger),
              f"stream[{label}]: the run on the card != the plain versions on the CPU")
    check(all(getattr(s_formed.drain, k) == getattr(cpu_formed.drain, k)
              for k in ("dispatches", "device_roundtrips", "escalations")),
          "stream[formed serial]: the card's ledger != the plain versions'")
    print("stream: serial, pipelined, formed serial, scan and resident bindings, free_after "
          "and ledger == the plain versions on the CPU at the stream's shapes")

    pruning = PruningConfig(**STREAM_PRUNING)
    b_pr, s_pr, l_pr = run("pruned, 64 candidates", pruning=pruning)
    check(s_pr.drain.escalations >= 1 and s_pr.drain.pruned_waves == s_pr.waves,
          f"stream: the pruned run escalated {s_pr.drain.escalations} times")
    check(set(b_pr) == set(b_pipe), "stream: the pruned run admits another set than the dense run")
    check(l_pr.get("pruned", 0) >= 1, f"stream: the pruned run launched {l_pr}")
    cpu_b, cpu_s = drain_stream(arrivals, pods, snap, config=cfg, pruning=pruning,
                                warm_path=WarmPath(), device="cpu")
    ledger = ("waves", "windows")
    d_ledger = ("dispatches", "device_roundtrips", "escalations", "escalations_adopted",
                "pruned_waves", "candidate_pad")
    check(b_pr == cpu_b and all(getattr(s_pr, k) == getattr(cpu_s, k) for k in ledger)
          and all(getattr(s_pr.drain, k) == getattr(cpu_s.drain, k) for k in d_ledger),
          "stream: the pruned run on the card != the plain versions on the CPU")
    print(f"stream[pruned]: {s_pr.drain.escalations} escalations ({s_pr.drain.escalations_adopted} "
          f"adopted), the dense run's admitted set, bindings and ledger == the plain versions "
          f"on the CPU")

    cut = [(t, g) for t, g in arrivals if t < 10.0]
    _, s_paced, _ = run("paced, the first 10 s", arr=cut, pace=True)
    # The latencies are not clamped: a negative one is a misanchored card clock.
    check(len(s_paced.bind_latencies) == s_paced.admitted > 0
          and min(s_paced.bind_latencies) >= 0.0,
          f"stream[paced]: {len(s_paced.bind_latencies)} latencies for {s_paced.admitted} "
          f"gangs, the least {min(s_paced.bind_latencies, default=None)}")
    pct = s_paced.bind_percentiles((50.0, 99.0))
    print(f"stream[paced]: {len(cut)} gangs over {cut[-1][0]:.3f} s, bind_p50_s {pct[50.0]:.6f}, "
          f"bind_p99_s {pct[99.0]:.6f}, wall {s_paced.wall_s:.4f} s on {card}")
    print(f"stream launches: {total}")
    for v in ("dense", "scan", "pruned"):
        check(total[v] > 0, f"stream: kernel variant {v!r} was never launched")
    return total


def tune_phase(dev, card) -> dict:
    """Phase 12: bench.py's sweep scenario's stream journal recorded on the
    card, replayed, searched, recommended and what-if'd; the committed JAX
    stream journal replayed, swept and recommended; returns the launches
    per variant the tuning runs made."""
    import shutil
    import tempfile

    import torch

    from grove_tpu_torch.bench import record_stream, stream_world
    from grove_tpu_torch.kernels.place_wave import VARIANTS, place_wave, reset_launches
    from grove_tpu_torch.solver.stream import StreamConfig
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.trace.recorder import read_journal
    from grove_tpu_torch.trace.replay import replay_journal
    from grove_tpu_torch.trace.whatif import whatif_configs, whatif_journal
    from grove_tpu_torch.tuning import (
        default_grid,
        incumbent_config,
        recommend,
        successive_halving,
        sweep_journal,
    )

    def strip(doc):
        if isinstance(doc, dict):
            return {k: strip(v) for k, v in doc.items() if "Seconds" not in k}
        if isinstance(doc, list):
            return [strip(v) for v in doc]
        return doc

    torch.cuda.synchronize()
    reset_launches()
    t_phase = time.perf_counter()
    _, arrivals, pods, snap = stream_world(7, 10.0, 3.0, 1, 4, 8)
    root = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    try:
        _, s, rec, records = record_stream(arrivals, pods, snap, os.path.join(root, "stream"),
                                           config=StreamConfig(depth=2, wave_size=8))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    waves = sum(1 for r in records if r.get("kind") == "wave")
    check(s.drain.journaled_waves == s.waves == waves == 27 and rec.dropped == 0,
          f"tune: {s.drain.journaled_waves}/{s.waves} waves journaled, {rec.dropped} dropped")
    wp = WarmPath()
    rep = replay_journal(records, warm_path=wp)
    check(rep.divergence_count == 0, f"tune: replay diverged {rep.to_doc()}")
    grid = default_grid(incumbent_config(records), 16)
    t0 = time.perf_counter()
    engine, schedule = successive_halving(records, grid, rungs=4, warm_path=wp)
    halving_s = time.perf_counter() - t0
    survivors = [len(r["configs"]) for r in schedule]
    check(survivors == [16, 8, 4, 2] and all("incumbent" in r["configs"] for r in schedule)
          and "incumbent" in {c.name for c in engine.configs},
          f"tune: halving kept {survivors}, the incumbent dropped")
    t0 = time.perf_counter()
    doc = recommend(records, k=16, rungs=4, warm_path=wp)
    recommend_s = time.perf_counter() - t0
    val = doc["validation"]
    check(doc["valid"] and val["bitwiseReplay"]["divergences"] == 0
          and val["journalReplayDivergences"] == 0,
          f"tune: recommend {doc.get('failedGates')} {val['bitwiseReplay']}")
    wj = whatif_journal(records, add_rack_count=1, warm_path=wp).to_doc()
    check(wj["waves"] == waves and wj["counterfactual"]["admitted"] >= wj["recorded"]["admitted"],
          f"tune: what-if +1 rack {wj['recorded']} -> {wj['counterfactual']}")
    wc = whatif_configs(records, TUNE_VARIANTS, warm_path=wp).to_doc()
    check(wc["replayDivergences"] == 0 and len(wc["variants"]) == 3,
          f"tune: what-if configs diverged {wc['replayDivergences']}")
    print(f"tune[stream journal, {waves} waves, 64 nodes]: replay 0 divergences; halving K=16 "
          f"rungs 4 {survivors} in {halving_s:.4f} s; recommend {doc['winner']['name']} valid in "
          f"{recommend_s:.4f} s (audit {val['exactAudit']['winner']['admitted']}/"
          f"{val['exactAudit']['winner']['exactAdmitted']}); what-if +1 rack admitted "
          f"{wj['recorded']['admitted']} -> {wj['counterfactual']['admitted']}; three variants, "
          f"0 replay divergences, on {card}")

    here = os.path.dirname(os.path.abspath(__file__))
    jax_records = read_journal(os.path.join(here, "tests", "data", "jax_stream_journal.json"))
    with open(os.path.join(here, "tests", "data", "jax_stream_recommend.json")) as f:
        verdict = json.load(f)
    rep = replay_journal(jax_records, warm_path=wp)
    check(rep.divergence_count == 0, f"tune: the JAX journal's replay diverged {rep.to_doc()}")
    sw = sweep_journal(jax_records, default_grid(incumbent_config(jax_records), 16), warm_path=wp)
    check(sw.tallies["incumbent"].divergences == 0, "tune: the JAX journal's sweep diverged")
    jdoc = recommend(jax_records, k=verdict["k"], rungs=verdict["rungs"], warm_path=wp)
    got = {
        "winner": jdoc["winner"]["name"],
        "valid": jdoc["valid"],
        "failedGates": jdoc.get("failedGates", []),
        "bitwiseDivergences": jdoc["validation"]["bitwiseReplay"]["divergences"],
        "journalReplayDivergences": jdoc["validation"]["journalReplayDivergences"],
        "admittedPass": jdoc["validation"]["exactAudit"]["admittedPass"],
        "survivorsPerRung": [len(r["configs"]) for r in jdoc["rungs"]],
        "winnerAdmitted": jdoc["winnerTally"]["admitted"],
        "incumbentAdmitted": jdoc["incumbentTally"]["admitted"],
    }
    want = {k: verdict[k] for k in got}
    check(got == want, f"tune: the JAX journal's recommend {got} != the JAX package's {want}")
    launches = dict(place_wave.variant_launches)
    cpu_doc = recommend(jax_records, k=verdict["k"], rungs=verdict["rungs"], device="cpu")
    check(strip(cpu_doc) == strip(jdoc), "tune: recommend on the card != the plain versions")
    print(f"tune[JAX-recorded stream journal, {verdict['waves']} waves]: replay and sweep K=16 0 "
          f"divergences; recommend {got['winner']} valid, gates and survivors "
          f"{got['survivorsPerRung']} == the JAX package's; the document == the plain versions "
          f"on the CPU; phase {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    for v in ("dense", "stacked"):
        check(launches[v] > 0, f"tune: kernel variant {v!r} was never launched")
    return {k: launches.get(k, 0) for k in VARIANTS}


def chaos_phase(dev, card) -> dict:
    """Phase 13: bench.py's chaos scenario on the card, the same schedule on
    phase 11's trace, and a real hang caught by the watchdog; returns the
    launches per variant of the drains it counted."""
    import numpy as np
    import torch

    from grove_tpu_torch.bench import (
        CHAOS_P99_CAP,
        chaos_faults,
        chaos_resilience,
        double_bound,
        fault_accounting,
        run_chaos_bench,
        same_as_baseline,
        stream_world,
    )
    from grove_tpu_torch.kernels.place_wave import VARIANTS, place_wave, reset_launches
    from grove_tpu_torch.solver.drain import ScanConfig, drain_backlog
    from grove_tpu_torch.solver.pruning import PruningConfig
    from grove_tpu_torch.solver.resilience import DegradationLadder, ResilienceConfig
    from grove_tpu_torch.solver.stream import StreamConfig, drain_stream
    from grove_tpu_torch.solver.warm import WarmPath

    t_phase = time.perf_counter()
    total = dict.fromkeys(VARIANTS, 0)

    def add(counts):
        for k, v in (counts or {}).items():
            total[k] += v

    out = run_chaos_bench(device=dev)
    for counts in out["launches"].values():
        add(counts)
    gates = out["gates"]
    print(f"chaos[192 nodes]: {out['gangs_offered']} gangs, {out['pods_offered']} pods; "
          f"gates {gates}; fired {out['faults_fired']}, journaled {out['faults_journaled']}, "
          f"retries {out['wave_retries']}, watchdog timeouts {out['watchdog_timeouts']}, "
          f"cancelled {out['waves_cancelled']}, re-dispatches {out['wave_redispatches']}, "
          f"replay divergences {out['replay_divergences']} over {out['journaled_waves']} waves")
    print(f"chaos: ladder {out['ladder_rungs']}, step-downs {out['step_downs']}, step-ups "
          f"{out['step_ups']}; armed without faults {out['armed_resilience']}, armed "
          f"lowerings {out['armed_lowerings']}, chaos lowerings {out['chaos_lowerings']}")
    print(f"chaos: baseline bind_p99_s {out['baseline_bind_p99_s']:.6f}, chaos bind_p99_s "
          f"{out['chaos_bind_p99_s']:.6f}, ratio {out['value']:.4f} (bench cap {CHAOS_P99_CAP}); "
          f"walls {out['baseline_wall_s']:.4f} / {out['chaos_wall_s']:.4f} s; recorder "
          f"{out['recorder_enospc']}; launches {out['launches']} on {card}")
    for gate in ("zero_lost_gangs", "zero_double_bound_pods", "faults_journaled",
                 "fault_accounting", "armed_without_faults_quiet", "ladder_recovered",
                 "ladder_walked_to_pipeline", "journal_replays_bitwise",
                 "recorder_counting_drops"):
        check(gates[gate], f"chaos: gate {gate} failed")
    check(out["launches"]["chaos"].get("scan", 0) + out["launches"]["chaos"].get(
          "scan_pruned", 0) >= 1 and out["launches"]["chaos"].get("dense", 0) >= 1,
          f"chaos: the chaos run launched {out['launches']['chaos']}")

    # The same schedule at full size: phase 11's trace on 1280 nodes.
    _, arrivals, pods, snap = stream_world(20260804, 25.0, 12.0, 2, 16, 20)
    cfg = StreamConfig(depth=2, wave_size=64)
    kw = dict(config=cfg, pruning=PruningConfig(enabled=True, min_fleet=64), pipeline=True,
              scan=ScanConfig(device_resident=True))
    wp = WarmPath()

    def run(**extra):
        torch.cuda.synchronize()
        reset_launches()
        b, st = drain_stream(arrivals, pods, snap, warm_path=wp, **kw, **extra)
        torch.cuda.synchronize()
        counts = {k: v for k, v in place_wave.variant_launches.items() if v}
        add(counts)
        return b, st, counts

    run()  # warm-up
    b_base, s_base, _ = run()
    # The ladder armed without faults: the cost of arming (watchdog polls of
    # each wave's event instead of one blocking wait), and no real error.
    quiet = DegradationLadder(chaos_resilience())
    b_armed, s_armed, _ = run(resilience=quiet)
    check(b_armed == b_base and not any(s_armed.drain.resilience_doc().values())
          and quiet.wave_failures == 0 and quiet.fully_closed(),
          f"chaos[1280]: the armed run without faults {s_armed.drain.resilience_doc()}")
    print(f"chaos[1280]: armed without faults wall {s_armed.wall_s:.4f} s (harvest "
          f"{s_armed.drain.harvest_s:.4f}) against the baseline's {s_base.wall_s:.4f} s "
          f"(harvest {s_base.drain.harvest_s:.4f}), bind_p99_s "
          f"{s_armed.bind_percentiles((99.0,))[99.0]:.6f} against "
          f"{s_base.bind_percentiles((99.0,))[99.0]:.6f}; the baseline's bindings")
    inj = chaos_faults()
    lad = DegradationLadder(chaos_resilience())
    b_chaos, s_chaos, l_chaos = run(faults=inj, resilience=lad)
    check(s_chaos.drain.pruned_waves == 0 and same_as_baseline(b_chaos, s_chaos.drain, b_base,
                                                                s_base.drain),
          f"chaos[1280]: the chaos run ({s_chaos.drain.pruned_waves} pruned waves) binds "
          f"otherwise than the baseline")
    check(not double_bound(b_chaos), "chaos[1280]: a pod is bound twice")
    check(inj.total_fired() > 0 and fault_accounting(inj, s_chaos.drain, lad),
          f"chaos[1280]: {inj.stats()} does not explain {s_chaos.drain.resilience_doc()} and "
          f"{lad.wave_failures} ladder failures")
    print(f"chaos[1280 nodes, {len(arrivals)} gangs]: admitted {s_chaos.admitted}, the "
          f"baseline's bindings and free capacity after, no double bind, fired {inj.total_fired()} == accounted; "
          f"{s_chaos.drain.resilience_doc()}, ladder {lad.counters()}, closed "
          f"{lad.fully_closed()}; bind_p99_s baseline "
          f"{s_base.bind_percentiles((99.0,))[99.0]:.6f}, chaos "
          f"{s_chaos.bind_percentiles((99.0,))[99.0]:.6f}; launches {l_chaos} on {card}")

    # A real hang: a spin of known length ahead of one launch of a
    # pipelined drain, and of a resident one (whose single batched wait
    # polls the newest event and, past the deadline, hands each wave to the
    # per-wave watchdog); the watchdog at a third of the spin must catch it
    # through the wave's event (no injector is installed) and re-dispatch
    # until it clears.
    gangs = [g for _, g in arrivals]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(int(2e8))
    e1.record()
    torch.cuda.synchronize()
    hz = 2e8 / (e0.elapsed_time(e1) / 1e3)
    spin_s, watchdog_s = 0.6, 0.2
    res = ResilienceConfig(enabled=True, watchdog_seconds=watchdog_s, max_wave_retries=12)
    wp_h = WarmPath()
    b_plain = drain_backlog(gangs, pods, snap, wave_size=64, warm_path=wp_h)[0]
    cache = wp_h.executables
    for harvest, spin_at in (("pipeline", 4), ("resident", 2)):
        dkw = dict(wave_size=64, harvest=harvest, depth=2, warm_path=wp_h, resilience=res)
        b_h0, s_h0 = drain_backlog(gangs, pods, snap, **dkw)
        check(not any(s_h0.resilience_doc().values()),
              f"hang[{harvest}]: the armed run {s_h0.resilience_doc()}")
        calls = [0]

        def spun(launch):
            def wrapped(*a, **k):
                calls[0] += 1
                if calls[0] == spin_at:
                    torch.cuda._sleep(int(spin_s * hz))  # ahead of this launch
                return launch(*a, **k)
            return wrapped

        cache.solve, cache.solve_scan = spun(cache.solve), spun(cache.solve_scan)
        try:
            torch.cuda.synchronize()
            reset_launches()
            b_h, s_h = drain_backlog(gangs, pods, snap, **dkw)
            torch.cuda.synchronize()
            add({k: v for k, v in place_wave.variant_launches.items() if v})
        finally:
            del cache.solve, cache.solve_scan
        check(s_h.waves >= 6 and calls[0] >= spin_at,
              f"hang[{harvest}]: {s_h.waves} waves, {calls[0]} launches")
        check(s_h.watchdog_timeouts >= 1 and s_h.wave_redispatches == s_h.watchdog_timeouts,
              f"hang[{harvest}]: {s_h.resilience_doc()}")
        check(b_h == b_h0 == b_plain and np.array_equal(s_h.free_after, s_h0.free_after),
              f"hang[{harvest}]: the bindings differ from the fault-free run")
        print(f"hang[{harvest}]: a {spin_s} s spin ({int(spin_s * hz)} cycles at "
              f"{hz / 1e9:.3f} GHz) ahead of launch {spin_at} of {s_h0.dispatches} "
              f"({s_h.waves} waves), watchdog {watchdog_s} s: {s_h.resilience_doc()}, drain "
              f"wall {s_h.total_s:.4f} s against {s_h0.total_s:.4f} s without the spin, "
              f"harvest {s_h.harvest_s:.4f} s, round trips {s_h.device_roundtrips} against "
              f"{s_h0.device_roundtrips}; the fault-free bindings on {card}")
    print(f"chaos launches: {total}; phase {time.perf_counter() - t_phase:.1f} s")
    return total


def defrag_phase(dev, card) -> dict:
    """Phase 14: bench.py's defrag scenario at scale 1 with its plan held to
    the plain versions on the CPU, plan_rescue on two cordoned racks, then
    scale 20 on the card alone; returns the launches per variant of the
    planning runs."""
    import numpy as np
    import torch

    from grove_tpu_torch.bench import defrag_world, run_defrag_bench
    from grove_tpu_torch.kernels.place_wave import VARIANTS, place_wave, reset_launches
    from grove_tpu_torch.sim.workloads import BLOCK_KEY, RACK_KEY
    from grove_tpu_torch.solver.defrag import plan_migrations, plan_rescue
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.state import build_snapshot

    t_phase = time.perf_counter()
    total = dict.fromkeys(VARIANTS, 0)
    keys = ("plan_solve_s", "plan_wall_s", "candidates_evaluated", "pods_migrated",
            "gangs_moved", "capacity_recovered", "frag_score_before", "frag_score_after",
            "big_gang_admitted_before", "big_gang_admitted_after", "plan_lowerings",
            "warm_replan_lowerings", "warm_replan_solve_s", "vs_baseline")
    for scale in (1.0, 20.0):
        out = run_defrag_bench(scale, device=dev)
        for k, v in out["plan_launches"].items():
            total[k] += v
        print(f"defrag[{out['nodes']} nodes, {out['squat_gangs']} squatters]: "
              f"{ {k: out[k] for k in keys} }, plan launches "
              f"{ {k: v for k, v in out['plan_launches'].items() if v} } on {card}")
        check(out["big_gang_admitted_before"] == 0 and out["big_gang_admitted_after"] >= 1,
              f"defrag[{scale}]: the big gang admitted {out['big_gang_admitted_before']} times "
              f"before the plan, {out['big_gang_admitted_after']} after it")
        check(out["warm_replan_lowerings"] == 0 and out["warm_replan_same_moves"],
              f"defrag[{scale}]: the warm re-plan prepared {out['warm_replan_lowerings']} "
              f"launches or moved otherwise")
        check(out["plan_launches"]["dense"] >= out["candidates_evaluated"] > 0,
              f"defrag[{scale}]: {out['plan_launches']} for {out['candidates_evaluated']} "
              f"candidates")
        if scale != 1.0:
            continue
        # The plan against the plain versions on the CPU, on the same world.
        topo, nodes, gangs, pods, _, _ = defrag_world(1.0)
        want = plan_migrations(nodes, topo, gangs, dict(pods), warm=WarmPath(),
                               max_moves=len(gangs), device="cpu")
        got = plan_migrations(nodes, topo, gangs, dict(pods), warm=WarmPath(),
                              max_moves=len(gangs), device=dev)
        check([(m.gang, m.bindings) for m in got.moves]
              == [(m.gang, m.bindings) for m in want.moves]
              and got.pods_migrated == out["pods_migrated"],
              "defrag: the plan on the card != the plain versions' on the CPU")
        # Rescue: cordon two racks, re-place the squatters bound there.
        racks: dict = {}
        for n in nodes:
            racks.setdefault((n.labels[BLOCK_KEY], n.labels[RACK_KEY]), set()).add(n.name)
        cordoned = set().union(*(racks[k] for k in sorted(racks)[:2]))
        for n in nodes:
            n.schedulable = n.name not in cordoned
        stranded = [g for g in gangs
                    if any(pods[r.name].node_name in cordoned
                           for grp in g.spec.pod_groups for r in grp.pod_references)]
        for hold in (True, False):
            torch.cuda.synchronize()
            reset_launches()
            moves = plan_rescue(nodes, topo, stranded, pods, warm=WarmPath(), hold_usage=hold,
                                device=dev)
            torch.cuda.synchronize()
            for k, v in place_wave.variant_launches.items():
                total[k] += v
            plain = plan_rescue(nodes, topo, stranded, pods, warm=WarmPath(), hold_usage=hold,
                                device="cpu")
            check([(m.gang, m.bindings) for m in moves] == [(m.gang, m.bindings) for m in plain],
                  f"rescue[hold_usage={hold}]: the card's moves != the plain versions'")
            targets = {t for m in moves for t in m.bindings.values()}
            check({m.gang for m in moves} == {g.name for g in stranded}
                  and not targets & cordoned,
                  f"rescue[hold_usage={hold}]: moves {[(m.gang, m.bindings) for m in moves]}")
            moved = {p: t for m in moves for p, t in m.bindings.items()}
            bound = []
            for pod in pods.values():
                q = type(pod)(**vars(pod))
                q.node_name = moved.get(pod.name, pod.node_name)
                bound.append(q)
            snap = build_snapshot(nodes, topo, bound_pods=bound)
            check(bool((snap.free >= -1e-3).all()), f"rescue[hold_usage={hold}]: over capacity")
            print(f"rescue[hold_usage={hold}]: {len(stranded)} squatters on 2 cordoned racks "
                  f"moved onto schedulable nodes, no node over capacity, == the plain versions")
        for n in nodes:
            n.schedulable = True
    print(f"defrag launches: {total}; phase {time.perf_counter() - t_phase:.1f} s")
    return total


def serving_phase(dev, card) -> dict:
    """Phase 15: the port's GroveController under the Simulator on the card —
    (a) bench.py's default backlog served on its 5120-node fleet until every
    pod is Ready, its journal replayed on the CPU's plain versions; (b)
    bench.py's replay scenario (recorder OFF/ON, replay, +1-rack what-if)
    against the same scenario on the CPU; (c) the 256-node churn world under
    a card controller and a CPU controller in lockstep, the stores equal
    after every step. Returns the launches per variant of the three runs."""
    import torch

    from grove_tpu_torch.bench import (
        replay_doc_core,
        run_replay_bench,
        run_serving_bench,
        run_serving_lockstep,
    )
    from grove_tpu_torch.kernels.place_wave import VARIANTS, place_wave, reset_launches

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    total = dict.fromkeys(VARIANTS, 0)

    def count(launches):
        for k, v in (launches or {}).items():
            total[k] += v

    # (a) full size. run_serving_bench zeroes the counts before the first
    # tick and reads them after the last.
    a = run_serving_bench(device=dev)
    count(a["launches"])
    log = a.pop("tick_log")
    for t in log:
        print(f"serving[tick {t['now']:.0f}]: wall {t['wall_s']:.4f} s, pods {t['pods']} bound "
              f"{t['bound']} ready {t['ready']}, phases "
              f"{ {k: round(v, 4) for k, v in t['phases_s'].items()} }"
              + (f", host stages {t['host_stages']}" if "host_stages" in t else ""))
    print(f"serving[5120 nodes, 10k pods]: { {k: v for k, v in a.items()} } on {card}")
    check(a["gangs_base_scheduled"] == a["gangs"] == 1250,
          f"serving: {a['gangs_base_scheduled']}/{a['gangs']} gangs scheduled")
    check(not a["overcommitted_nodes"], f"serving: nodes over capacity {a['overcommitted_nodes']}")
    check(a["sim_s_to_all_ready"] is not None and a["pcs_available"] == a["podcliquesets"],
          f"serving: ready at {a['sim_s_to_all_ready']}, "
          f"{a['pcs_available']}/{a['podcliquesets']} PodCliqueSets available")
    check(a["replayed_waves"] >= 1 and a["divergences"] == 0,
          f"serving: CPU replay of {a['replayed_waves']}/{a['journal_waves']} waves, "
          f"{a['divergences']} divergences")
    check(a["ok"], "serving: a gate failed")
    print(f"serving: journal replayed on the CPU's plain versions ({a['replay_scope']}: "
          f"{a['replayed_waves']}/{a['journal_waves']} waves, first floors wave "
          f"{a['first_floors_gangs']} gangs in {a['first_floors_replay_s']:.2f} s), "
          f"0 divergences")

    # (b) bench.py's replay scenario, on the card and then on the CPU. The
    # record-overhead gate reads REPLAY_ROUNDS rounds of windows of
    # back-to-back drains, OFF, ON, ON, OFF and ON, OFF, OFF, ON in turn, each
    # ON window timed through its recorder's flush, after an untimed
    # calibration window.
    sync(dev)
    reset_launches()
    b = run_replay_bench(device=dev, window_s=REPLAY_WINDOW_S, rounds=REPLAY_ROUNDS,
                         journal_dir=PHASE15_JOURNAL)
    sync(dev)
    b_launches = dict(place_wave.variant_launches)
    count(b_launches)
    print(f"replay scenario: { {k: v for k, v in b.items() if k not in ('recorder_stats', 'record_windows', 'record_split', 'record_calibration')} }, "
          f"launches { {k: v for k, v in b_launches.items() if v} } on {card}")
    check(b["value"] == 0, f"replay scenario: {b['value']} divergences")
    check(b_launches["portfolio"] >= 1,
          f"replay scenario: no portfolio launch for the rejected job ({b_launches})")
    b_cpu = run_replay_bench(device="cpu")
    check(replay_doc_core(b) == replay_doc_core(b_cpu),
          "replay scenario: the card's document != the CPU's (wall-clock keys aside)")
    cal_drains, cal_wall = b["record_calibration"]
    print(f"replay scenario calibration (untimed, in neither sum): {cal_drains} drains in "
          f"{cal_wall:.6f} s")
    for side, drains, wall, gc_s, collections, cpu, vcs, ivcs in b["record_windows"]:
        print(f"replay scenario window {side.upper()}: {drains} drains in {wall:.6f} s, "
              f"{wall / drains:.6f} s a drain; the draining thread's CPU {cpu:.6f} s, "
              f"switches {vcs} voluntary {ivcs} involuntary; the collector paused "
              f"{gc_s:.6f} s in {collections} collections")
    split = b["record_split"]
    from grove_tpu_torch.utils import serde

    def per_drain(v):
        return f"{v['s'] * 1e3 / split['drains']:.4f} ({v['n']})"

    print("replay scenario: the recorder's ms a drain over the ON windows (renderer "
          f"{os.path.basename(serde.renderer_file or 'not loaded')}: "
          + ", ".join(f"{part} {per_drain(v)}" for part, v in split["parts"].items()
                      if not part.startswith("flush"))
          + f"; {split['drains']} drains; the writer thread's CPU "
          f"{split['writer_cpu_s'] * 1e3 / split['drains']:.4f}, switches "
          f"{split['writer_switches']}); collector pauses ON "
          f"{sum(w[3] for w in b['record_windows'] if w[0] == 'on'):.6f} s, OFF "
          f"{sum(w[3] for w in b['record_windows'] if w[0] == 'off'):.6f} s")
    parts = split["parts"]
    print(f"replay scenario: the draining thread's flush, ms a drain: flush "
          f"{per_drain(parts['flush'])} = "
          + " + ".join(f"{part[6:]} {per_drain(v)}" for part, v in parts.items()
                       if part.startswith("flush."))
          + "; capture + render "
          f"{(parts['capture']['s'] + parts['render']['s']) * 1e3 / split['drains']:.4f}; "
          "the writer's file steps, ms a drain: "
          + ", ".join(f"{step} {s * 1e3 / split['drains']:.4f}"
                      for step, s in split["file_steps"].items())
          + f" on {card}")
    print(f"replay scenario: OFF {b['drain_wall_off_s']:.6f} s, ON {b['drain_wall_on_s']:.6f} s "
          f"a drain, overhead {b['record_overhead_frac']:.4f} (gate < 0.05) on {card}; "
          f"== the CPU's document, seconds aside")
    RECORD_OVERHEAD.append(b["record_overhead_frac"])
    if b["vs_baseline"] != 1.0:
        # The run goes on through every phase and then fails (main()).
        GATE_FAILURES.append(
            f"replay scenario: bench.py's gate failed (overhead "
            f"{b['record_overhead_frac']:.4f}, admitted {b['gangs_admitted']}/{b['gangs']}, "
            f"divergences {b['value']})")
        print(f"FAILED: {GATE_FAILURES[-1]}")

    # (c) the churn world, card against CPU, step by step.
    sync(dev)
    reset_launches()
    c = run_serving_lockstep(devices=(dev, "cpu"))
    sync(dev)
    c_launches = dict(place_wave.variant_launches)
    count(c_launches)
    print(f"lockstep[card == CPU, {c['nodes']} nodes]: {c}, card launches "
          f"{ {k: v for k, v in c_launches.items() if v} }")
    check(not c["overcommitted_nodes"] and c["bound"] > 0,
          f"lockstep: bound {c['bound']}, over capacity {c['overcommitted_nodes']}")
    print(f"serving launches: {total}; phase {time.perf_counter() - t_phase:.1f} s")
    return total


def sidecar_phase(dev, card) -> dict:
    """Phase 16: the port's GREP-375 sidecar on the card at bench.py's
    default size, over gRPC (see bench.run_sidecar_bench), every gate but
    the CPU servicer's; then the same sequence on SIDECAR_CPU_FRAC of the
    backlog on the card, every gate, its responses == an in-process CPU
    servicer's (the CPU side at a cut depth: at full size its 162-195 s of
    plain versions pushed the run past its time with phase 21). Returns
    the launches per variant of the full-size run."""
    from grove_tpu_torch.bench import run_sidecar_bench

    t_phase = time.perf_counter()
    d = run_sidecar_bench(device=dev, cpu_side=False)
    print(f"sidecar[{d['nodes']} nodes, {d['gangs']} gangs, {d['pods']} pods]: "
          f"{d['sync_rpcs']} SyncPodGang RPCs in {d['sync_wall_s']:.4f} s, "
          f"{d['inflight_sync_rpcs']} more in {d['inflight_sync_wall_s']:.4f} s while the "
          f"first Solve's device phase was parked, sequence "
          f"{d['sequence_wall_s']:.4f} s; Solve admitted {d['admitted']} of "
          f"{d['gangs_solved']}; contended {d['contended_admitted']}/{d['contended_gangs']}; "
          f"lowerings {d['lowerings']}; launches { {k: v for k, v in d['launches'].items() if v} } "
          f"(contended { {k: v for k, v in d['contended_launches'].items() if v} }) on {card}")
    for name, micros, st in zip(("first", "incremental", "contended"), d["solve_micros"],
                                d["stages"]):
        print(f"sidecar Solve[{name}]: solve_micros {micros}, stages "
              f"{ {k: round(v, 6) if isinstance(v, float) else v for k, v in st.items()} }")
    for gate, ok in d["gates"].items():
        check(ok is not False, f"sidecar: gate {gate} failed "
              f"({ {k: v for k, v in d.items() if k != 'stages'} })")
    t_cut = time.perf_counter()
    c = run_sidecar_bench(1.0, SIDECAR_CPU_FRAC, device=dev)
    print(f"sidecar[{c['nodes']} nodes, {c['gangs']} gangs, the CPU side's depth]: CPU "
          f"servicer's responses equal: {c['cpu_equal']} ({c['cpu_s']:.2f} s on the CPU's "
          f"plain versions; the cut run {time.perf_counter() - t_cut:.1f} s); gates "
          f"{c['gates']}")
    for gate, ok in c["gates"].items():
        check(ok, f"sidecar[cut]: gate {gate} failed "
              f"({ {k: v for k, v in c.items() if k != 'stages'} })")
    print(f"sidecar phase {time.perf_counter() - t_phase:.1f} s")
    return d["launches"]


def cells_phase(dev, card) -> dict:
    """Phase 17: bench.py's cells scenario with every cell's stream drain on
    the card, its gates, and its document against the CPU run's. Returns
    the launches per variant."""
    import torch

    from grove_tpu_torch.bench import cells_doc_core, run_cells_bench
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    reset_launches()
    d = run_cells_bench(device=dev)
    torch.cuda.synchronize(dev)
    launches = dict(place_wave.variant_launches)
    t_card = time.perf_counter() - t_phase
    kr = d["kill_resume"]
    print(f"cells[{d['nodes']} nodes, {d['gangs_offered']} gangs, chunks of "
          f"{d['crash_check_every']}]: kill/resume precrash bound {kr['precrash_bound']}, "
          f"resumed {kr['resumed_bound']}, survivor {kr['survivor_bound']}, replay "
          f"{kr['replay']}, audits {kr['audit_cell0']} {kr['audit_cell1']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; {t_card:.1f} s on {card}")
    for sc in d["scaling"]:
        per = {c: (v["gangs_offered"], v["gangs_admitted"], v["dispatches"], v["host_total_s"])
               for c, v in sc["per_cell"].items()}
        print(f"cells[{sc['cells']}]: per cell (offered, admitted, dispatches, host s) {per}; "
              f"aggregate admitted {sc['aggregate_admitted']}, dispatches "
              f"{sc['aggregate_dispatches']}, busiest cell offered {sc['max_cell_gangs_offered']}")
    for gate, ok in d["gates"].items():
        check(ok, f"cells: gate {gate} failed")
    check(d["vs_baseline"] == 1.0, f"cells: vs_baseline {d['vs_baseline']}")
    check(kr["replay"]["divergences"] == 0 and kr["replay"]["verified"],
          f"cells: recovery replay {kr['replay']}")
    check(not kr["lost_gangs"] and not kr["double_bound_gangs"],
          f"cells: lost {kr['lost_gangs']}, double-bound {kr['double_bound_gangs']}")
    check(launches["dense"] >= 1, f"cells: no dense launch ({launches})")
    d_cpu = run_cells_bench(device="cpu")
    check(cells_doc_core(d) == cells_doc_core(d_cpu),
          "cells: the card's document != the CPU's (wall-clock keys aside)")
    print(f"cells: every gate green, == the CPU's document (wall-clock keys aside); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def operator_phase(dev, card) -> tuple[dict, dict]:
    """Phase 18: (a) bench.py's tenancy scenario at full size through the
    port's Manager on the card: every gate, the journal replayed on the
    CPU's plain versions with 0 divergences, the document == the CPU run's;
    (b) the operator binary (`python -m grove_tpu_torch.runtime`, KWOK
    source) in a subprocess on the card: it boots, its probes answer, a
    PodCliqueSet goes in through the admission webhook over TLS and is
    scheduled, /statusz shows the solves on the card, SIGTERM stops it with
    exit code 0. Returns the launches per variant of (a) and of (b)."""
    import torch

    from grove_tpu_torch.bench import manager_doc_core, run_operator_binary, run_tenancy_bench
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    reset_launches()
    a = run_tenancy_bench(device=dev, duration_s=TENANCY_DURATION_S, cpu_replay=True)
    torch.cuda.synchronize(dev)
    a_launches = dict(place_wave.variant_launches)
    print(f"tenancy[192 nodes, {a['tenant_count']} tenants, {a['trace_duration_s']} s trace at "
          f"1.6 arrivals/s]: gates {a['gates']}; offered {a['workloads_offered']}, bound "
          f"{a['workloads_bound']}, spread {a['value']}, tiers "
          f"{ {k: v['p99_bind_s'] for k, v in a['tiers'].items()} } p99 s, ledger "
          f"{a['ledger_totals']}, faults {len(a['faults'])}, budget peak "
          f"{a['budget_peak_in_flight']}/{a['budget_cap']}; {a['sim_seconds']} sim s in "
          f"{a['wall_s']:.3f} s; replay on the card {a['replay_divergences']} divergences "
          f"over {a['replay_waves']} waves, on the CPU {a['cpu_replay_divergences']} over "
          f"{a['cpu_replay_waves']}; launches { {k: v for k, v in a_launches.items() if v} } "
          f"on {card}")
    for gate, ok in a["gates"].items():
        check(ok, f"tenancy: gate {gate} failed")
    check(a["vs_baseline"] == 1.0, f"tenancy: vs_baseline {a['vs_baseline']}")
    check(a["cpu_replay_divergences"] == 0 and a["cpu_replay_waves"] == a["replay_waves"] > 0,
          f"tenancy: CPU replay {a['cpu_replay_divergences']} divergences over "
          f"{a['cpu_replay_waves']} waves")
    check(a_launches["dense"] >= 1, f"tenancy: no dense launch ({a_launches})")
    a_cpu = run_tenancy_bench(device="cpu", duration_s=TENANCY_DURATION_S)
    core = manager_doc_core(a)
    core.pop("cpu_replay_divergences")
    core.pop("cpu_replay_waves")
    check(core == manager_doc_core(a_cpu),
          "tenancy: the card's document != the CPU's (wall-clock keys aside)")
    print(f"tenancy: every gate green, == the CPU's document (wall-clock keys aside); "
          f"{time.perf_counter() - t_phase:.1f} s")

    t_b = time.perf_counter()
    b = run_operator_binary(device=None)
    solver = b["statusz_solver"]
    b_launches = dict(b["launches"])
    print(f"operator binary[{b['command']}]: booted in {b['boot_s']:.3f} s, probes "
          f"{b['probe']}, {b['kwok_nodes']} KWOK nodes at {b['fleet_s']:.3f} s; "
          f"{b['workload']} admitted over TLS ({b['admission']['patch_ops']} patch ops, "
          f"{b['admission']['wall_s']:.4f} s), scheduled and Ready ({b['pods']} pods, "
          f"{b['podgangs']} gangs) in {b['schedule_s']:.3f} s; /statusz solver device "
          f"{solver['device']['type']} {solver['device']['name']}, host stages "
          f"{solver.get('hostStages')}, launches { {k: v for k, v in b_launches.items() if v} }; "
          f"exit {b['exit_code']} (stopped cleanly: {b['stopped_cleanly']}); "
          f"{time.perf_counter() - t_b:.1f} s on {card}")
    check(solver["device"]["type"] == "cuda", f"operator: solves on {solver['device']}")
    check(b_launches["dense"] >= 1, f"operator: no dense launch in the child ({b_launches})")
    check(b["exit_code"] == 0 and b["stopped_cleanly"], "operator: did not stop cleanly")
    print(f"operator phase {time.perf_counter() - t_phase:.1f} s")
    return a_launches, b_launches

def fixture_apiserver():
    """tests/fixture_apiserver.py, loaded by path: a stdlib-only in-process
    apiserver (list/watch, the binding subresource, leases, the grove.io CRs
    with their admission webhooks) that imports nothing of the repo."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixture_apiserver.py")
    spec = importlib.util.spec_from_file_location("fixture_apiserver", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def without_seconds(doc):
    """`doc` without the keys that hold seconds (wall-clock readings)."""
    if isinstance(doc, dict):
        return {k: without_seconds(v) for k, v in doc.items() if "Seconds" not in k}
    if isinstance(doc, list):
        return [without_seconds(v) for v in doc]
    return doc


def kube_operator_binary(device=None, nodes: int = 16, timeout_s: float = 120.0) -> dict:
    """Phase 19 (b): `python -m grove_tpu_torch.runtime` on the card against
    a FixtureApiServer: `cluster.source: kubernetes` through a kubeconfig
    that points at the fixture, leader election on (a KubeLease), the
    webhook port set and the rendered webhook configurations waiting for
    their caBundle. The boot patch must land; examples/simple1.yaml applied
    as a PodCliqueSet CR goes through the apiserver's admission (the
    binary's webhooks, TLS verified against the patched caBundle), is
    watched in, solved, created and bound through the binding subresource,
    made Ready by a kubelet stand-in, and its status written back;
    `python -m grove_tpu_torch.cli get pods` lists its pods; /statusz shows
    the solves on the card (on `device` when given: "cpu" runs the plain
    versions); SIGTERM releases the lease and exits 0. Returns what it saw,
    with the child's launches per variant."""
    import base64
    import queue
    import shutil
    import signal
    import threading
    import urllib.request

    import yaml

    from grove_tpu_torch.deploy import _render_webhook_objects

    fx = fixture_apiserver()
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip-smoke-kube-")
    api = fx.FixtureApiServer()
    proc = None
    lines: list[str] = []
    out: dict = {"nodes": nodes}
    t0 = time.perf_counter()
    try:
        for i in range(nodes):
            api.add_node(fx.k8s_node(f"n{i}", cpu="32", memory="128Gi", labels={
                "topology.kubernetes.io/zone": "z0", "topology.kubernetes.io/block": "b0",
                "topology.kubernetes.io/rack": f"r{i % 4}"}))
        for doc in _render_webhook_objects("grove-system"):
            plural = doc["kind"].lower() + "s"
            if plural in api.webhookconfigs:
                api.webhookconfigs[plural][doc["metadata"]["name"]] = doc
        kubeconfig = os.path.join(work, "kubeconfig")
        with open(kubeconfig, "w") as f:
            yaml.safe_dump({
                "current-context": "fixture",
                "clusters": [{"name": "c", "cluster": {"server": api.url}}],
                "users": [{"name": "u", "user": {"token": "fixture-token"}}],
                "contexts": [{"name": "fixture", "context": {"cluster": "c", "user": "u"}}],
            }, f)
        cfg_path = os.path.join(work, "config.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({
                "log": {"format": "json"},
                "servers": {"bindAddress": "127.0.0.1", "healthPort": 0, "metricsPort": -1,
                            "webhookPort": 0, "tlsCertDir": os.path.join(work, "certs")},
                "backend": {"enabled": False},
                "controllers": {"reconcileIntervalSeconds": 0.05},
                "leaderElection": {"enabled": True, "leaseDurationSeconds": 15.0,
                                   "renewDeadlineSeconds": 10.0},
                "solver": {"shapeHistoryPath": os.path.join(work, "solve-shapes.json")},
                "persistence": {"path": os.path.join(work, "state.json")},
                "cluster": {"source": "kubernetes", "kubeconfig": kubeconfig},
            }, f)
        cmd = [sys.executable, "-m", "grove_tpu_torch.runtime", "--config", cfg_path]
        if device is not None:
            cmd += ["--device", str(device)]
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        started: queue.Queue = queue.Queue()

        def read_log():
            for line in proc.stderr:
                lines.append(line)
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict) and doc.get("msg") == "manager started":
                    started.put(doc)

        threading.Thread(target=read_log, daemon=True).start()

        def wait(what, cond):
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                check(proc.poll() is None, f"kubernetes: the binary exited {proc.returncode} "
                      f"waiting for {what}\n{''.join(lines[-40:])}")
                got = cond()
                if got:
                    return got
                time.sleep(0.05)
            raise AssertionError(f"kubernetes: timed out waiting for {what}\n"
                                 f"{''.join(lines[-40:])}")

        boot = wait("'manager started'", lambda: None if started.empty() else started.get())
        out["boot_s"] = time.perf_counter() - t0
        check(boot.get("leader") is True, f"kubernetes: not the leader at boot ({boot})")
        hp, wp = boot["health_port"], boot["webhook_port"]
        with open(os.path.join(work, "certs", "webhook", "tls.crt"), "rb") as f:
            bundle = base64.b64encode(f.read()).decode()
        patched = [wh["clientConfig"].get("caBundle") == bundle
                   for objs in api.webhookconfigs.values() for obj in objs.values()
                   for wh in obj["webhooks"]]
        check(patched and all(patched), "kubernetes: the boot caBundle patch did not land")
        lease = api.leases.get("grove-tpu-operator-leader", {}).get("spec", {})
        check(bool(lease.get("holderIdentity")), f"kubernetes: no lease holder ({lease})")
        out["lease_holder"] = lease["holderIdentity"]
        api.webhook_service_urls["grove-tpu-operator-webhook"] = f"https://127.0.0.1:{wp}"
        with open(os.path.join(root, "examples", "simple1.yaml")) as f:
            doc = yaml.safe_load(f)
        t_apply = time.perf_counter()
        api.apply_pcs(doc)
        check(not api.admission_denials, f"kubernetes: admission denied {api.admission_denials}")
        stored = api.podcliquesets["simple1"]
        check(stored["spec"]["template"]["cliques"][0]["spec"].get("minAvailable") is not None,
              "kubernetes: the stored CR is not the defaulted object")

        def served():
            for name, pod in sorted(api.pods.items()):
                if pod.get("spec", {}).get("nodeName"):
                    conds = pod.get("status", {}).get("conditions", [])
                    if not any(c["type"] == "Ready" and c["status"] == "True" for c in conds):
                        api.advance_pod(name)
            status = api.podcliquesets["simple1"].get("status", {})
            return status if (len(api.binding_log) >= 13
                              and status.get("availableReplicas") == 1) else None

        status = wait("simple1 bound, Ready and its status written back", served)
        out["schedule_s"] = time.perf_counter() - t_apply
        out["bindings"] = len(api.binding_log)
        out["created_pods"] = len(api.created_pods)
        out["gang_statuses"] = sorted(g["name"] for g in status.get("podGangStatuses", []))
        check(out["bindings"] == 13 and all(api.pods[p]["spec"].get("nodeName")
                                            for p, _ in api.binding_log),
              f"kubernetes: {out['bindings']} bindings")
        cli = subprocess.run([sys.executable, "-m", "grove_tpu_torch.cli", "--server",
                              f"http://127.0.0.1:{hp}", "get", "pods"], cwd=root,
                             capture_output=True, text=True, timeout=120)
        listed = [ln.split()[0] for ln in cli.stdout.splitlines()[1:] if ln.strip()]
        check(cli.returncode == 0 and sorted(listed) == sorted(p for p, _ in api.binding_log),
              f"kubernetes: `cli get pods` exit {cli.returncode}: {cli.stdout[:400]} "
              f"{cli.stderr[-400:]}")
        out["cli_pods"] = len(listed)
        with urllib.request.urlopen(f"http://127.0.0.1:{hp}/statusz", timeout=10) as r:
            statusz = json.loads(r.read())
        out["device"] = statusz["solver"]["device"]
        out["launches"] = dict(statusz["solver"]["device"]["launches"])
        out["watch"] = statusz["resilience"].get("watch")
        proc.send_signal(signal.SIGTERM)
        out["exit_code"] = proc.wait(timeout=60)
        out["lease_released"] = "grove-tpu-operator-leader" not in api.leases or not (
            api.leases["grove-tpu-operator-leader"]["spec"].get("holderIdentity"))
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        api.close()
        shutil.rmtree(work, ignore_errors=True)


def kubernetes_phase(dev, card) -> tuple[dict, dict]:
    """Phase 19: (a) bench.py's rollout scenario at full size (64 nodes,
    every other one revocable, the 90 s trace, a make-before-break rollout
    under two revocation storms) through the port's Manager on the card:
    every gate, the journal replayed on the card and on the CPU's plain
    versions with 0 divergences, the document == the CPU run's, wall-clock
    keys aside; (b) the operator binary on `cluster.source: kubernetes`
    against a fixture apiserver (kube_operator_binary); (c) the CLI's `tune
    sweep` over phase 15 (b)'s journal on the card, its verdict == the same
    verb's with `--device cpu`. Returns the launches per variant of (a) and
    of (b) with (c)."""
    import contextlib
    import io
    import shutil

    import torch

    from grove_tpu_torch.bench import manager_doc_core, run_rollout_bench
    from grove_tpu_torch.cli.main import main as cli_main
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    reset_launches()
    a = run_rollout_bench(device=dev, cpu_replay=True)
    torch.cuda.synchronize(dev)
    a_launches = dict(place_wave.variant_launches)
    print(f"rollout[64 nodes, {a['revocable_nodes']} revocable, {a['trace_duration_s']} s "
          f"trace]: gates {a['gates']}; offered {a['workloads_offered']}, bound "
          f"{a['workloads_bound']}, resident ready {a['resident_pods_ready']}, rollout "
          f"{a['rollout_counts']}, revocations {a['revocation_counts']}, budget peak "
          f"{a['budget_peak_in_flight']}/{a['budget_cap']}, tiers "
          f"{ {k: v['p99_bind_s'] for k, v in a['tiers'].items()} } p99 s; {a['sim_seconds']} "
          f"sim s in {a['wall_s']:.3f} s; replay on the card {a['replay_divergences']} "
          f"divergences over {a['replay_waves']} waves, on the CPU "
          f"{a['cpu_replay_divergences']} over {a['cpu_replay_waves']}; launches "
          f"{ {k: v for k, v in a_launches.items() if v} } on {card}")
    for gate, ok in a["gates"].items():
        check(ok, f"rollout: gate {gate} failed")
    check(a["vs_baseline"] == 1.0, f"rollout: vs_baseline {a['vs_baseline']}")
    check(a["cpu_replay_divergences"] == 0 and a["cpu_replay_waves"] == a["replay_waves"] > 0,
          f"rollout: CPU replay {a['cpu_replay_divergences']} divergences over "
          f"{a['cpu_replay_waves']} waves")
    check(a_launches["dense"] >= 1, f"rollout: no dense launch ({a_launches})")
    a_cpu = run_rollout_bench(device="cpu")
    core = manager_doc_core(a)
    core.pop("cpu_replay_divergences")
    core.pop("cpu_replay_waves")
    check(core == manager_doc_core(a_cpu),
          "rollout: the card's document != the CPU's (wall-clock keys aside)")
    print(f"rollout: every gate green, == the CPU's document (wall-clock keys aside); "
          f"{time.perf_counter() - t_phase:.1f} s")

    t_b = time.perf_counter()
    b = kube_operator_binary()
    b_launches = dict(b["launches"])
    print(f"kubernetes binary: booted in {b['boot_s']:.3f} s against a fixture apiserver of "
          f"{b['nodes']} nodes, the lease held, the caBundle patched; simple1 admitted by the "
          f"binary's webhooks, {b['created_pods']} pods created and {b['bindings']} bound "
          f"through the binding subresource, Ready with its status written back (gangs "
          f"{b['gang_statuses']}) in {b['schedule_s']:.3f} s; `cli get pods` listed "
          f"{b['cli_pods']}; /statusz device {b['device']['type']} {b['device']['name']}, watch "
          f"{b['watch']}, launches { {k: v for k, v in b_launches.items() if v} }; exit "
          f"{b['exit_code']}, lease released {b['lease_released']}; "
          f"{time.perf_counter() - t_b:.1f} s on {card}")
    check(b["device"]["type"] == "cuda", f"kubernetes: solves on {b['device']}")
    check(b_launches["dense"] >= 1, f"kubernetes: no dense launch in the child ({b_launches})")
    check(b["exit_code"] == 0 and b["lease_released"],
          f"kubernetes: exit {b['exit_code']}, lease released {b['lease_released']}")

    t_c = time.perf_counter()
    argv = ["tune", "sweep", "--path", PHASE15_JOURNAL, "--k", "4", "--rungs", "2", "--json"]
    verdicts = {}
    try:
        for device in ("cuda", "cpu"):
            text = io.StringIO()
            torch.cuda.synchronize(dev)
            reset_launches()
            with contextlib.redirect_stdout(text):
                code = cli_main(["--device", device, *argv])
            torch.cuda.synchronize(dev)
            if device == "cuda":
                c_launches = dict(place_wave.variant_launches)
            body = text.getvalue()
            check(code == 0, f"tune[{device}]: exit {code}: {body[-400:]}")
            verdicts[device] = without_seconds(json.loads(body[:body.rindex("}") + 1]))
    finally:
        shutil.rmtree(PHASE15_JOURNAL, ignore_errors=True)
    print(f"tune (cli) over phase 15 (b)'s journal: winner {verdicts['cuda']['winner']['name']}, "
          f"valid {verdicts['cuda']['valid']}, launches "
          f"{ {k: v for k, v in c_launches.items() if v} }; "
          f"{time.perf_counter() - t_c:.1f} s on {card}")
    check(verdicts["cuda"] == verdicts["cpu"], "tune: the card's verdict != --device cpu's")
    check(sum(c_launches.values()) >= 1, f"tune: no launch on the card ({c_launches})")
    print(f"kubernetes phase {time.perf_counter() - t_phase:.1f} s")
    return a_launches, {k: b_launches.get(k, 0) + c_launches.get(k, 0)
                        for k in set(b_launches) | set(c_launches)}


def quality_phase(dev, card) -> dict:
    """Phase 20: bench.py's quality scenario (run_quality_bench) on the card
    at portfolio 1 (B1+B2: "dense" launches) and 4 (B5: "portfolio"
    launches), each document == the same call's on the CPU's plain
    versions, the measured wave latencies aside. Returns the launches per
    variant of the two card runs."""
    import torch

    from grove_tpu_torch.bench import QUALITY_WALL_KEYS, run_quality_bench
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    def core(doc):
        return {k: v for k, v in doc.items() if k not in QUALITY_WALL_KEYS}

    t_phase = time.perf_counter()
    launches: dict = {}
    for portfolio, variant in ((1, "dense"), (4, "portfolio")):
        t_card = time.perf_counter()
        torch.cuda.synchronize(dev)
        reset_launches()
        doc = run_quality_bench(portfolio, device=dev)
        torch.cuda.synchronize(dev)
        got = dict(place_wave.variant_launches)
        t_cpu = time.perf_counter()
        cpu = run_quality_bench(portfolio, device="cpu")
        t_end = time.perf_counter()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"quality[portfolio {portfolio}]: {json.dumps(doc)}")
        print(f"quality[portfolio {portfolio}]: launches "
              f"{ {k: v for k, v in got.items() if v} }; card run {t_cpu - t_card:.2f} s, CPU "
              f"run {t_end - t_cpu:.2f} s; on {card}")
        check(core(doc) == core(cpu), f"quality[portfolio {portfolio}]: the card's document != "
              f"the CPU's (wave latencies aside): {core(doc)} != {core(cpu)}")
        check(got.get(variant, 0) >= 1, f"quality[portfolio {portfolio}]: no {variant} launch "
              f"({got})")
        check(doc["solver_gangs"] == 12 and doc["exact_gangs"] == 4
              and doc["exact_states_explored"] > 0,
              f"quality[portfolio {portfolio}]: sizes {doc['solver_gangs']}, "
              f"{doc['exact_gangs']}, {doc['exact_states_explored']} states")
    print(f"quality: both documents == the CPU's (wave latencies aside); quality phase "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


SHARD_LADDER = (2, 4, 8)
# Phase 21 (c): a pruning config that prunes the shard scenario's 5120-node
# waves of 64 (1024 candidates in a pad of 2048, divisible by any S <= 8).
SHARD_PRUNING = dict(enabled=True, max_candidates=1024, min_fleet=256)


def shard_phase(dev, card, timed, compare, node_tensors, snap_b, first, gangs_b, snap_4,
                first_4, plan4, dense_bound, pruned_bound, nondyadic) -> dict:
    """Phase 21: the node-sharded solve (B7) on virtual shards of the card.
    (a) place_wave_sharded at S = 2, 4, 8 == sharded_solve_ref on the same
    card inputs (tolerance 0) and == the single launch (B1), dense (bench
    wave 0, 5120 nodes) and pruned (8191 of 20480 nodes, pad 8192), with
    each S's time beside B1's (comparison launches, not counted); (b)
    run_shard_bench on the card, every step's digest equal and equal to a
    plain drain of the same problem on the CPU; (c) a pruned pipelined
    drain journaled under S = 4 replayed on the card with 0 divergences,
    the layout rebuilt and unsharded. The launches of (b) and (c) are the
    phase's main path. `nondyadic` (snapshot, batch) is phase 3's 64-gang
    wave on non-dyadic free capacity, where the split sums need not be
    exact: B7 == sharded_solve_ref there too, and whether it also equals B1
    is printed (a finding, not a gate). Returns {"rows": the kernels line's
    B7 rows, "launches": per variant}."""
    import numpy as np
    import torch

    from grove_tpu_torch.bench import bindings_digest, run_shard_bench, shard_worker_problem
    from grove_tpu_torch.kernels.place_wave import (
        domain_index,
        domain_index_sharded,
        place_wave,
        place_wave_sharded,
        reset_launches,
    )
    from grove_tpu_torch.parallel import mesh as mesh_mod
    from grove_tpu_torch.solver.core import SolverParams, batch_to
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.solver.pruning import PruningConfig
    from grove_tpu_torch.solver.reference import sharded_solve_ref
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal
    from grove_tpu_torch.trace.replay import replay_journal

    t_phase = time.perf_counter()
    params = SolverParams()
    okg0 = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    pt4 = plan4.tensors(dev)
    cases = {
        "dense": (node_tensors(snap_b), batch_to(first, dev), None, None,
                  domain_index(snap_b.node_domain_id, dev)),
        "pruned": ((node_tensors(snap_4)[0], pt4.capacity, pt4.schedulable, pt4.node_domain_id),
                   batch_to(plan4.gather_batch(first_4), dev), pt4.cand_idx, plan4.count,
                   pt4.domains),
    }
    rows, err = [], {}
    for kind, (node, tb, cand, count, dom1) in cases.items():
        extra1 = {} if cand is None else {"cand_idx": cand, "cand_count": count}
        b1 = place_wave(node[0].clone(), *node[1:], tb, params, okg0.clone(), domains=dom1,
                        **extra1)
        b1_ms, _ = time_variant(place_wave, timed, node, tb, okg0, params, dom1, extra1, None)
        ms, plain_ms, err[kind] = {}, {}, 0.0
        n_axis = node[1].shape[0]
        for shards in SHARD_LADDER:
            dom_s = domain_index_sharded(node[3], shards, dev)
            spans = [(s * n_axis // shards, (s + 1) * n_axis // shards) for s in range(shards)]
            want, plain_ms[shards] = timed(lambda: sharded_solve_ref(
                node[0].clone(), *node[1:], tb, params, okg0.clone(), spans, cand, count))
            extra = {"cand_idx": cand, "cand_count": count} if cand is not None else {}
            got = place_wave_sharded(node[0].clone(), *node[1:], tb, params, okg0.clone(),
                                     shards=shards, domains=dom_s, **extra)
            torch.cuda.synchronize()
            err[kind] = max(err[kind], compare(f"B7 {kind}, S={shards}", got, want),
                            compare(f"B7 {kind}, S={shards}, against B1", got, b1))

            def launch(free, *rest, domains=None, **kw):
                return place_wave_sharded(free, *rest, shards=shards, domains=dom_s, **kw)

            ms[shards], _ = time_variant(launch, timed, node, tb, okg0, params, dom_s, extra,
                                         None)
            print(f"exact[B7 {kind}, S={shards}, N={n_axis}]: admitted {int(want[1].sum())}/"
                  f"{int(tb.gang_valid.sum())} valid — kernel == plain == B1 on "
                  f"{', '.join(NAMES)}; kernel {ms[shards]:.3f} ms (B1 {b1_ms:.3f} ms), plain "
                  f"{plain_ms[shards]:.1f} ms on {card}")
        bound = dense_bound if kind == "dense" else pruned_bound
        top = SHARD_LADDER[-1]
        rows.append({
            "name": f"place_wave_sharded(B7, {kind})", "route": "cuda",
            "source": "grove_tpu_torch/kernels/csrc/place_wave.cu",
            "replaces": "grove_tpu/solver/core.py:708", "launches": 0,
            "max_abs_err": err[kind], "ms": ms[top], "plain_ms": plain_ms[top],
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "shards": top, "ms_by_shards": {str(k): v for k, v in ms.items()},
            "plain_ms_by_shards": {str(k): v for k, v in plain_ms.items()}, "b1_ms": b1_ms,
        })

    # Non-dyadic free capacity: the split sums' order shows in their last bits.
    snap_nd, batch_nd = nondyadic
    node, tb = node_tensors(snap_nd), batch_to(batch_nd, dev)
    b1 = place_wave(node[0].clone(), *node[1:], tb, params, okg0.clone(),
                    domains=domain_index(snap_nd.node_domain_id, dev))
    n_axis = node[1].shape[0]
    for shards in SHARD_LADDER:
        spans = [(s * n_axis // shards, (s + 1) * n_axis // shards) for s in range(shards)]
        want = sharded_solve_ref(node[0].clone(), *node[1:], tb, params, okg0.clone(), spans)
        got = place_wave_sharded(node[0].clone(), *node[1:], tb, params, okg0.clone(),
                                 shards=shards,
                                 domains=domain_index_sharded(node[3], shards, dev))
        torch.cuda.synchronize()
        compare(f"B7 non-dyadic, S={shards}", got, want)
        same = [nm for nm, a, b in zip(NAMES, got, b1) if torch.equal(a, b)]
        print(f"exact[B7 non-dyadic, S={shards}, N={n_axis}, G={tb.gang_valid.shape[0]}]: kernel "
              f"== plain on {', '.join(NAMES)}; == B1 on {', '.join(same) or 'none'}")

    # (b) the shard scenario's ladder on the card: the main path.
    torch.cuda.synchronize(dev)
    reset_launches()
    t_b = time.perf_counter()
    doc = run_shard_bench(device=dev)
    torch.cuda.synchronize(dev)
    launches = dict(place_wave.variant_launches)
    t_cpu = time.perf_counter()
    topo, nodes, gangs, pods, snap = shard_worker_problem()
    cpu_bindings, cpu_stats = drain_backlog(gangs, pods, snap, wave_size=64, device="cpu",
                                            warm_path=WarmPath())
    cpu_digest = bindings_digest(cpu_bindings)
    t_end = time.perf_counter()
    for p in doc["points"]:
        print(f"shard[S={p['devices_requested']}]: shard_devices {p['shard_devices']}, "
              f"solve_total_s {p['solve_total_s']} (encode {p['encode_s']}, dispatch "
              f"{p['dispatch_s']}, harvest {p['harvest_s']}), admitted {p['admitted']}/"
              f"{p['gangs']}, split {[d['nodeRows'] for d in p['per_device_split']]}, "
              f"fallbacks {p['shard_fallbacks']}, digest {p['bindings_sha256'][:16]} on {card}")
    print(f"shard: value {doc['value']} (reported, not gated: virtual shards share the card), "
          f"parity {doc['admitted_parity_across_devices']}, stream "
          f"{json.dumps(doc.get('stream_remeasure'))}; card ladder {t_cpu - t_b:.2f} s, CPU "
          f"plain drain {t_end - t_cpu:.2f} s (admitted {cpu_stats.admitted}); launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(doc["admitted_parity_across_devices"], "shard: the ladder's bindings digests differ")
    # bench.py's ladder counts no fallback: one shard is one device, and
    # 2, 4 and 8 divide the 5120-node axis.
    check(all(p["shard_fallbacks"] == 0 for p in doc["points"]),
          f"shard: fallbacks counted {[p['shard_fallbacks'] for p in doc['points']]}")
    check(all(p["bindings_sha256"] == cpu_digest for p in doc["points"]),
          "shard: the card's bindings differ from the CPU's plain drain")
    check([p["shard_devices"] for p in doc["points"]] == [0, 2, 4, 8],
          f"shard: shard_devices {[p['shard_devices'] for p in doc['points']]}")
    check(launches.get("sharded", 0) > 0, f"shard: no sharded launch on the ladder ({launches})")

    # (c) a pruned pipelined drain journaled under S = 4, replayed.
    journal = tempfile.mkdtemp(prefix="chip-smoke-shard-")
    mesh_mod.force_virtual_devices(4, dev)
    try:
        reset_launches()
        rec = TraceRecorder(os.path.join(journal, "j"))
        rec.start()
        try:
            pbind, pstats = drain_backlog(
                gangs, pods, snap, wave_size=64, harvest="pipeline", recorder=rec,
                pruning=PruningConfig(**SHARD_PRUNING), warm_path=WarmPath(), device=dev,
                mesh=mesh_mod.MeshConfig(enabled=True, min_nodes=64))
        finally:
            rec.stop()
        torch.cuda.synchronize(dev)
        records = read_journal(os.path.join(journal, "j"))
        rebuilt = replay_journal(records, device=dev)
    finally:
        mesh_mod.force_virtual_devices(0)
    unsharded = replay_journal(records, device=dev)
    ubind, _ = drain_backlog(gangs, pods, snap, wave_size=64, harvest="pipeline",
                             pruning=PruningConfig(**SHARD_PRUNING), warm_path=WarmPath(),
                             device=dev)
    torch.cuda.synchronize(dev)
    for k, v in place_wave.variant_launches.items():
        launches[k] = launches.get(k, 0) + v
    fps = [w["solver"].get("mesh") for w in records if w.get("kind") == "wave"]
    print(f"shard[journal, S=4, pruned {pstats.pruned_waves} waves, escalations "
          f"{pstats.escalations}]: {pstats.journaled_waves} waves journaled (mesh {fps[:1]}), "
          f"bindings == the unsharded pruned drain's {pbind == ubind}; replay divergences: "
          f"layout rebuilt {rebuilt.divergence_count}, unsharded {unsharded.divergence_count}")
    check(pbind == ubind, "shard: the pruned drain under S = 4 bound otherwise than unsharded")
    check(pstats.shard_devices == 4 and pstats.pruned_waves > 0 and pstats.journaled_waves > 0,
          f"shard: the journaled drain ran {pstats.shard_devices} shards, "
          f"{pstats.pruned_waves} pruned waves, {pstats.journaled_waves} journaled")
    check(fps and all(fp == {"portfolio": 1, "node": 4} for fp in fps),
          f"shard: journaled mesh fingerprints {fps[:3]}")
    check(rebuilt.divergence_count == 0 and unsharded.divergence_count == 0,
          f"shard: replay divergences {rebuilt.divergence_count}, {unsharded.divergence_count}")
    check(launches.get("sharded_pruned", 0) > 0,
          f"shard: no sharded_pruned launch on the main path ({launches})")
    print(f"shard phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"rows": rows, "launches": launches, "cpu_digest": cpu_digest}


# Phase 22: the depth the plain versions run at (gangs of a wave), and the
# portfolio meshes of 8 virtual devices at P = 4, 2 and 8.
MESH_PLAIN_GANGS = {4: 64, 2: 64, 8: 32}
MESH_SHAPES = {4: (4, 2), 2: (2, 4), 8: (8, 1)}


def mesh_phase(dev, card, timed, node_tensors, snap_b, gangs_b, encode_wave, plan_b, cut,
               snap_4, pruning, cpu_digest) -> dict:
    """Phase 22: the portfolio mesh (B5 x B7) and the scan over shards
    (B4 x B7) on virtual devices of the card. (a) on 8 virtual devices,
    solver_mesh_for gives (4, 2), (2, 4) and (8, 1) at P = 4, 2, 8 on bench
    wave 0 (5120 nodes, 256 gangs): the portfolio launch under each mesh
    (B5 x B7, the plain B5 at (8, 1)) == the unsharded B5 launch on every
    output, winner and objectives included, and == its plain version at a
    cut depth (MESH_PLAIN_GANGS gangs of the wave), each timed beside B5;
    (b) the first two-wave chunk of the 256-gang drain, dense at S = 2, 4,
    8 (5120 nodes) and pruned at S = 4 (8191 of 20480 nodes in a pad of
    8192): B4 x B7 == B4 on every output, and == its plain version on the
    chunk's waves cut to 32 gangs, each timed beside B4 (comparison
    launches, not counted); (c) the main path: the shard scenario's 313
    gangs drained "scan" and "resident" under 4 shards (digests == phase
    21's plain CPU drain, `cpu_digest`) and streamed in "scan" mode (==
    the CPU's plain formed-serial stream), and a portfolio=4 drain of them
    under the (4, 2) mesh (== the same drain unsharded on the card), and a
    pruned "scan" drain of them under 4 shards (== unsharded on the card);
    (d), run before (c), is nondyadic_fleet_check. Returns {"rows": the
    kernels line's rows, "launches": per variant}."""
    import numpy as np
    import torch

    from grove_tpu_torch.bench import bindings_digest, shard_worker_problem
    from grove_tpu_torch.kernels.place_wave import (
        domain_index,
        domain_index_sharded,
        domain_index_stacked_sharded,
        place_wave,
        reset_launches,
    )
    from grove_tpu_torch.parallel import mesh as mesh_mod
    from grove_tpu_torch.parallel.portfolio import params_population
    from grove_tpu_torch.solver.core import (
        SolverParams,
        batch_to,
        scan_pruned_solve,
        scan_solve,
        stack_on,
        stacked_dispatch,
    )
    from grove_tpu_torch.solver.drain import class_runs, drain_backlog
    from grove_tpu_torch.solver.encode import stack_batches
    from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates, stack_plans
    from grove_tpu_torch.solver.reference import (
        portfolio_select_ref,
        sharded_scan_pruned_solve_ref,
        sharded_scan_solve_ref,
        sharded_stacked_solve_ref,
        stacked_solve_ref,
    )
    from grove_tpu_torch.solver.stream import ScanConfig, StreamConfig, drain_stream
    from grove_tpu_torch.solver.warm import WarmPath

    t_phase = time.perf_counter()
    params = SolverParams()
    t_len = len(gangs_b)
    okg0 = torch.zeros(t_len, dtype=torch.bool, device=dev)
    n, r = snap_b.capacity.shape
    node = node_tensors(snap_b)
    dom1 = domain_index(snap_b.node_domain_id, dev)
    src = "grove_tpu_torch/kernels/csrc/place_wave.cu"

    def exact(label, names, got, want):
        for nm, a, b in zip(names, got, want):
            check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
                  f"mesh[{label}]: {nm} differs"
                  + ("" if a is None or b is None else f" at {torch.nonzero(a != b)[:8].tolist()}"))

    def launch_ms(fn, fresh, reps=3):
        """ms per launch of fn(free, okg): a warm-up, then the mean of
        `reps`, each on its own copy of the carry made before the clock."""
        copies = [(fresh(), okg0.clone()) for _ in range(reps + 1)]
        fn(*copies[0])
        _, ms = timed(lambda: [fn(*c) for c in copies[1:]])
        return ms / reps

    def spans(axis, shards):
        return [(s * axis // shards, (s + 1) * axis // shards) for s in range(shards)]

    sel = ("assigned", "ok", "placement_score", "free_after", "ok_global", "winner", "objectives")
    scan_names = ("assigned", "ok", "placement_score", "free_in", "okg_in", "free_after",
                  "ok_global")

    # ---- (a) B5 x B7 on bench wave 0 ------------------------------------------
    first_ws = plan_b[0]
    tb = batch_to(encode_wave(first_ws), dev)
    mesh_mod.force_virtual_devices(8, dev)
    pf = {}
    try:
        for p in (4, 2, 8):
            layout = mesh_mod.solver_mesh_for(p, n, dev)
            shape = (layout.portfolio_devices, layout.node_devices)
            check(shape == MESH_SHAPES[p], f"mesh[P={p}]: solver_mesh_for gave {shape}")
            k = layout.node_devices
            # Built before any launch is timed (a launch given none builds its own).
            dom = domain_index_sharded(snap_b.node_domain_id, k, dev) if k > 1 else dom1
            pstack = stack_on(params_population(p), dev)

            def portfolio(free, okg, batch=tb, layout=layout, pstack=pstack, dom=dom):
                return stacked_dispatch(free, *node[1:], batch, pstack, okg, select=True,
                                        device=dev, domains=dom, layout=layout)

            def b5(free, okg, batch=tb, pstack=pstack):
                return stacked_dispatch(free, *node[1:], batch, pstack, okg, select=True,
                                        device=dev, domains=dom1)

            got = portfolio(node_tensors(snap_b)[0], okg0.clone())
            want = b5(node_tensors(snap_b)[0], okg0.clone())
            rows = stacked_dispatch(node_tensors(snap_b)[0], *node[1:], tb, pstack, okg0.clone(),
                                    select=False, device=dev, domains=dom, layout=layout)
            torch.cuda.synchronize()
            exact(f"P={p} {shape} vs B5", sel, got, want)
            # The plain version at a cut depth, on the same card inputs.
            g_cut = MESH_PLAIN_GANGS[p]
            tb_cut = batch_to(encode_wave(cut(first_ws, g_cut)), dev)
            kern_cut = portfolio(node_tensors(snap_b)[0], okg0.clone(), batch=tb_cut)
            torch.cuda.synchronize()

            def plain():
                if k > 1:
                    rows_p = sharded_stacked_solve_ref(node_tensors(snap_b)[0], *node[1:], tb_cut,
                                                       pstack, okg0, spans(n, k))
                else:
                    rows_p = stacked_solve_ref(node_tensors(snap_b)[0], *node[1:], tb_cut, pstack,
                                               okg0)
                return portfolio_select_ref(*rows_p, tb_cut, okg0.clone())

            want_cut, plain_ms = timed(plain)
            exact(f"P={p} {shape}, {g_cut} gangs, vs plain", sel, kern_cut, want_cut)
            ms = launch_ms(portfolio, lambda: node_tensors(snap_b)[0])
            b5_ms = launch_ms(b5, lambda: node_tensors(snap_b)[0])
            okg_np = np.zeros(t_len, bool)
            work = [place_wave_work(encode_wave(first_ws), snap_b.node_domain_id, r, okg_np,
                                    rows[1][j].cpu().numpy()) for j in range(p)]
            bound = bound_of(sum(w[0] for w in work) + p * 2 * 4 * n * r,
                             sum(w[1] for w in work))
            pf[p] = dict(shape=shape, ms=ms, b5_ms=b5_ms, plain_ms=plain_ms, plain_gangs=g_cut,
                         bound=bound)
            print(f"mesh[P={p}, mesh {shape}, wave 0, G={tb.gang_valid.shape[0]}, N={n}]: "
                  f"{'B5 x B7' if k > 1 else 'B5'} == B5 on every output (winner "
                  f"{int(got[5])}, admitted {int(got[1].sum())}), == plain on its first "
                  f"{g_cut} gangs (winner {int(want_cut[5])}); {ms:.3f} ms beside B5's "
                  f"{b5_ms:.3f} ms, plain {plain_ms:.1f} ms ({g_cut} gangs), bound "
                  f"{bound[0]:.6f} ms ({bound[1]}) on {card}")
    finally:
        mesh_mod.force_virtual_devices(0)

    # ---- (b) B4 x B7 on the drain's first two-wave chunk ----------------------
    chunk = next(class_runs(plan_b))[:32]
    steps = [encode_wave(w) for w in chunk]
    tbs = batch_to(stack_batches(steps), dev)
    tbs_cut = batch_to(stack_batches([encode_wave(cut(w, 32)) for w in chunk]), dev)
    fresh = lambda: node_tensors(snap_b)[0]  # noqa: E731
    b4 = scan_solve(fresh(), *node[1:], tbs, params, okg0.clone(), retain=True, device=dev,
                    domains=dom1)
    # B4's work: each step under its entering ok_global and its verdicts.
    work = [place_wave_work(s, snap_b.node_domain_id, r, b4[4][w].cpu().numpy(),
                            b4[1][w].cpu().numpy()) for w, s in enumerate(steps)]
    scan_bound = bound_of(sum(x[0] for x in work) + len(steps) * (4 * snap_b.capacity.size + t_len),
                          sum(x[1] for x in work))
    b4_ms = launch_ms(lambda f, o: scan_solve(f, *node[1:], tbs, params, o, retain=True,
                                              device=dev, domains=dom1), fresh)
    scan = {}
    for shards in SHARD_LADDER:
        layout = mesh_mod.solve_layout_for(n, mesh_mod.force_virtual_devices(shards, dev))
        dom_sh = domain_index_sharded(snap_b.node_domain_id, shards, dev)
        try:
            check(layout is not None and layout.node_devices == shards,
                  f"mesh[scan]: no {shards}-shard layout")
            got = scan_solve(fresh(), *node[1:], tbs, params, okg0.clone(), retain=True,
                             device=dev, domains=dom_sh, layout=layout)
            torch.cuda.synchronize()
            exact(f"B4 x B7, S={shards} vs B4", scan_names, got, b4)
            kern_cut = scan_solve(fresh(), *node[1:], tbs_cut, params, okg0.clone(), retain=True,
                                  device=dev, domains=dom_sh, layout=layout)
            torch.cuda.synchronize()
            want_cut, plain_ms = timed(lambda: sharded_scan_solve_ref(
                fresh(), *node[1:], tbs_cut, params, okg0.clone(), True, spans(n, shards)))
            exact(f"B4 x B7, S={shards}, 32 gangs a step, vs plain", scan_names, kern_cut,
                  want_cut)
            ms = launch_ms(lambda f, o: scan_solve(f, *node[1:], tbs, params, o, retain=True,
                                                   device=dev, domains=dom_sh, layout=layout),
                           fresh)
        finally:
            mesh_mod.force_virtual_devices(0)
        scan[shards] = dict(ms=ms, plain_ms=plain_ms)
        print(f"mesh[scan, {len(steps)}-wave chunk, S={shards}, N={n}]: B4 x B7 == B4 on every "
              f"output (admitted {int(got[1].sum())}), == plain on 32 gangs a step; "
              f"{ms:.3f} ms beside B4's {b4_ms:.3f} ms, plain {plain_ms:.1f} ms (32 gangs a "
              f"step), bound {scan_bound[0]:.6f} ms ({scan_bound[1]}) on {card}")

    # The pruned chunk at 20480 nodes, under 4 shards.
    shards = 4
    n4 = snap_4.capacity.shape[0]
    fresh4 = lambda: node_tensors(snap_4)[0]  # noqa: E731
    steps4 = [encode_wave(w, snap_4) for w in chunk]
    plans = [plan_candidates(snap_4, b, pruning, mesh_axis=shards) for b in steps4]
    check(all(pl is not None and pl.pad % shards == 0 for pl in plans),
          "mesh[pruned scan]: a wave did not prune to a pad the shards divide")
    sp = stack_plans(plans, steps4, dev)
    dom_s = domain_index_stacked_sharded(sp.node_domain_id, shards, dev)
    pargs = (sp.cand_idx, sp.capacity, sp.schedulable, sp.node_domain_id, sp.batch, params)
    b4p = scan_pruned_solve(fresh4(), *pargs, okg0.clone(), retain=True, device=dev,
                            domains=sp.domains)
    b4p_ms = launch_ms(lambda f, o: scan_pruned_solve(f, *pargs, o, retain=True, device=dev,
                                                      domains=sp.domains), fresh4)
    steps4_cut = [encode_wave(cut(w, 32), snap_4) for w in chunk]
    plans_cut = [plan_candidates(snap_4, b, pruning, mesh_axis=shards) for b in steps4_cut]
    sp_cut = stack_plans(plans_cut, steps4_cut, dev)
    pargs_cut = (sp_cut.cand_idx, sp_cut.capacity, sp_cut.schedulable, sp_cut.node_domain_id,
                 sp_cut.batch, params)
    layout = mesh_mod.solve_layout_for(plans[0].pad, mesh_mod.force_virtual_devices(shards, dev))
    try:
        got = scan_pruned_solve(fresh4(), *pargs, okg0.clone(), retain=True, device=dev,
                                domains=dom_s, layout=layout)
        torch.cuda.synchronize()
        exact("pruned B4 x B7, S=4 vs B4", scan_names, got, b4p)
        kern_cut = scan_pruned_solve(
            fresh4(), *pargs_cut, okg0.clone(), retain=True, device=dev, layout=layout,
            domains=domain_index_stacked_sharded(sp_cut.node_domain_id, shards, dev))
        torch.cuda.synchronize()
        want_cut, pplain_ms = timed(lambda: sharded_scan_pruned_solve_ref(
            fresh4(), *pargs_cut, okg0.clone(), True, spans(plans_cut[0].pad, shards)))
        exact("pruned B4 x B7, S=4, 32 gangs a step, vs plain", scan_names, kern_cut, want_cut)
        pms = launch_ms(lambda f, o: scan_pruned_solve(f, *pargs, o, retain=True, device=dev,
                                                       domains=dom_s, layout=layout), fresh4)
    finally:
        mesh_mod.force_virtual_devices(0)
    work = [place_wave_work(pl.gather_batch(b), pl.node_domain_id, r, b4p[4][w].cpu().numpy(),
                            b4p[1][w].cpu().numpy(), carry_bytes=b3_bytes(pl.pad, pl.count, r))
            for w, (b, pl) in enumerate(zip(steps4, plans))]
    pbound = bound_of(sum(x[0] for x in work) + len(steps4) * (4 * snap_4.capacity.size + t_len),
                      sum(x[1] for x in work))
    print(f"mesh[pruned scan, {len(steps4)}-wave chunk, S=4, {plans[0].count} of {n4} nodes in a "
          f"pad of {plans[0].pad}]: B4 x B7 == B4 on every output (admitted "
          f"{int(got[1].sum())}), == plain on 32 gangs a step; {pms:.3f} ms beside B4's "
          f"{b4p_ms:.3f} ms, plain {pplain_ms:.1f} ms, bound {pbound[0]:.6f} ms ({pbound[1]}) "
          f"on {card}")

    # ---- (d) the sharded kernels on a fleet f32 holds inexactly ---------------
    nondyadic_fleet_check(dev, card, timed)

    # ---- (c) the main path: the shard backlog under the mesh ------------------
    _topo, _nodes, gangs, pods, snap = shard_worker_problem()
    cfg = StreamConfig(depth=2, wave_size=64)
    arrivals = [(0.0, g) for g in gangs]
    t_cpu = time.perf_counter()
    cpu_stream, _ = drain_stream(arrivals, pods, snap, config=cfg, pipeline=False,
                                 scan=ScanConfig(), device="cpu", warm_path=WarmPath())
    cpu_stream_s = time.perf_counter() - t_cpu
    torch.cuda.synchronize(dev)
    reset_launches()
    t_main = time.perf_counter()
    digests = {}
    mesh_mod.force_virtual_devices(shards, dev)
    try:
        meshcfg = mesh_mod.MeshConfig(enabled=True, min_nodes=64)
        for harvest in ("scan", "resident"):
            b, st = drain_backlog(gangs, pods, snap, wave_size=64, harvest=harvest, device=dev,
                                  warm_path=WarmPath(), mesh=meshcfg)
            digests[harvest] = bindings_digest(b)
            check(st.shard_devices == shards and st.scan_chunks > 0 and st.shard_fallbacks == 0,
                  f"mesh[{harvest}]: shard_devices {st.shard_devices}, chunks {st.scan_chunks}, "
                  f"fallbacks {st.shard_fallbacks}")
            print(f"mesh[{harvest} drain, S={shards}, {len(gangs)} gangs]: {st.waves} waves in "
                  f"{st.scan_chunks} chunks ({st.scanned_waves} waves), dispatches "
                  f"{st.dispatches}, round trips {st.device_roundtrips}, drain_s "
                  f"{st.total_s:.4f}, digest {digests[harvest][:16]} on {card}")
        sb, sst = drain_stream(arrivals, pods, snap, config=cfg, pipeline=True, scan=ScanConfig(),
                               device=dev, warm_path=WarmPath(), mesh=meshcfg)
        check(sst.mode == "scan" and sst.drain.shard_devices == shards
              and sst.drain.scan_chunks > 0,
              f"mesh[stream]: mode {sst.mode}, shard_devices {sst.drain.shard_devices}, chunks "
              f"{sst.drain.scan_chunks}")
        print(f"mesh[scan stream, S={shards}]: {sst.drain.waves} waves, {sst.drain.scan_chunks} "
              f"chunks, wall_s {sst.wall_s:.4f}; == the CPU's plain formed-serial stream "
              f"{sb == cpu_stream} ({cpu_stream_s:.1f} s on the CPU) on {card}")
        prb, prst = drain_backlog(gangs, pods, snap, wave_size=64, harvest="scan", device=dev,
                                  warm_path=WarmPath(), mesh=meshcfg,
                                  pruning=PruningConfig(**SHARD_PRUNING))
        check(prst.shard_devices == shards and prst.pruned_waves > 0 and prst.scan_chunks > 0,
              f"mesh[pruned scan]: shard_devices {prst.shard_devices}, pruned "
              f"{prst.pruned_waves}, chunks {prst.scan_chunks}")
        mesh_mod.force_virtual_devices(8, dev)
        pb, pst = drain_backlog(gangs, pods, snap, wave_size=64, portfolio=4, device=dev,
                                warm_path=WarmPath())
    finally:
        mesh_mod.force_virtual_devices(0)
    torch.cuda.synchronize(dev)
    main_s = time.perf_counter() - t_main
    launches = dict(place_wave.variant_launches)
    ub, ust = drain_backlog(gangs, pods, snap, wave_size=64, portfolio=4, device=dev,
                            warm_path=WarmPath())
    upb, upst = drain_backlog(gangs, pods, snap, wave_size=64, harvest="scan", device=dev,
                              warm_path=WarmPath(), pruning=PruningConfig(**SHARD_PRUNING))
    torch.cuda.synchronize(dev)
    check(prb == upb and np.array_equal(prst.free_after, upst.free_after),
          "mesh: the pruned scan drain under 4 shards differs from the unsharded one")
    print(f"mesh[pruned scan drain, S={shards}, pad {prst.candidate_pad}]: {prst.pruned_waves} "
          f"pruned waves in {prst.scan_chunks} chunks, escalations {prst.escalations}, == the "
          f"unsharded pruned scan drain on the card on {card}")
    check(digests["scan"] == digests["resident"] == cpu_digest,
          f"mesh: scanned drains' digests {digests} != the CPU's plain drain {cpu_digest[:16]}")
    check(sb == cpu_stream, "mesh: the scan stream under 4 shards binds otherwise than the CPU")
    check(pb == ub and np.array_equal(pst.free_after, ust.free_after),
          "mesh: the portfolio=4 drain under the (4, 2) mesh differs from the unsharded one")
    check(all(launches.get(v, 0) > 0 for v in ("scan_sharded", "scan_sharded_pruned"))
          and launches.get("portfolio_sharded", 0) == pst.waves,
          f"mesh: main-path launches {launches}")
    print(f"mesh[portfolio=4 drain, mesh (4, 2)]: {pst.waves} waves, admitted {pst.admitted}, == "
          f"the unsharded B5 drain; main path {main_s:.2f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase {time.perf_counter() - t_phase:.1f}"
          f" s on {card}")
    top = SHARD_LADDER[-1]
    return {"launches": launches, "rows": [
        {"name": "place_wave_stacked_sharded(B5 x B7, K=4, S=2, select)", "route": "cuda",
         "source": src, "replaces": "grove_tpu/parallel/portfolio.py:236", "launches": 0,
         "max_abs_err": 0.0, "ms": pf[4]["ms"], "plain_ms": pf[4]["plain_ms"],
         "plain_gangs": pf[4]["plain_gangs"], "bound_ms": pf[4]["bound"][0],
         "bound_by": pf[4]["bound"][1], "library_ms": None, "b5_ms": pf[4]["b5_ms"],
         "ms_by_mesh": {f"{v['shape'][0]}x{v['shape'][1]}": v["ms"] for v in pf.values()},
         "b5_ms_by_p": {str(p): v["b5_ms"] for p, v in pf.items()}},
        {"name": "place_wave_scan_sharded(B4 x B7, dense)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:790", "launches": 0, "max_abs_err": 0.0,
         "ms": scan[top]["ms"], "plain_ms": scan[top]["plain_ms"], "plain_gangs": 32,
         "bound_ms": scan_bound[0], "bound_by": scan_bound[1], "library_ms": None,
         "shards": top, "b4_ms": b4_ms,
         "ms_by_shards": {str(k): v["ms"] for k, v in scan.items()},
         "plain_ms_by_shards": {str(k): v["plain_ms"] for k, v in scan.items()}},
        {"name": "place_wave_scan_sharded(B4 x B7, pruned)", "route": "cuda", "source": src,
         "replaces": "grove_tpu/solver/core.py:873", "launches": 0, "max_abs_err": 0.0,
         "ms": pms, "plain_ms": pplain_ms, "plain_gangs": 32, "bound_ms": pbound[0],
         "bound_by": pbound[1], "library_ms": None, "shards": shards, "b4_ms": b4p_ms},
    ]}


def nondyadic_fleet_check(dev, card, timed) -> None:
    """Phase 22 (d): the sharded kernels on sim/workloads.py's non-dyadic
    fleet (160 nodes with pods of 100m-multiple CPU and non-power-of-two MiB
    memory bound on them, and the 24-gang backlog of such pods), where the
    free values and their domain sums are inexact in f32 and a node's free
    update rounds once: B7 at S = 2, 4, 8, dense and pruned (120
    candidates), B5 x B7 at (4, 2) with the select, and B4 x B7 at S = 4
    over three steps with the carries retained, each == its plain version on
    the same card inputs at tolerance 0 and == the unsharded kernel (B1, B5,
    B4). Comparison launches, not counted."""
    import numpy as np
    import torch

    from grove_tpu_torch.kernels.place_wave import (
        domain_index,
        domain_index_sharded,
        place_wave,
        place_wave_sharded,
    )
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.parallel import mesh as mesh_mod
    from grove_tpu_torch.parallel.portfolio import params_population
    from grove_tpu_torch.sim.workloads import bench_topology, nondyadic_backlog, nondyadic_cluster
    from grove_tpu_torch.state import build_snapshot
    from grove_tpu_torch.solver.core import (
        SolverParams,
        batch_to,
        scan_solve,
        stack_on,
        stacked_dispatch,
    )
    from grove_tpu_torch.solver.encode import encode_gangs, stack_batches
    from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates
    from grove_tpu_torch.solver.reference import (
        portfolio_select_ref,
        sharded_scan_solve_ref,
        sharded_solve_ref,
        sharded_stacked_solve_ref,
    )

    t0 = time.perf_counter()
    topo = bench_topology()
    nodes, bound = nondyadic_cluster()
    gangs, pods = [], {}
    for pcs in nondyadic_backlog():
        ds = expand_podcliqueset(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    snap = build_snapshot(nodes, topo, bound_pods=bound)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = encode_gangs(gangs, pods, snap, global_index_of=gidx)
    n = snap.capacity.shape[0]
    check(not np.all((np.asarray(snap.free, np.float32)[:, 0] * 4) % 1 == 0),
          "nondyadic: the fleet's free CPU lies on the quarter grid")
    params = SolverParams()
    okg0 = torch.zeros(len(gangs), dtype=torch.bool, device=dev)

    def fresh():
        return torch.as_tensor(snap.free, dtype=torch.float32, device=dev)

    node = (fresh(), *(torch.as_tensor(np.asarray(x), device=dev)
                       for x in (snap.capacity, snap.schedulable, snap.node_domain_id)))
    tb = batch_to(batch, dev)

    def spans(axis, shards):
        return [(s * axis // shards, (s + 1) * axis // shards) for s in range(shards)]

    def same(label, names, got, want):
        for nm, a, b in zip(names, got, want):
            check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
                  f"nondyadic[{label}]: {nm} differs"
                  + ("" if a is None or b is None else f" at {torch.nonzero(a != b)[:8].tolist()}"))

    plain_s = 0.0
    # B7, dense and pruned.
    b1 = place_wave(fresh(), *node[1:], tb, params, okg0.clone(),
                    domains=domain_index(snap.node_domain_id, dev))
    for shards in SHARD_LADDER:
        for pruned in (False, True):
            if pruned:
                plan = plan_candidates(snap, batch, PruningConfig(
                    enabled=True, max_candidates=120, min_fleet=16, min_pad=8), mesh_axis=shards)
                check(plan is not None and plan.pad % shards == 0,
                      f"nondyadic: no pruned plan at S={shards}")
                pt = plan.tensors(dev)
                rest, tbp = (pt.capacity, pt.schedulable, pt.node_domain_id), batch_to(
                    plan.gather_batch(batch), dev)
                cand = (pt.cand_idx, plan.count)
            else:
                rest, tbp, cand = node[1:], tb, (None, None)
            want, ms = timed(lambda: sharded_solve_ref(fresh(), *rest, tbp, params, okg0.clone(),
                                                       spans(rest[0].shape[0], shards), *cand))
            plain_s += ms / 1e3
            extra = {} if cand[0] is None else {"cand_idx": cand[0], "cand_count": cand[1]}
            got = place_wave_sharded(fresh(), *rest, tbp, params, okg0.clone(), shards=shards,
                                     domains=domain_index_sharded(rest[2], shards, dev), **extra)
            torch.cuda.synchronize()
            kind = "pruned" if pruned else "dense"
            same(f"B7 {kind}, S={shards}", NAMES, got, want)
            if not pruned:
                same(f"B7 dense, S={shards}, against B1", NAMES, got, b1)
            print(f"nondyadic[B7 {kind}, S={shards}, N={n}, G={len(gangs)}]: kernel == plain"
                  f"{' == B1' if not pruned else ''} on {', '.join(NAMES)} (admitted "
                  f"{int(want[1].sum())}) on {card}")

    sel = ("assigned", "ok", "placement_score", "free_after", "ok_global", "winner", "objectives")
    okg = torch.as_tensor(np.random.default_rng(5).random(len(gangs)) < 0.3, device=dev)
    pstack = stack_on(params_population(4), dev)
    mesh_mod.force_virtual_devices(8, dev)
    try:
        layout = mesh_mod.solver_mesh_for(4, n, dev)
        check((layout.portfolio_devices, layout.node_devices) == (4, 2),
              "nondyadic: solver_mesh_for(4) is not (4, 2)")
        got = stacked_dispatch(fresh(), *node[1:], tb, pstack, okg.clone(), select=True,
                               device=dev, layout=layout,
                               domains=domain_index_sharded(snap.node_domain_id, 2, dev))
        b5 = stacked_dispatch(fresh(), *node[1:], tb, pstack, okg.clone(), select=True,
                              device=dev, domains=domain_index(snap.node_domain_id, dev))
        torch.cuda.synchronize()
    finally:
        mesh_mod.force_virtual_devices(0)
    want, ms = timed(lambda: portfolio_select_ref(*sharded_stacked_solve_ref(
        fresh(), *node[1:], tb, pstack, okg, spans(n, 2)), tb, okg.clone()))
    plain_s += ms / 1e3
    same("B5 x B7 (4, 2)", sel, got, want)
    same("B5 x B7 (4, 2), against B5", sel, got, b5)
    print(f"nondyadic[B5 x B7, mesh (4, 2)]: kernel == plain == B5 on every output (winner "
          f"{int(got[5])}) on {card}")

    per = -(-len(gangs) // 3)
    shape = dict(max_groups=batch.group_req.shape[1], max_sets=batch.set_member.shape[1],
                 max_pods=batch.pod_group.shape[1], pad_gangs_to=per)
    steps = [encode_gangs(gangs[w * per:(w + 1) * per], pods, snap, global_index_of=gidx,
                          **shape)[0] for w in range(3)]
    tbs = batch_to(stack_batches(steps), dev)
    scan_names = ("assigned", "ok", "placement_score", "free_in", "okg_in", "free_after",
                  "ok_global")
    b4 = scan_solve(fresh(), *node[1:], tbs, params, okg0.clone(), retain=True, device=dev,
                    domains=domain_index(snap.node_domain_id, dev))
    layout = mesh_mod.solve_layout_for(n, mesh_mod.force_virtual_devices(4, dev))
    try:
        got = scan_solve(fresh(), *node[1:], tbs, params, okg0.clone(), retain=True, device=dev,
                         domains=domain_index_sharded(snap.node_domain_id, 4, dev),
                         layout=layout)
        torch.cuda.synchronize()
    finally:
        mesh_mod.force_virtual_devices(0)
    want, ms = timed(lambda: sharded_scan_solve_ref(fresh(), *node[1:], tbs, params,
                                                    okg0.clone(), True, spans(n, 4)))
    plain_s += ms / 1e3
    same("B4 x B7, S=4", scan_names, got, want)
    same("B4 x B7, S=4, against B4", scan_names, got, b4)
    print(f"nondyadic[B4 x B7, S=4, 3 steps of {per}]: kernel == plain == B4 on every output "
          f"(admitted {int(want[1].sum())}); plain versions {plain_s:.1f} s, check "
          f"{time.perf_counter() - t0:.1f} s on {card}")


def add_path_launches(rows, paths: dict) -> list:
    """The kernels line's rows with each later phase's launches (`paths`:
    phase name -> launches per variant) added to the first row of each
    variant (B5's row takes "stacked" and "portfolio"), and shown per phase
    as `launches_<phase>`."""
    variants_of = {
        "place_wave(B1+B2, dense, 5120 nodes)": ("dense",),
        "place_wave(B1+B2+B3, pruned)": ("pruned",),
        "place_wave_stacked(B5, K=4, select)": ("stacked", "portfolio"),
        "place_wave_scan(B4, dense)": ("scan",),
        "place_wave_scan(B4, pruned)": ("scan_pruned",),
        "place_wave_stacked_scan(B6)": ("stacked_scan",),
        "place_wave_sharded(B7, dense)": ("sharded",),
        "place_wave_sharded(B7, pruned)": ("sharded_pruned",),
        "place_wave_stacked_sharded(B5 x B7, K=4, S=2, select)": ("stacked_sharded",
                                                                  "portfolio_sharded"),
        "place_wave_scan_sharded(B4 x B7, dense)": ("scan_sharded",),
        "place_wave_scan_sharded(B4 x B7, pruned)": ("scan_sharded_pruned",),
    }
    out = []
    for row in rows:
        variants = variants_of.get(row["name"], ())
        extra = {f"launches_{name}": sum(counts.get(v, 0) for v in variants)
                 for name, counts in paths.items()}
        out.append({**row, "launches": row["launches"] + sum(extra.values()), **extra})
    return out


def cap_t(x):
    import torch

    return torch.as_tensor(x, dtype=torch.float32, device="cuda")


def sched_t(x):
    import torch

    return torch.as_tensor(x, dtype=torch.bool, device="cuda")


def ndid_t(x):
    import torch

    return torch.as_tensor(x, dtype=torch.int32, device="cuda")


def batch_t(b):
    from grove_tpu_torch.solver.core import batch_to

    return batch_to(b, "cuda")


def b3_bytes(pad: int, count: int, r: int) -> int:
    """B3's bytes at a plan's shape: the gather map read once, the
    candidates' fleet rows read once (gather) and written once (scatter)."""
    return 4 * pad + 2 * 4 * count * r


def place_wave_bound(batch, ndid, r, okg, ok, carry_bytes=None) -> tuple[float, str]:
    """(bound_ms, "bytes" | "operations") for one place_wave launch on this
    batch over the node axis of `ndid` ([L, N] domain ids): the larger of
    the bytes it must move (each input read once, each output written once)
    over HBM bandwidth and the f32 operations this data needs over the f32
    peak (place_wave_work)."""
    return bound_of(*place_wave_work(batch, ndid, r, okg, ok, carry_bytes))


def bound_of(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def place_wave_work(batch, ndid, r, okg, ok, carry_bytes=None) -> tuple[int, int]:
    """(bytes, f32 operations) of one place_wave launch. `carry_bytes` is the free carry's traffic, by default its N rows
    read and written once. `okg` is ok_global before the launch and `ok` the
    launch's verdicts: a gang runs when it is valid, its cross-wave
    dependency was admitted and its in-wave one too.

    Operations per gang that runs, one per add, compare or division: its
    spread walk (2N, with a spread level); the narrow-set tables at the
    levels some nested pass reads (N*(R + groups) adds), their feasibility
    (D*(R + groups) per set read) and the slots of each group a stage-1 walk
    reads, once per node (3R each); per pass that runs (a valid set with a
    required, or a preferred, level) its domain sums over the columns it
    carries (N*(R + groups + 2 + active sets + spread)) and each domain's
    feasibility and score (D*(that + R)); per group phase with pods to
    place (valid group, phase total > 0) the node scores (N*(6R + 7 + 3MS))
    and one top-k pass over N. The f32 peak of 67 TFLOP/s counts an FMA as
    two operations: these plain operations issue at half that rate, so the
    bound is up to 2x below what the SMs could reach."""
    import numpy as np

    ndid = np.asarray(ndid.cpu() if hasattr(ndid, "cpu") else ndid)
    levels, n = ndid.shape
    doms = [int(ndid[lv].max()) + 1 for lv in range(levels)]
    g, mg, _ = batch.group_req.shape
    ms = batch.set_member.shape[1]
    if carry_bytes is None:
        carry_bytes = 2 * 4 * n * r  # free in and out
    nbytes = carry_bytes + 4 * n * r + n + 4 * levels * n  # + capacity, sched, domains
    nbytes += sum(np.asarray(x).nbytes for x in batch if x is not None)
    nbytes += batch.pod_group.size * 4 + g * 5  # assigned, ok, score
    okg, ok = np.asarray(okg, bool), np.asarray(ok, bool)
    dg, dep = np.asarray(batch.depends_global), np.asarray(batch.depends_on)
    ran = np.asarray(batch.gang_valid, bool).copy()
    ran &= (dg < 0) | okg[np.clip(dg, 0, len(okg) - 1)]
    ran &= (dep < 0) | ok[np.clip(dep, 0, g - 1)]
    req, pref = np.asarray(batch.set_req_level), np.asarray(batch.set_pref_level)
    sval = np.asarray(batch.set_valid, bool)
    gval = np.asarray(batch.group_valid, bool)
    raw_member = np.asarray(batch.set_member, bool)  # overlap reads it as is
    member = raw_member & gval[:, None, :]  # a set's valid groups
    total, required = np.asarray(batch.group_total), np.asarray(batch.group_required)
    spread_level = batch.spread_level
    ops = 0
    for gi in np.flatnonzero(ran):
        sp = spread_level is not None and int(spread_level[gi]) >= 0
        ops += 2 * n if sp else 0
        nested = sval[gi] & (req[gi] >= 0)
        active = [[s2 for s2 in range(ms) if sval[gi, s2] and req[gi, s2] > req[gi, s]
                   and (raw_member[gi, s] & raw_member[gi, s2]).any()]
                  if nested[s] else [] for s in range(ms)]
        read = sorted({s2 for a in active for s2 in a})
        tables = {}
        for s2 in read:
            lv = int(np.clip(req[gi, s2], 0, levels - 1))
            tables.setdefault(lv, set()).update(np.flatnonzero(member[gi, s2]).tolist())
            ops += doms[lv] * (r + int(member[gi, s2].sum()))
        ops += sum(n * (r + len(grp)) for grp in tables.values())
        slot_groups = set().union(*tables.values()) if tables else set()
        for s in range(ms):
            ng = int(member[gi, s].sum())
            for level, acts in ((req[gi, s], active[s]), (pref[gi, s], [])):
                if not sval[gi, s] or level < 0:
                    continue
                slot_groups.update(np.flatnonzero(member[gi, s]).tolist())
                k = r + ng + 2 + len(acts) + sp
                ops += n * k + doms[int(np.clip(level, 0, levels - 1))] * (k + r)
        ops += len(slot_groups) * n * 3 * r
        for grp in np.flatnonzero(gval[gi]):
            for phase_total in (required[gi, grp], total[gi, grp] - required[gi, grp]):
                if phase_total > 0:
                    ops += n * (6 * r + 7 + 3 * ms) + n
    return nbytes, ops


if __name__ == "__main__":
    sys.exit(main())
