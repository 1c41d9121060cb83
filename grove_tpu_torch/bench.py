"""The headline drains on the port: python -m grove_tpu_torch.bench

--scenario default drives bench.py's default scenario (`run_bench`, chained
harvest) through grove_tpu_torch: the 5120-node synthetic cluster, the
~10k-pod synthetic backlog, waves of 256 gangs, every wave solved by one
place_wave kernel launch on the card (with --portfolio P > 1 one stacked
launch of P weight variants, the winner picked on the card). The backlog is
drained twice through one warm path (solver/warm.py, bench.py's cold/warm
pair): the first drain prepares every shape's launch (compile_s) and fills
the encode rows, the second replays the prepared launches and reuses every
row (warm_*); its shape history goes to GROVE_BENCH_SHAPE_HISTORY (default
grove-tpu-state/solve-shapes.json under the temporary directory). Unless
--harvest chained, the same backlog is drained again with harvest="wave"
(the host waits for every wave), so wave_p50_s / wave_p99_s are measured
per-gang bind latencies — every gang of a wave lands at that wave's
completion stamp — where the chained headline can only say p50 = p99 = the
drain wall. One JSON line
with run_bench's drain fields, the card's name and power limit, and the
kernel's launch counts; unless --no-baseline, also run_bench's quality
fields under its names: the greedy per-pod baseline on the same backlog
(baseline_*, quality_admitted_ratio), the contended scenario solved by the
port's solve() against greedy (contended_*), and the mixed Required /
Preferred backlog scored by the placement-quality report (mixed_*), both
solves at the same portfolio width as the drain.

--scenario scale drives bench.py's `run_scale_bench` sweep: the same backlog
on growing fleets (racks per block 16 x each scale: 5120, 10240 and 20480
nodes at scales 1, 2, 4), drained dense and candidate-pruned
(max_candidates 8191, min_fleet 256). One JSON line with, per scale, both
drain walls and their stages, candidate_nodes/candidate_pad, escalations,
the launches of each kernel variant, and whether both admit the same set;
then, at the top scale, run_scale_bench's harvest A/B: the pruned drain
pipelined and scanned (B4: one launch per run of same-shape waves) and the
dense drain resident (scan launches, one harvest), with their round-trip
ledgers, host stages and launches, and whether each admits the set its
chained counterpart admits.

--scenario stream drives bench.py's streaming scenario (`run_stream_bench`):
a live arrival trace (arrival_process(20260804, 25 s, base rate 12): 317
events, 433 gangs, 2819 pods) admitted by drain_stream on a 1280-node fleet
(2 zones x 2 blocks x 16 racks x 20 hosts) at wave_size 64, depth 2, every
run through one warm path: a warm-up, then serial, pipelined (admitted-set
parity with serial), paced (arrivals visible at their offsets: measured
time-to-bind p50/p99), scan with class-affine forming against the formed
serial run (bitwise), and resident (bitwise; 1 + escalations round trips).
One JSON line with bench.py's keys and each run's launches per kernel
variant. bench.py's GROVE_HOST_REFERENCE host-loop A/B is left out: the port
keeps no retained host loops to compare with.

--scenario sweep drives bench.py's sweep scenario (`run_sweep_bench`): a
stream trace (arrival_process(7, 10 s, base rate 3), 58 gangs) streamed on
a 64-node fleet at wave_size 8, depth 2, journaled by the port's recorder
(27 waves), then replayed once cold and once timed (the single-config
replay), replayed once per config of a K = 16 grid (the serial baseline),
searched by successive halving over the grid at rungs 4 (cold, then timed)
and run through `recommend` (the bitwise-replay and exact-audit gates), with
bench.py's keys. Its second part, "scan_journal", is the default scenario's
backlog drained with harvest="scan" at waves of 32 (40 waves), without and
with the recorder (the record overhead), replayed, replayed per config
(serial K = 16) and swept under the whole grid (B5 for single waves, B6 for
each run of same-shape waves), with the engine's counters, the incumbent
row's divergences and the launches of each kernel variant.

--scenario chaos drives bench.py's chaos scenario (`run_chaos_bench`): the
12 s trace (arrival_process(20260804, 12 s, base rate 8): 175 gangs, 1117
pods) streamed onto 192 nodes (1 zone x 2 blocks x 8 racks x 12 hosts) at
wave_size 32, depth 2, resident scanned dispatch with forming and pruning
(min_fleet 64), under the standard fault schedule (16 dispatch errors after
2, 3 harvest hangs after 6) with the ladder armed (one retry per wave,
breakers at 2 failures, 0.02 s probation): warm-up, baseline, the armed run
without faults, the chaos run journaled and replayed, and the recorder's
ENOSPC probe, with bench.py's gates and keys plus the replay's and the
fault accounting's.

--scenario defrag drives bench.py's defrag scenario (`run_defrag_bench`):
one squatter gang scattered into every rack, the rack-packed big gang
unplaceable until the migration planner consolidates them; the plan's
solve time, moves, the big gang admitted after them and a warm re-plan with
no preparation.

--scenario replay drives bench.py's replay scenario (`run_replay_bench`, its
keys) through the port's GroveController under the Simulator: 16 nodes of 8
cpus, 5 rack-packed jobs (one rack too many), drained with the recorder off
and on (the record overhead), the journal replayed (the divergences) and a
+1-rack what-if over it; solves, the replay and the what-if on the card.
With --window-s S > 0 the record overhead is read on --rounds R rounds of
windows, OFF, ON, ON, OFF and ON, OFF, OFF, ON in turn (the first S seconds
of drains, untimed, set the count), every window and the recorder's cost by
part listed; with --aa the ON windows run without a recorder (an A/A
reading: the estimator's own spread).

--scenario tenancy drives bench.py's tenancy scenario (`run_tenancy_bench`)
through the port's Manager under the Simulator on 192 nodes: 200 churning
tenants, a --duration-s trace (75 s) at 1.6 arrivals a second under an org
quota of 64 CPU, mid-trace chaos and the recorder, with bench.py's gates.

--scenario rollout drives bench.py's rollout scenario (`run_rollout_bench`)
through the port's Manager under the Simulator on 64 nodes, every other one
revocable: a --duration-s trace (90 s) at 1.2 arrivals a second from 60
tenants, a make-before-break rolling update of a 36-pod resident, two
revocation storms (3, then 8 busy revocable nodes, the second inside the
eviction lead) and the recorder, with bench.py's gates.

--scenario quality drives bench.py's quality scenario (`run_quality_bench`):
the mixed Required/Preferred backlog on bench.py's quality cluster (32
nodes, 12 gangs) solved at --portfolio P and scored by the placement-quality
report against the greedy per-pod baseline, the same backlog drained in
waves of 4 (measured wave_p50_s/wave_p99_s), and the solver against
quality/exact.py's branch and bound on a 12-node, 4-gang sub-instance.

--scenario shard drives bench.py's shard scenario (`run_shard_bench`): one
backlog (a quarter of the default one) drained in waves of 64 on the
5120-node fleet under a node-sharded layout at each step of the ladder 1,
2, 4, 8 shards. The shards are virtual shards of the one card (kernel B7's
blocks, parallel/mesh.py `force_virtual_devices`), each step under a fresh
device list in this process: `devices` is the number of cards (1),
`shard_devices` the shards, `per_device_split` each shard's node rows, and
every step's bindings digest must be equal. The top step re-measures the
pipelined stream (`stream`). The speedup is reported, not gated: virtual
shards share one card's SMs and split the walks, not the chain.

--scenario serving serves bench.py's default backlog (900 sets, 1250 gangs,
10,000 pods) on its 5120-node fleet through GroveController (recorder on)
under the Simulator until every pod is Ready (`run_serving_bench`): ticks,
sim seconds to all-bound and all-Ready, each tick's wall, reconcile phases
and host stages, the solve passes, launches per variant, the floors wave's
solve time by CUDA events, and the gates (every gang scheduled, no node over
capacity, every set Available, the journal replayed on the CPU's plain
versions with 0 divergences).

  --scale S         default: cluster racks and backlog size times S (1.0);
                    stream: trace seconds and racks per block times S;
                    sweep: trace seconds and the scan journal's scenario times S;
                    defrag: blocks times S; replay: racks times S;
                    serving: racks per block times S
                    (1: 256 nodes, 20: 5120 nodes);
                    shard: racks per block times S (1: 5120 nodes)
  --portfolio P     default, quality: weight variants per wave and per solve (1)
  --no-baseline     default: skip the greedy baseline and the quality fields
  --harvest H       default: "wave" re-drains for measured latencies; "chained" skips it
  --scales A,B,..   scale: fleet scales (default 1,2,4)
  --backlog-frac F  scale, serving: backlog size times F (default 1.0);
                    shard: of the default backlog (default 0.25)
  --shards A,B,..   shard: the ladder of virtual shards (default 1,2,4,8)
  --prune-max K     scale: candidate budget (default 8191)
  --min-fleet M     scale: smallest fleet that prunes (default 256)
  --k K             sweep: configs in the grid (default 16)
  --window-s S      replay: seconds of drains in the first window (0: one drain)
  --rounds R        replay: rounds of windows, the order turning about (1)
  --aa              replay: ON windows without a recorder
  --duration-s T    tenancy, rollout: the arrival trace's seconds (75, 90)
  --device D        "cuda" (default) or "cpu" (plain PyTorch versions)

GROVE_FAULTS (faults/__init__.py's syntax) installs the port's fault
injector for the run, as the JAX package's manager does from its env.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from grove_tpu_torch.utils.platform import card_line


def build_backlog(frac: float = 1.0, spread_every: int = 0):
    """(gangs, pods_by_name) of the synthetic backlog at `frac` of its size.
    `spread_every` k > 0 gives every k-th PodCliqueSet two replicas spread
    across zones (the replica-spread planes)."""
    from grove_tpu_torch.api.types import TopologyDomain
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_backlog

    topo = bench_topology()
    backlog = synthetic_backlog(
        n_disagg=max(1, round(350 * frac)),
        n_agg=max(1, round(250 * frac)),
        n_frontend=max(1, round(300 * frac)),
    )
    if spread_every > 0:
        for pcs in backlog[::spread_every]:
            pcs.spec.replicas = 2
            pcs.spec.topology_spread_domain = TopologyDomain.ZONE
    gangs, pods = [], {}
    for pcs in backlog:
        ds = expand_podcliqueset(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    return gangs, pods


def build_fleet(scale: float = 1.0):
    """The synthetic cluster's snapshot with 16 x `scale` racks per block
    (4 zones x 4 blocks x racks x 20 hosts)."""
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_cluster
    from grove_tpu_torch.state import build_snapshot

    return build_snapshot(synthetic_cluster(racks_per_block=max(1, round(16 * scale))),
                          bench_topology())


def build_scenario(scale: float = 1.0):
    """(gangs, pods_by_name, snapshot, n_nodes, setup_s) of bench.py's
    default scenario at `scale`."""
    import gc

    t0 = time.perf_counter()
    gangs, pods = build_backlog(scale)
    snapshot = build_fleet(scale)
    # The set-up's objects are long-lived: collect now, so the interpreter's
    # first full collection over them (~0.12 s at full scale) does not land
    # inside the first timed drain.
    gc.collect()
    return gangs, pods, snapshot, snapshot.capacity.shape[0], time.perf_counter() - t0


def admitted_free(bindings, pods, snapshot):
    """The snapshot's free minus every bound pod's request, recomputed on
    the host in f32 (what a drain's free_after must equal)."""
    from grove_tpu_torch.state import pod_request_vector

    free = snapshot.free.astype(np.float32)
    idx = snapshot.node_index_map
    for pod_bindings in bindings.values():
        for pod_name, node_name in pod_bindings.items():
            i = idx[node_name]
            free[i] = free[i] - pod_request_vector(pods[pod_name], snapshot.resource_names)
    return free


def stage_fields(stats) -> dict:
    """A drain's wall and stages, unrounded."""
    return {
        "drain_s": stats.total_s,
        "encode_s": stats.encode_s,
        "prune_s": stats.prune_s,
        "dispatch_s": stats.dispatch_s,
        "harvest_s": stats.harvest_s,
        "decode_s": stats.decode_s,
        "waves": stats.waves,
        "admitted": stats.admitted,
        "pods_bound": stats.pods_bound,
        "pruned_waves": stats.pruned_waves,
        "candidate_nodes": stats.candidate_nodes,
        "candidate_pad": stats.candidate_pad,
        "escalations": stats.escalations,
        "escalations_adopted": stats.escalations_adopted,
        "harvest": stats.harvest,
        "dispatches": stats.dispatches,
        "device_roundtrips": stats.device_roundtrips,
        "scan_chunks": stats.scan_chunks,
        "scanned_waves": stats.scanned_waves,
    }


def shape_history_path() -> str:
    """bench.py's shape history file: GROVE_BENCH_SHAPE_HISTORY, by default
    grove-tpu-state/solve-shapes.json under the temporary directory."""
    import tempfile

    return os.environ.get(
        "GROVE_BENCH_SHAPE_HISTORY",
        os.path.join(tempfile.gettempdir(), "grove-tpu-state", "solve-shapes.json"),
    )


def run_bench(scale: float = 1.0, wave_size: int = 256, device=None, portfolio: int = 1,
              baseline: bool = True, harvest: str = "wave") -> dict:
    import torch

    from grove_tpu_torch.kernels.place_wave import place_wave
    from grove_tpu_torch.solver.core import SolverParams, resolve_device
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.solver.warm import WarmPath

    dev = resolve_device(device)
    gangs, pods, snapshot, n_nodes, setup_s = build_scenario(scale)
    build_s = 0.0
    launches0 = dict(place_wave.variant_launches)
    if dev.type == "cuda":
        from grove_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.load("place_wave")
        build_s = time.perf_counter() - t0
    warm_path = WarmPath()
    warm_path.executables.history_path = shape_history_path()
    bindings, stats = drain_backlog(
        gangs, pods, snapshot, wave_size=wave_size, params=SolverParams(), device=dev,
        portfolio=portfolio, warm_path=warm_path,
    )
    launches_cold = dict(place_wave.variant_launches)
    warm_bindings, warm_stats = drain_backlog(
        gangs, pods, snapshot, wave_size=wave_size, params=SolverParams(), device=dev,
        portfolio=portfolio, warm_path=warm_path,
    )
    if set(warm_bindings) != set(bindings):
        raise RuntimeError("bench: the warm drain admitted another set than the cold")
    total_s = stats.total_s
    admitted = stats.admitted

    def _num(x, nd):
        return round(x, nd) if math.isfinite(x) else None

    out = {
        # Chained harvest: every gang's bind latency is the drain wall.
        "value": _num(total_s, 4) if admitted else None,
        "p50_s": _num(total_s, 4) if admitted else None,
        "total_drain_s": round(total_s, 4),
        "gangs": len(gangs),
        "gangs_admitted": admitted,
        "gangs_rejected": len(gangs) - admitted,
        "pods": len(pods),
        "pods_bound": stats.pods_bound,
        "gangs_per_sec": round(admitted / total_s, 1),
        "pods_per_sec": round(stats.pods_bound / total_s, 1),
        "nodes": n_nodes,
        "scale": scale,
        "wave_size": wave_size,
        "portfolio": portfolio,
        "waves": stats.waves,
        "setup_s": round(setup_s, 3),
        "build_s": round(build_s, 3),
        "encode_s": round(stats.encode_s, 4),
        "dispatch_s": round(stats.dispatch_s, 4),
        "device_wait_s": round(stats.harvest_s, 4),
        "decode_s": round(stats.decode_s, 4),
        "solver_score": round(float(np.mean(stats.scores)), 4) if stats.scores else None,
        # The cold drain pays the launch preparation (compile_s); the warm
        # drain of the same shapes must prepare nothing and reuse every row.
        "compile_s": round(stats.compile_s, 4),
        "cold_total_s": round(stats.compile_s + stats.total_s, 4),
        "compile_cache_hits": stats.exec_cache_hits,
        "compile_cache_misses": stats.exec_cache_misses,
        "lowerings": stats.lowerings,
        "encode_reuse_hits": stats.encode_reuse_hits,
        "donated": stats.donated,
        "warm_total_s": round(warm_stats.compile_s + warm_stats.total_s, 4),
        "warm_compile_s": round(warm_stats.compile_s, 4),
        "warm_drain_s": round(warm_stats.total_s, 4),
        "warm_encode_s": round(warm_stats.encode_s, 4),
        "warm_dispatch_s": round(warm_stats.dispatch_s, 4),
        "warm_device_wait_s": round(warm_stats.harvest_s, 4),
        "warm_compile_cache_hits": warm_stats.exec_cache_hits,
        "warm_compile_cache_misses": warm_stats.exec_cache_misses,
        "warm_encode_reuse_hits": warm_stats.encode_reuse_hits,
        "warm_lowerings": warm_stats.lowerings,
        "harvest": harvest,
        "device": str(dev),
    }
    if dev.type == "cuda":
        out["kernel_launches"] = {
            k: n - launches0[k] for k, n in launches_cold.items()
        }
    if harvest == "wave":
        # The same backlog again, the host waiting for every wave: measured
        # per-gang bind latencies (bench.py's GROVE_BENCH_HARVEST=wave).
        wave_bindings, wstats = drain_backlog(
            gangs, pods, snapshot, wave_size=wave_size, params=SolverParams(), device=dev,
            portfolio=portfolio, harvest="wave", warm_path=warm_path,
        )
        if set(wave_bindings) != set(bindings):
            raise RuntimeError("bench: the wave harvest admitted another set than the chained")
        pct = wstats.latency_percentiles()
        out["wave_p50_s"] = _num(pct[50.0], 4) if pct else None
        out["wave_p99_s"] = _num(pct[99.0], 4) if pct else None
        out["wave_total_s"] = round(wstats.total_s, 4)
        out["wave_count"] = wstats.waves
        out["wave_device_roundtrips"] = wstats.device_roundtrips
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    if baseline:
        out.update(quality_fields(gangs, pods, snapshot, admitted, portfolio, dev))
    return out


def _expand(backlog):
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim.workloads import bench_topology

    gangs, pods = [], {}
    for pcs in backlog:
        ds = expand_podcliqueset(pcs, bench_topology())
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    return gangs, pods


def quality_fields(gangs, pods, snapshot, admitted, portfolio, dev) -> dict:
    """bench.py run_bench's quality fields, under its names: the greedy
    per-pod baseline on the drained backlog, the contended scenario
    (solver vs greedy admissions) and the mixed Required/Preferred backlog
    (placement-quality reports of both), the solves at `portfolio`."""
    from grove_tpu_torch.quality.report import evaluate_placement
    from grove_tpu_torch.sim import workloads as W
    from grove_tpu_torch.solver.core import SolverParams, decode_bindings, solve
    from grove_tpu_torch.solver.encode import encode_gangs
    from grove_tpu_torch.solver.greedy import greedy_drain
    from grove_tpu_torch.state import build_snapshot

    def solved(snap, g, p):
        batch, decode = encode_gangs(g, p, snap)
        res = solve(snap, batch, SolverParams(), portfolio=portfolio, device=dev)
        return decode_bindings(res.ok.cpu().numpy(), res.assigned.cpu().numpy(), decode, snap)

    gstats = greedy_drain(gangs, pods, snapshot)
    out = {
        "baseline_admitted": gstats.admitted,
        "baseline_pods_bound": gstats.pods_bound,
        "baseline_score": round(gstats.mean_score, 4),
        "baseline_elapsed_s": round(gstats.elapsed_s, 2),
        "quality_admitted_ratio": (
            round(admitted / gstats.admitted, 3) if gstats.admitted else None
        ),
    }
    nodes, squatters = W.contended_cluster()
    cgangs, cpods = _expand(W.contended_backlog(n_gangs=48))
    csnap = build_snapshot(nodes, W.bench_topology(), bound_pods=squatters)
    out.update(
        contended_gangs=len(cgangs),
        contended_solver_admitted=len(solved(csnap, cgangs, cpods)),
        contended_baseline_admitted=greedy_drain(cgangs, cpods, csnap).admitted,
        contended_portfolio=portfolio,
    )
    mgangs, mpods = _expand(W.mixed_backlog())
    msnap = build_snapshot(W.quality_cluster(), W.bench_topology())
    mrep = evaluate_placement(mgangs, mpods, msnap, solved(msnap, mgangs, mpods))
    grep = evaluate_placement(mgangs, mpods, msnap, greedy_drain(mgangs, mpods, msnap).bindings)
    out.update(mixed_gangs=len(mgangs), mixed_portfolio=portfolio)
    for who, rep in (("solver", mrep), ("greedy", grep)):
        out[f"mixed_{who}_admitted"] = rep.admitted
        out[f"mixed_{who}_placement_score"] = round(rep.mean_placement_score, 4)
        out[f"mixed_{who}_preferred_fraction"] = round(rep.preferred_fraction, 4)
        out[f"mixed_{who}_stranding_delta"] = round(rep.stranding_delta, 4)
    return out


def run_quality_bench(portfolio: int = 1, device=None) -> dict:
    """bench.py's `run_quality_bench` on the port, with its keys and
    rounding: the placement-quality report as the headline, three
    measurements under one solver configuration (`portfolio`, bench.py's
    GROVE_BENCH_PORTFOLIO):

      - mixed Required/Preferred backlog: solver-vs-greedy placement score
        via quality/report.py;
      - wave-level latency harvest of the same drain (measured p50/p99; a
        wave's stamp on the card is its completion event);
      - exact-solver bound: solver vs quality/exact.py branch-and-bound on
        a small sub-instance (admitted count + locality ratios).

    Solves and the drain run on `device` (None = the card)."""
    from grove_tpu_torch.quality.exact import exact_pack
    from grove_tpu_torch.quality.report import evaluate_placement
    from grove_tpu_torch.sim.workloads import bench_topology, mixed_backlog, quality_cluster
    from grove_tpu_torch.solver.core import (
        SolverParams,
        decode_assignments,
        resolve_device,
        solve,
    )
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.solver.encode import encode_gangs
    from grove_tpu_torch.solver.greedy import greedy_drain
    from grove_tpu_torch.state import build_snapshot

    dev = resolve_device(device)
    topo = bench_topology()

    # Mixed Required/Preferred scenario + wave harvest on its drain.
    nodes = quality_cluster()
    gangs, pods = _expand(mixed_backlog())
    snap = build_snapshot(nodes, topo)
    batch, decode = encode_gangs(gangs, pods, snap)
    result = solve(snap, batch, SolverParams(), portfolio=portfolio, device=dev)
    bindings = decode_assignments(result, decode, snap)
    solver_rep = evaluate_placement(gangs, pods, snap, bindings)
    gstats = greedy_drain(gangs, pods, snap)
    greedy_rep = evaluate_placement(gangs, pods, snap, gstats.bindings)
    _, wstats = drain_backlog(
        gangs, pods, snap, wave_size=4, portfolio=portfolio, harvest="wave", device=dev
    )
    wlat = (
        np.concatenate([np.full(n, t) for n, t in wstats.wave_latencies if n > 0])
        if any(n > 0 for n, _ in wstats.wave_latencies)
        else np.asarray([math.inf])
    )

    # Exact bound on a small sub-instance (quality/exact.py caps: <= 10
    # gangs x <= 16 nodes).
    enodes = quality_cluster(blocks=1, racks_per_block=3, hosts_per_rack=4)
    egangs, epods = _expand(mixed_backlog(n_required=2, n_preferred=2, preferred_pods=3))
    esnap = build_snapshot(enodes, topo)
    ebatch, edecode = encode_gangs(egangs, epods, esnap)
    eresult = solve(esnap, ebatch, SolverParams(), portfolio=portfolio, device=dev)
    e_bindings = decode_assignments(eresult, edecode, esnap)
    e_solver_rep = evaluate_placement(egangs, epods, esnap, e_bindings)
    exact = exact_pack(egangs, epods, esnap)

    greedy_score = greedy_rep.mean_placement_score
    solver_score = solver_rep.mean_placement_score
    return {
        "scenario": "quality",
        "metric": "placement_quality_score",
        "unit": "score",
        "value": round(solver_score, 4),
        # > 1.0 = the batched solver beats the per-pod greedy baseline on
        # the discriminating backlog.
        "vs_baseline": round(solver_score / greedy_score, 4) if greedy_score > 0 else 0.0,
        "portfolio": portfolio,
        **{f"solver_{k}": v for k, v in solver_rep.to_doc().items()},
        **{f"greedy_{k}": v for k, v in greedy_rep.to_doc().items()},
        "wave_p50_s": round(float(np.percentile(wlat, 50)), 4),
        "wave_p99_s": round(float(np.percentile(wlat, 99)), 4),
        "wave_count": wstats.waves,
        "exact_gangs": len(egangs),
        "exact_admitted": exact.admitted_count,
        "exact_mean_score": round(exact.mean_score, 4),
        "exact_states_explored": exact.states_explored,
        "solver_admitted_vs_exact": round(e_solver_rep.admitted / exact.admitted_count, 4)
        if exact.admitted_count
        else None,
        "solver_score_vs_exact": round(e_solver_rep.mean_placement_score / exact.mean_score, 4)
        if exact.mean_score > 0
        else None,
    }


# The quality document's wall-clock keys: a card run and a CPU run share the
# rest.
QUALITY_WALL_KEYS = ("wave_p50_s", "wave_p99_s")


def run_scale_bench(
    scales=(1.0, 2.0, 4.0),
    wave_size: int = 256,
    backlog_frac: float = 1.0,
    max_candidates: int = 8191,
    min_fleet: int = 256,
    device=None,
) -> dict:
    """The same backlog drained dense and candidate-pruned on each fleet
    scale; the drains of each scale must admit the same gang set."""
    import torch

    from grove_tpu_torch.solver.core import SolverParams, resolve_device
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.solver.pruning import PruningConfig

    dev = resolve_device(device)
    pruning = PruningConfig(enabled=True, max_candidates=max_candidates, min_fleet=min_fleet)
    gangs, pods = build_backlog(backlog_frac)
    points = []
    for scale in scales:
        snapshot = build_fleet(scale)
        point = {"scale": scale, "nodes": int(snapshot.capacity.shape[0])}
        admitted = {}
        for mode, cfg in (("dense", None), ("pruned", pruning)):
            if dev.type == "cuda":
                from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

                reset_launches()
            bindings, stats = drain_backlog(
                gangs, pods, snapshot, wave_size=wave_size, params=SolverParams(),
                device=dev, pruning=cfg,
            )
            point[mode] = stage_fields(stats)
            if dev.type == "cuda":
                point[mode]["launches"] = dict(place_wave.variant_launches)
            admitted[mode] = set(bindings)
        point["admitted_equal"] = admitted["dense"] == admitted["pruned"]
        point["pruned_speedup"] = point["dense"]["drain_s"] / point["pruned"]["drain_s"]
        points.append(point)
    harvests = harvest_ab(gangs, pods, snapshot, wave_size, pruning, admitted, dev)
    out = {
        "scenario": "scale",
        "gangs": len(gangs),
        "pods": len(pods),
        "wave_size": wave_size,
        "max_candidates": max_candidates,
        "min_fleet": min_fleet,
        "points": points,
        "admitted_equal": all(p["admitted_equal"] for p in points),
        **harvests,
        "device": str(dev),
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def harvest_ab(gangs, pods, snapshot, wave_size, pruning, admitted, dev) -> dict:
    """bench.py run_scale_bench's harvest fields at the top scale (names as
    there): the pruned drain pipelined and scanned, the dense drain resident
    (twice: the second must repeat the first bitwise), each against the set
    its chained drain (`admitted`) admitted."""
    from grove_tpu_torch.solver.core import SolverParams
    from grove_tpu_torch.solver.drain import class_runs, drain_backlog, plan_waves

    runs = {}
    for name, harvest, cfg in (("pipelined", "pipeline", pruning), ("scan", "scan", pruning),
                               ("resident", "resident", None), ("resident2", "resident", None)):
        if dev.type == "cuda":
            from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

            reset_launches()
        b, st = drain_backlog(gangs, pods, snapshot, wave_size=wave_size, params=SolverParams(),
                              device=dev, pruning=cfg, harvest=harvest)
        launches = dict(place_wave.variant_launches) if dev.type == "cuda" else None
        runs[name] = (b, st, launches)

    def per_wave_ms(st):
        return round(1000.0 * st.host_stages()["hostTotalS"] / st.waves, 3) if st.waves else None

    (b_pipe, s_pipe, _), (b_scan, s_scan, _) = runs["pipelined"], runs["scan"]
    (b_res, s_res, _), (b_res2, s_res2, _) = runs["resident"], runs["resident2"]
    out = {
        "scan_admitted_parity": set(b_scan) == set(b_pipe) == admitted["pruned"],
        "shape_class_runs": len(list(class_runs(plan_waves(gangs, wave_size)))),
        "scan_chunks": s_scan.scan_chunks,
        "scanned_waves": s_scan.scanned_waves,
        "scan_waves": s_scan.waves,
        "scan_escalations": s_scan.escalations,
        "resident_admitted_parity": set(b_res) == admitted["dense"] and b_res2 == b_res,
        "resident_ledger_ok": all(s.device_roundtrips == 1 + s.escalations
                                  for s in (s_res, s_res2)),
        "resident_escalations": s_res.escalations,
        "resident_scan_chunks": s_res.scan_chunks,
    }
    for name in ("scan", "pipelined", "resident"):
        _, st, launches = runs[name]
        out[f"device_roundtrips_{name}"] = st.device_roundtrips
        out[f"dispatches_{name}"] = st.dispatches
        out[f"host_per_wave_ms_{name}"] = per_wave_ms(st)
        out[f"host_stages_{name}"] = st.host_stages()
        out[f"drain_s_{name}"] = st.total_s
        if launches is not None:
            out[f"launches_{name}"] = launches
    return out


def record_drain(gangs, pods, snapshot, path: str, **drain_kw):
    """drain_backlog with a flight recorder journaling into `path`:
    (bindings, stats, recorder, records, walls). `walls` holds host seconds:
    "drain_s" until the drain's last binding (the writer thread may still
    be writing segments), "flush_s" until the writer has stopped, "read_s"
    to read the journal back."""
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal

    rec = TraceRecorder(path, max_records_per_file=64)
    rec.start()
    t0 = time.perf_counter()
    try:
        bindings, stats = drain_backlog(gangs, pods, snapshot, recorder=rec, **drain_kw)
    finally:
        t1 = time.perf_counter()
        rec.stop()
    t2 = time.perf_counter()
    records = read_journal(path)
    walls = {"drain_s": t1 - t0, "flush_s": t2 - t1, "read_s": time.perf_counter() - t2}
    return bindings, stats, rec, records, walls


def serial_replay(records, config, device, warm_path=None) -> None:
    """Replay every wave of `records` under one sweep config (the serial
    baseline of tuning: one replay per config)."""
    from grove_tpu_torch.trace.replay import snapshot_from_wave, solve_wave_record

    fleets, bases = {}, {}
    for r in records:
        if r.get("kind") == "fleet":
            fleets[r["digest"]] = r
        elif r.get("kind") == "wave":
            snap = snapshot_from_wave(r, fleets[r["fleet"]], bases=bases)
            solve_wave_record(r, snap, params=config.solver_params(), portfolio=config.portfolio,
                              escalate_portfolio=config.escalate_portfolio, device=device,
                              warm=warm_path)


SWEEP_WAVE_SIZE = 32  # the journal's waves: 40 at full scale, runs [11, 8, 10, 11]


def launch_counter(dev):
    """(reset, read) of the kernel's per-variant launch counts (None on the
    CPU, where no kernel launches)."""
    if dev.type != "cuda":
        return (lambda: None), (lambda: None)
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    return reset_launches, (lambda: dict(place_wave.variant_launches))


def stream_world(seed: int, duration: float, rate: float, zones: int, racks: int, hosts: int):
    """(events, arrivals, pods, snapshot): an arrival trace and the fleet of
    `zones` x 2 blocks x `racks` racks x `hosts` hosts it streams onto."""
    from grove_tpu_torch.sim.workloads import (
        arrival_process,
        bench_topology,
        expand_arrivals,
        synthetic_cluster,
    )
    from grove_tpu_torch.state import build_snapshot

    topo = bench_topology()
    nodes = synthetic_cluster(zones=zones, blocks_per_zone=2, racks_per_block=racks,
                              hosts_per_rack=hosts)
    events = arrival_process(seed, duration_s=duration, base_rate=rate)
    arrivals, pods = expand_arrivals(events, topo)
    return events, arrivals, pods, build_snapshot(nodes, topo)


# bench.py's stream settings: the trace's seed, seconds and base rate, the
# fleet's racks per block, the wave size and the pipeline depth.
STREAM_SEED, STREAM_DURATION_S, STREAM_RATE = 20260804, 25.0, 12.0
STREAM_RACKS, STREAM_WAVE_SIZE, STREAM_DEPTH = 16, 64, 2


def run_stream_bench(scale: float = 1.0, device=None) -> dict:
    """bench.py's `run_stream_bench` on the port: the runs of the module
    docstring over one trace and one warm path, walls on the host clock
    (each run ends with every wave retired). `scale` cuts the trace's
    seconds and the fleet's racks per block; the rate stays bench.py's."""
    import torch

    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.solver.drain import ScanConfig
    from grove_tpu_torch.solver.stream import StreamConfig, drain_stream
    from grove_tpu_torch.solver.warm import WarmPath

    dev = resolve_device(device)
    t0 = time.perf_counter()
    duration = STREAM_DURATION_S * scale
    racks = max(1, round(STREAM_RACKS * scale))
    events, arrivals, pods, snapshot = stream_world(STREAM_SEED, duration, STREAM_RATE, 2,
                                                    racks, 20)
    setup_s = time.perf_counter() - t0
    cfg = StreamConfig(depth=STREAM_DEPTH, wave_size=STREAM_WAVE_SIZE)
    wp = WarmPath()
    reset, read = launch_counter(dev)
    launches = {}

    def run(label, pipeline=True, pace=False, scan=None):
        reset()
        out = drain_stream(arrivals, pods, snapshot, config=cfg, warm_path=wp,
                           pipeline=pipeline, pace=pace, scan=scan, device=dev)
        launches[label] = read()
        return out

    _, s_warm = run("warmup")  # prepares every shape of the trace
    b_serial, s_serial = run("serial", pipeline=False)
    b_pipe, s_pipe = run("pipeline")
    parity = set(b_serial) == set(b_pipe)
    speedup = s_serial.wall_s / s_pipe.wall_s if s_pipe.wall_s > 0 else 0.0
    _, s_paced = run("paced", pace=True)
    paced_pct = s_paced.bind_percentiles((50.0, 99.0)) or {}
    b_scan, s_scan = run("scan", scan=True)
    b_formed, s_formed = run("formed_serial", pipeline=False, scan=True)
    scan_parity = b_scan == b_formed
    fused_frac = s_scan.drain.scanned_waves / s_scan.drain.waves if s_scan.drain.waves else 0.0
    scan_fused = s_scan.drain.scan_chunks >= 1 and fused_frac >= 0.5
    b_res, s_res = run("resident", scan=ScanConfig(device_resident=True))
    resident_parity = b_res == b_formed
    resident_ledger_ok = s_res.drain.device_roundtrips == 1 + s_res.drain.escalations

    def per_wave_ms(d):
        # Host participation per wave (the stage ledger's hostTotalS).
        return 1000.0 * d.host_stages()["hostTotalS"] / d.waves if d.waves else None

    target_speedup = 1.3
    gates = parity and scan_parity and scan_fused and resident_parity and resident_ledger_ok
    out = {
        "scenario": "stream",
        "metric": "stream_pipeline_speedup",
        "unit": "x",
        "value": speedup,
        # >= 1.0: the >= 1.3x pipelined-throughput target holds and every
        # parity, fusion and ledger gate held (bench.py's definition).
        "vs_baseline": (speedup / target_speedup) * (1.0 if gates else 0.0),
        "host_cpus": len(os.sched_getaffinity(0)),
        "nodes": int(snapshot.capacity.shape[0]),
        "setup_s": setup_s,
        "trace_duration_s": duration,
        "trace_base_rate": STREAM_RATE,
        "trace_seed": STREAM_SEED,
        "arrival_events": len(events),
        "gangs_offered": s_pipe.offered,
        "pods_offered": len(pods),
        "depth": STREAM_DEPTH,
        "wave_size": STREAM_WAVE_SIZE,
        "warmup_wall_s": s_warm.wall_s,
        "warmup_compile_s": s_warm.drain.compile_s,
        "warmup_lowerings": s_warm.drain.lowerings,
        "admitted_parity": parity,
        "serial_admitted": s_serial.admitted,
        "pipeline_admitted": s_pipe.admitted,
        "serial_wall_s": s_serial.wall_s,
        "pipeline_wall_s": s_pipe.wall_s,
        "serial_gangs_per_sec": s_serial.gangs_per_sec,
        "pipeline_gangs_per_sec": s_pipe.gangs_per_sec,
        "pipeline_waves": s_pipe.waves,
        "pipeline_windows": s_pipe.windows,
        "pipeline_lowerings": s_pipe.drain.lowerings,
        "pipeline_encode_s": s_pipe.drain.encode_s,
        "pipeline_dispatch_s": s_pipe.drain.dispatch_s,
        "pipeline_harvest_s": s_pipe.drain.harvest_s,
        "pipeline_decode_s": s_pipe.drain.decode_s,
        "host_stages_serial": s_serial.drain.host_stages(),
        "host_stages_pipeline": s_pipe.drain.host_stages(),
        "host_stages_paced": s_paced.drain.host_stages(),
        "host_stages_scan": s_scan.drain.host_stages(),
        "scan_bitwise_parity": scan_parity,
        "scan_admitted": s_scan.admitted,
        "scan_wall_s": s_scan.wall_s,
        "scan_gangs_per_sec": s_scan.gangs_per_sec,
        "scan_fused_gate": scan_fused,
        "fused_wave_fraction": fused_frac,
        "device_roundtrips_scan": s_scan.drain.device_roundtrips,
        "device_roundtrips_pipelined": s_pipe.drain.device_roundtrips,
        "dispatches_scan": s_scan.drain.dispatches,
        "dispatches_pipelined": s_pipe.drain.dispatches,
        "scan_chunks": s_scan.drain.scan_chunks,
        "scanned_waves": s_scan.drain.scanned_waves,
        "scan_escalations": s_scan.drain.escalations,
        "host_per_wave_ms_scan": per_wave_ms(s_scan.drain),
        "host_per_wave_ms_pipelined": per_wave_ms(s_pipe.drain),
        "resident_bitwise_parity": resident_parity,
        "resident_ledger_ok": resident_ledger_ok,
        "resident_admitted": s_res.admitted,
        "resident_wall_s": s_res.wall_s,
        "device_roundtrips_resident": s_res.drain.device_roundtrips,
        "dispatches_resident": s_res.drain.dispatches,
        "resident_escalations": s_res.drain.escalations,
        "resident_scan_chunks": s_res.drain.scan_chunks,
        "host_per_wave_ms_resident": per_wave_ms(s_res.drain),
        "host_stages_resident": s_res.drain.host_stages(),
        "host_stages_formed_serial": s_formed.drain.host_stages(),
        "host_blocked_serial_s": s_serial.drain.harvest_s,
        "host_blocked_pipeline_s": s_pipe.drain.harvest_s,
        "paced_admitted": s_paced.admitted,
        "paced_wall_s": s_paced.wall_s,
        "paced_bind_p50_s": paced_pct.get(50.0),
        "paced_bind_p99_s": paced_pct.get(99.0),
        "launches": launches if dev.type == "cuda" else None,
        "device": str(dev),
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def record_stream(arrivals, pods, snapshot, path: str, **stream_kw):
    """drain_stream with a flight recorder journaling into `path`:
    (bindings, stats, recorder, records)."""
    from grove_tpu_torch.solver.stream import drain_stream
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal

    rec = TraceRecorder(path, max_records_per_file=64)
    rec.start()
    try:
        bindings, stats = drain_stream(arrivals, pods, snapshot, recorder=rec, **stream_kw)
    finally:
        rec.stop()
    return bindings, stats, rec, read_journal(path)


# bench.py's sweep settings: the stream trace's seed, seconds and base rate,
# and the halving's rungs.
SWEEP_SEED, SWEEP_DURATION_S, SWEEP_RATE, SWEEP_RUNGS = 7, 10.0, 3.0, 4


def run_sweep_bench(scale: float = 1.0, k: int = 16, device=None) -> dict:
    """bench.py's `run_sweep_bench` on the port (the stream journal, the
    single and serial replays, halving and `recommend`), then the 40-wave
    scan journal's sweep (`scan_journal`, `run_scan_journal_sweep`).
    `scale` cuts the trace's seconds and the scan journal's scenario."""
    import shutil
    import tempfile

    import torch

    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.solver.stream import StreamConfig
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.trace.recorder import journal_stats
    from grove_tpu_torch.trace.replay import replay_journal
    from grove_tpu_torch.tuning import (
        default_grid,
        incumbent_config,
        recommend,
        successive_halving,
    )

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    reset, read = launch_counter(dev)
    duration = SWEEP_DURATION_S * scale
    _, arrivals, pods, snapshot = stream_world(SWEEP_SEED, duration, SWEEP_RATE, 1, 4, 8)
    rungs = SWEEP_RUNGS
    journal = tempfile.mkdtemp(prefix="grove-torch-sweep-stream-")
    try:
        _, sstats, rec, records = record_stream(
            arrivals, pods, snapshot, journal, config=StreamConfig(depth=2, wave_size=8),
            device=dev)
        jstats = journal_stats(journal)
    finally:
        shutil.rmtree(journal, ignore_errors=True)
    waves = sum(1 for r in records if r.get("kind") == "wave")
    # One warm path for every phase, as bench.py shares one.
    wp = WarmPath()
    replay_journal(records, warm_path=wp, device=dev)  # cold
    t0 = time.perf_counter()
    rep = replay_journal(records, warm_path=wp, device=dev)
    sync()
    t_single = time.perf_counter() - t0
    incumbent = incumbent_config(records)
    grid = default_grid(incumbent, k)
    t0 = time.perf_counter()
    for cfg in grid:
        serial_replay(records, cfg, dev, warm_path=wp)
    sync()
    t_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    successive_halving(records, default_grid(incumbent, k), rungs=rungs, warm_path=wp,
                       device=dev)
    sync()
    t_sweep_cold = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    engine, schedule = successive_halving(records, default_grid(incumbent, k), rungs=rungs,
                                          warm_path=wp, device=dev)
    sync()
    t_sweep = time.perf_counter() - t0
    halving_launches = read()
    reset()
    t0 = time.perf_counter()
    rec_doc = recommend(records, k=k, rungs=rungs, warm_path=wp, device=dev)
    sync()
    t_recommend = time.perf_counter() - t0
    recommend_launches = read()
    ratio = t_sweep / t_single if t_single > 0 else float("inf")
    ok = ratio <= 3.0 and rec_doc["valid"] and rep.divergence_count == 0
    out = {
        "scenario": "sweep",
        "metric": "sweep_vs_single_replay",
        "unit": "x",
        "value": ratio,
        "vs_baseline": 3.0 / ratio if ratio > 0 else 0.0,
        "gate_pass": ok,
        "k": k,
        "rungs": rungs,
        "trace": {
            "duration_s": duration,
            "rate": SWEEP_RATE,
            "seed": SWEEP_SEED,
            "nodes": int(snapshot.capacity.shape[0]),
            "gangs_offered": sstats.offered,
            "gangs_admitted": sstats.admitted,
            "waves": waves,
            "journal_records": len(records),
            "recorder_dropped": jstats["dropped"] + rec.dropped,
            "stream_wall_s": sstats.wall_s,
        },
        "single_replay_s": t_single,
        "serial_grid_s": t_serial,
        "sweep_cold_s": t_sweep_cold,
        "sweep_s": t_sweep,
        "recommend_s": t_recommend,
        "serial_vs_sweep": t_serial / t_sweep if t_sweep > 0 else None,
        "replay_divergences": rep.divergence_count,
        "sweep_stacked_solves": engine.stacked_solves,
        "sweep_scan_stacked_solves": engine.scan_stacked_solves,
        "sweep_fallback_solves": engine.fallback_solves,
        "survivors_per_rung": [len(r["configs"]) for r in schedule],
        "winner": rec_doc["winner"]["name"],
        "winner_valid": rec_doc["valid"],
        "winner_bitwise_divergences": rec_doc["validation"]["bitwiseReplay"]["divergences"],
        "journal_replay_divergences": rec_doc["validation"]["journalReplayDivergences"],
        "exact_audit": rec_doc["validation"]["exactAudit"],
        "host_cpus": os.cpu_count(),
        "launches_halving": halving_launches,
        "launches_recommend": recommend_launches,
        "scan_journal": run_scan_journal_sweep(scale, k, dev),
        "device": str(dev),
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def run_scan_journal_sweep(scale: float = 1.0, k: int = 16, device=None) -> dict:
    """Record the backlog's scan drain at SWEEP_WAVE_SIZE, then replay it
    once, once per config (serial) and as one sweep of K configs; walls on
    the host clock after a cold pass of each, every solve on the card."""
    import shutil
    import tempfile

    import torch

    from grove_tpu_torch.solver.core import SolverParams, resolve_device
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.trace.recorder import journal_stats
    from grove_tpu_torch.trace.replay import replay_journal
    from grove_tpu_torch.tuning import default_grid, incumbent_config, sweep_journal

    dev = resolve_device(device)
    gangs, pods, snapshot, n_nodes, setup_s = build_scenario(scale)
    kw = dict(wave_size=SWEEP_WAVE_SIZE, params=SolverParams(), harvest="scan", device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    reset, launches = launch_counter(dev)

    drain_backlog(gangs, pods, snapshot, **kw)  # warm-up: the build, first launches
    sync()
    t0 = time.perf_counter()
    plain_b, _ = drain_backlog(gangs, pods, snapshot, **kw)
    sync()
    unrecorded_s = time.perf_counter() - t0
    journal = tempfile.mkdtemp(prefix="grove-torch-sweep-")
    try:
        bindings, stats, rec, records, rwalls = record_drain(gangs, pods, snapshot, journal, **kw)
        jstats = journal_stats(journal)
        journal_bytes = sum(os.path.getsize(os.path.join(journal, f)) for f in os.listdir(journal))
    finally:
        shutil.rmtree(journal, ignore_errors=True)
    replay_journal(records, device=dev)  # cold
    t0 = time.perf_counter()
    rep = replay_journal(records, device=dev)
    sync()
    replay_s = time.perf_counter() - t0
    grid = default_grid(incumbent_config(records), k)
    t0 = time.perf_counter()
    for cfg in grid:
        serial_replay(records, cfg, dev)
    sync()
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_journal(records, grid, device=dev)
    sync()
    sweep_cold_s = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    engine = sweep_journal(records, grid, device=dev)
    sync()
    sweep_s = time.perf_counter() - t0
    doc = engine.to_doc()
    return {
        "nodes": int(n_nodes),
        "gangs": len(gangs),
        "pods": len(pods),
        "wave_size": SWEEP_WAVE_SIZE,
        "k": k,
        "setup_s": setup_s,
        "waves": stats.waves,
        "journaled_waves": stats.journaled_waves,
        "recorder_dropped": rec.dropped,
        "journal_dropped": jstats["dropped"],
        "journal_bytes": journal_bytes,
        "bindings_equal_unrecorded": bindings == plain_b,
        "unrecorded_drain_s": unrecorded_s,
        "recorded_drain_s": rwalls["drain_s"],
        "journal_s": stats.journal_s,
        "record_overhead": rwalls["drain_s"] / unrecorded_s,
        "recorder_flush_s": rwalls["flush_s"],
        "journal_read_s": rwalls["read_s"],
        "replay_s": replay_s,
        "replay_divergences": rep.divergence_count,
        "serial_s": serial_s,
        "sweep_cold_s": sweep_cold_s,
        "sweep_s": sweep_s,
        "sweep_ratio": sweep_s / replay_s,
        "serial_ratio": serial_s / replay_s,
        "vs_baseline": 3.0 / (sweep_s / replay_s),
        "stackedSolves": doc["stackedSolves"],
        "scanStackedSolves": doc["scanStackedSolves"],
        "fallbackSolves": doc["fallbackSolves"],
        "incumbent_divergences": engine.tallies["incumbent"].divergences,
        "incumbent_admitted": engine.tallies["incumbent"].admitted,
        "launches": launches(),
    }


# bench.py's chaos settings: the trace, the fleet (1 zone x 2 blocks x 8
# racks x 12 hosts), the stream config, the pruning floor, the standard fault
# schedule and the ladder (run_chaos_bench).
CHAOS_SEED, CHAOS_DURATION_S, CHAOS_RATE = 20260804, 12.0, 8.0
CHAOS_RACKS, CHAOS_HOSTS, CHAOS_WAVE_SIZE, CHAOS_DEPTH = 8, 12, 32, 2
CHAOS_MIN_FLEET = 64
CHAOS_P99_CAP = 10.0


def chaos_faults(seed: int = CHAOS_SEED):
    """The standard fault schedule: 16 dispatch errors after the first 2
    evaluations (with one retry per wave, 8 retry-exhausted waves: 2 breaker
    trips on each of resident, scan, pruning and pipeline), then 3 harvest
    hangs after 6 evaluations."""
    from grove_tpu_torch.faults import FaultInjector, SiteSpec

    return FaultInjector({
        "solver.dispatch": SiteSpec(kind="error", rate=1.0, count=16, after=2),
        "solver.harvest": SiteSpec(kind="timeout", rate=1.0, count=3, after=6),
    }, seed=seed)


def chaos_resilience():
    """The chaos ladder's config: a 30 s watchdog, one retry per wave,
    breakers that open on 2 failures in 300 s, and 0.02 s of probation."""
    from grove_tpu_torch.solver.resilience import ResilienceConfig

    return ResilienceConfig(enabled=True, watchdog_seconds=30.0, max_wave_retries=1,
                            breaker_threshold=2, breaker_window_seconds=300.0,
                            probation_seconds=0.02)


def fault_accounting(injector, drain_stats, ladder) -> bool:
    """Every retry, timeout and ladder failure of a run explained by the
    injector's fires: each dispatch fire is a retry or ends a wave's budget
    (a ladder failure); each harvest fire is a watchdog timeout, and a
    wave's fetch that spends its budget on them is a ladder failure (its
    timeouts less its re-dispatches). No real error or hang is left over."""
    fired = {site: st["fired"] for site, st in injector.stats()["sites"].items()}
    d = drain_stats
    dispatch_failures = fired.get("solver.dispatch", 0) - d.wave_retries
    hang_failures = d.watchdog_timeouts - d.wave_redispatches
    return (d.watchdog_timeouts == fired.get("solver.harvest", 0)
            and ladder.wave_failures == dispatch_failures + hang_failures)


def same_as_baseline(bindings, drain_stats, base_bindings, base_stats) -> bool:
    """A faulted run against the fault-free one: without a pruned wave every
    rung of the ladder binds bitwise alike (scanned == per-wave, a
    re-dispatch re-solves from its retained entering carry), so the
    bindings and the fleet's free capacity after must be equal. A pruned
    wave may bind other nodes than its dense step-down (the admitted set
    stays), so then only the admitted set is held."""
    if drain_stats.pruned_waves or base_stats.pruned_waves:
        return set(bindings) == set(base_bindings)
    return bindings == base_bindings and np.array_equal(drain_stats.free_after,
                                                       base_stats.free_after)


def double_bound(bindings) -> list:
    """Pods bound by more than one gang's bindings."""
    seen: dict[str, int] = {}
    for gang_bindings in bindings.values():
        for pod_name in gang_bindings:
            seen[pod_name] = seen.get(pod_name, 0) + 1
    return sorted(p for p, n in seen.items() if n > 1)


def recorder_enospc_probe(seed: int = CHAOS_SEED) -> dict:
    """One injected ENOSPC into a recorder's segment write (its own injector
    and recorder): the writer must survive in counting-drops mode, latch
    `degraded`, clear it at the next good write, and stamp the episode into
    the later segments."""
    import tempfile

    from grove_tpu_torch import faults as faults_mod
    from grove_tpu_torch.faults import FaultInjector, SiteSpec
    from grove_tpu_torch.trace.recorder import TraceRecorder, journal_stats

    path = tempfile.mkdtemp(prefix="grove-chaos-enospc-")
    inj = FaultInjector({"recorder.write": SiteSpec(kind="enospc", rate=1.0, count=1)},
                        seed=seed)
    rec = TraceRecorder(path, max_records_per_file=4)
    faults_mod.install(inj)
    latched = False
    try:
        rec.start()
        for k in range(12):
            rec.capture_action(float(k), "chaos.probe", f"obj-{k}")
            if k == 3:
                rec.flush()  # the first segment: the injected ENOSPC
                latched = rec.degraded
        rec.flush()
    finally:
        rec.stop()
        faults_mod.install(None)
    st = journal_stats(path)
    return {"write_errors": rec.write_errors, "dropped": rec.dropped,
            "degraded_latched": latched, "degraded_cleared": not rec.degraded,
            "journal_write_errors": st["writeErrors"], "journal_degraded": st["degraded"],
            "survived": (rec.write_errors >= 1 and rec.dropped >= 1 and latched
                         and not rec.degraded and st["writeErrors"] >= 1 and st["degraded"])}


def run_chaos_bench(device=None) -> dict:
    """bench.py's `run_chaos_bench` on the port: the streaming drain under the
    standard fault schedule with the degradation ladder armed, starting at
    the top rung (resident scanned dispatch, class-affine forming, pruning).

    Phases over one warm path: a warm-up; the fault-free BASELINE; the same
    run with the ladder ARMED and no injector (zero retries, timeouts and
    step-downs, the baseline's bindings: no real error is absorbed, and the
    armed, undonated launches are prepared here); CHAOS, with the injector,
    a flight recorder journaling every wave and every fire, and the ladder
    stepping down and back up on probation; the chaos journal REPLAYED;
    the recorder's ENOSPC probe. `vs_baseline` is 1.0 only when every gate
    holds. The trace is bench.py's 12 s one, uncut (its
    GROVE_BENCH_CHAOS_SOAK long trace is not ported)."""
    import tempfile
    import time as _time

    import torch

    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.solver.drain import ScanConfig
    from grove_tpu_torch.solver.pruning import PruningConfig
    from grove_tpu_torch.solver.resilience import DegradationLadder
    from grove_tpu_torch.solver.stream import StreamConfig, drain_stream
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal
    from grove_tpu_torch.trace.replay import replay_journal

    dev = resolve_device(device)
    t0 = time.perf_counter()
    events, arrivals, pods, snapshot = stream_world(
        CHAOS_SEED, CHAOS_DURATION_S, CHAOS_RATE, 1, CHAOS_RACKS, CHAOS_HOSTS)
    setup_s = time.perf_counter() - t0
    cfg = StreamConfig(depth=CHAOS_DEPTH, wave_size=CHAOS_WAVE_SIZE)
    pruning = PruningConfig(enabled=True, min_fleet=CHAOS_MIN_FLEET)
    scan_cfg = ScanConfig(device_resident=True)
    wp = WarmPath()
    reset, read = launch_counter(dev)
    launches = {}

    def run(label, **kw):
        reset()
        out = drain_stream(arrivals, pods, snapshot, config=cfg, warm_path=wp, pruning=pruning,
                           pipeline=True, scan=scan_cfg, device=dev, **kw)
        launches[label] = read()
        return out

    run("warmup")
    b_base, s_base = run("baseline")
    quiet = DegradationLadder(chaos_resilience(), clock=_time.monotonic)
    b_armed, s_armed = run("armed", resilience=quiet)
    armed_quiet = (b_armed == b_base and not any(s_armed.drain.resilience_doc().values())
                   and quiet.wave_failures == 0
                   and sum(c["stepDowns"] for c in quiet.counters().values()) == 0)

    injector = chaos_faults()
    ladder = DegradationLadder(chaos_resilience(), clock=_time.monotonic)
    trace_dir = tempfile.mkdtemp(prefix="grove-chaos-trace-")
    recorder = TraceRecorder(trace_dir)
    recorder.start()
    injector.recorder = recorder  # fires journal as action records
    try:
        b_chaos, s_chaos = run("chaos", faults=injector, resilience=ladder, recorder=recorder)
        recorder.flush()
    finally:
        recorder.stop()

    lost = sorted(set(b_base) - set(b_chaos))
    extra = sorted(set(b_chaos) - set(b_base))
    same_placements = same_as_baseline(b_chaos, s_chaos.drain, b_base, s_base.drain)
    doubles = double_bound(b_chaos)
    records = read_journal(trace_dir)
    journaled_faults = sum(1 for r in records
                           if r.get("kind") == "action" and r.get("action") == "fault.injected")
    fired = injector.total_fired()
    counters = ladder.counters()
    step_downs = sum(c["stepDowns"] for c in counters.values())
    step_ups = sum(c["stepUps"] for c in counters.values())
    walked = all(counters[r]["stepDowns"] >= 1
                 for r in ("resident", "scan", "pruning", "pipeline"))
    replay = replay_journal(records, warm_path=wp, device=dev)
    p99_base = (s_base.bind_percentiles((99.0,)) or {}).get(99.0, 0.0)
    p99_chaos = (s_chaos.bind_percentiles((99.0,)) or {}).get(99.0, 0.0)
    inflation = p99_chaos / p99_base if p99_base > 0 else None
    enospc = recorder_enospc_probe()
    gates = {
        "zero_lost_gangs": not lost and not extra and same_placements,
        "zero_double_bound_pods": not doubles,
        "faults_journaled": journaled_faults == fired and fired > 0,
        "fault_accounting": fault_accounting(injector, s_chaos.drain, ladder),
        "armed_without_faults_quiet": armed_quiet,
        "ladder_recovered": ladder.fully_closed() and step_downs > 0 and step_ups > 0,
        "ladder_walked_to_pipeline": walked,
        "journal_replays_bitwise": replay.divergence_count == 0,
        "p99_inflation_bounded": inflation is not None and inflation <= CHAOS_P99_CAP,
        "recorder_counting_drops": enospc["survived"],
    }
    out = {
        "scenario": "chaos",
        "metric": "chaos_bind_p99_inflation",
        "unit": "x",
        "value": inflation,
        "vs_baseline": 1.0 if all(gates.values()) else 0.0,
        "gates": gates,
        "host_cpus": len(os.sched_getaffinity(0)),
        "nodes": int(snapshot.capacity.shape[0]),
        "setup_s": setup_s,
        "trace_duration_s": CHAOS_DURATION_S,
        "trace_seed": CHAOS_SEED,
        "gangs_offered": s_chaos.offered,
        "pods_offered": len(pods),
        "baseline_admitted": s_base.admitted,
        "chaos_admitted": s_chaos.admitted,
        "lost_gangs": lost[:8],
        "same_placements": same_placements,
        "double_bound_pods": doubles[:8],
        "faults_fired": fired,
        "faults_journaled": journaled_faults,
        "fault_sites": injector.stats()["sites"],
        "wave_retries": s_chaos.drain.wave_retries,
        "watchdog_timeouts": s_chaos.drain.watchdog_timeouts,
        "waves_cancelled": s_chaos.drain.waves_cancelled,
        "wave_redispatches": s_chaos.drain.wave_redispatches,
        "armed_resilience": s_armed.drain.resilience_doc(),
        "armed_lowerings": s_armed.drain.lowerings,
        "chaos_lowerings": s_chaos.drain.lowerings,
        "ladder": ladder.stats(),
        "ladder_rungs": counters,
        "step_downs": step_downs,
        "step_ups": step_ups,
        "journaled_waves": s_chaos.drain.journaled_waves,
        "replay_divergences": replay.divergence_count,
        "baseline_bind_p99_s": p99_base,
        "chaos_bind_p99_s": p99_chaos,
        "p99_cap": CHAOS_P99_CAP,
        "baseline_wall_s": s_base.wall_s,
        "chaos_wall_s": s_chaos.wall_s,
        "host_stages_chaos": s_chaos.drain.host_stages(),
        "recorder_enospc": enospc,
        "launches": launches if dev.type == "cuda" else None,
        "device": str(dev),
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def defrag_world(scale: float = 1.0, hosts_per_rack: int = 8, racks_per_block: int = 4):
    """bench.py's defrag world: round(8 * scale) blocks of `racks_per_block`
    racks of `hosts_per_rack` hosts, one 2-pod squatter gang bound into
    every rack (the state churn leaves behind), and the rack-packed big
    gang. Returns (topo, nodes, squatter gangs, squatter pods, big gangs,
    every pod)."""
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim.workloads import (
        BLOCK_KEY,
        RACK_KEY,
        bench_topology,
        fragmented_backlog,
        synthetic_cluster,
    )

    blocks = max(1, round(8 * scale))
    topo = bench_topology()
    nodes = synthetic_cluster(zones=1, blocks_per_zone=blocks, racks_per_block=racks_per_block,
                              hosts_per_rack=hosts_per_rack)
    squat_pcs, big_pcs = fragmented_backlog(blocks * racks_per_block,
                                            hosts_per_rack=hosts_per_rack)
    rack_nodes: dict[tuple[str, str], list[str]] = {}
    for n in nodes:
        rack_nodes.setdefault((n.labels[BLOCK_KEY], n.labels[RACK_KEY]), []).append(n.name)
    rack_list = sorted(rack_nodes)
    gangs, pods = [], {}
    for i, pcs in enumerate(squat_pcs):
        ds = expand_podcliqueset(pcs, topo)
        gangs.extend(ds.podgangs)
        for j, pod in enumerate(ds.pods):
            pod.node_name = rack_nodes[rack_list[i]][j]
            pods[pod.name] = pod
    ds_big = expand_podcliqueset(big_pcs, topo)
    all_pods = dict(pods)
    all_pods.update({p.name: p for p in ds_big.pods})
    return topo, nodes, gangs, pods, ds_big.podgangs, all_pods


def admit_gangs(gangs, pods, snapshot, warm_path, device) -> int:
    """How many of `gangs` one solve() admits on `snapshot`."""
    from grove_tpu_torch.solver.core import SolverParams, decode_bindings, solve
    from grove_tpu_torch.solver.encode import encode_gangs

    batch, decode = encode_gangs(gangs, pods, snapshot)
    res = solve(snapshot, batch, SolverParams(), warm=warm_path, device=device)
    return len(decode_bindings(res.ok.cpu().numpy(), res.assigned.cpu().numpy(), decode,
                               snapshot))


def run_defrag_bench(scale: float = 1.0, device=None) -> dict:
    """bench.py's `run_defrag_bench` on the port: a fleet with one squatter
    gang scattered into every rack, where the rack-packed big gang fails
    admission despite ample total free capacity. The migration planner's
    plan (every candidate solve through solve() and the warm path), its
    moves executed, the big gang admitted after them, and a re-plan of the
    restored state that must prepare no launch. `scale` 1 is 256 nodes and
    32 squatters, 20 is 5120 nodes and 640."""
    import torch

    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.solver.defrag import fragmentation_report, plan_migrations
    from grove_tpu_torch.solver.encode import next_pow2
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.state import build_snapshot

    dev = resolve_device(device)
    topo, nodes, gangs, pods, big_gangs, all_pods = defrag_world(scale)
    pad = next_pow2(len(nodes))
    snap_before = build_snapshot(nodes, topo, bound_pods=list(pods.values()), pad_nodes_to=pad)
    rep_before = fragmentation_report(snap_before)
    wp = WarmPath()
    reset, read = launch_counter(dev)
    admitted_before = admit_gangs(big_gangs, all_pods, snap_before, wp, dev)
    reset()
    t0 = time.perf_counter()
    plan = plan_migrations(nodes, topo, gangs, dict(pods), warm=wp, max_moves=len(gangs),
                           device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plan_wall_s = time.perf_counter() - t0
    plan_launches = read()
    out: dict = {
        "scenario": "defrag",
        "nodes": len(nodes),
        "racks": len(gangs),
        "squat_gangs": len(gangs),
        "frag_score_before": rep_before.score,
        "big_gang_admitted_before": admitted_before,
        "plan_wall_s": plan_wall_s,
        "device": str(dev),
    }
    if plan is None:
        out.update(error="planner produced no improving plan", value=None, vs_baseline=0.0)
        return out
    orig = {name: p.node_name for name, p in pods.items()}
    for mv in plan.moves:
        for pod_name, target in mv.bindings.items():
            pods[pod_name].node_name = target
    snap_after = build_snapshot(nodes, topo, bound_pods=list(pods.values()), pad_nodes_to=pad)
    rep_after = fragmentation_report(snap_after)
    admitted_after = admit_gangs(big_gangs, all_pods, snap_after, wp, dev)
    # Re-plan the restored fragmented state: the same shapes, no preparation.
    for name, node_name in orig.items():
        pods[name].node_name = node_name
    low0 = wp.executables.lowerings
    plan2 = plan_migrations(nodes, topo, gangs, dict(pods), warm=wp, max_moves=len(gangs),
                            device=dev)
    warm_lowerings = wp.executables.lowerings - low0
    for mv in plan.moves:  # leave the cluster defragmented
        for pod_name, target in mv.bindings.items():
            pods[pod_name].node_name = target
    target_plan_s = 1.0  # bench.py's latency bar
    recovered_ok = 1.0 if admitted_after >= 1 and admitted_before == 0 else 0.0
    out.update({
        "metric": "defrag_plan_solve_s",
        "unit": "s",
        "value": plan.solve_s,
        "vs_baseline": (target_plan_s / plan.solve_s) * recovered_ok if plan.solve_s > 0 else 0.0,
        "plan_solve_s": plan.solve_s,
        "plan_encode_s": plan.encode_s,
        "plan_decode_s": plan.decode_s,
        "plan_lowerings": plan.lowerings,
        "candidates_evaluated": plan.candidates_evaluated,
        "pods_migrated": plan.pods_migrated,
        "gangs_moved": len(plan.moves),
        "capacity_recovered": plan.capacity_recovered,
        "capacity_recovered_per_pod": plan.efficiency,
        "binding_level": plan.binding_level,
        "binding_resource": plan.binding_resource,
        "frag_score_after": rep_after.score,
        "big_gang_admitted_after": admitted_after,
        "warm_replan_lowerings": warm_lowerings,
        "warm_replan_solve_s": None if plan2 is None else plan2.solve_s,
        "warm_replan_same_moves": plan2 is not None and [(m.gang, m.bindings) for m in plan2.moves]
        == [(m.gang, m.bindings) for m in plan.moves],
        "plan_launches": plan_launches,
    })
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


# ---- the GREP-375 sidecar over gRPC -------------------------------------------------


class _Ctx:
    """The gRPC servicer context of an in-process call: an abort raises."""

    def abort(self, code, message):
        raise RuntimeError(f"abort: {code} {message}")


def sidecar_sequence(send, nodes, specs, topology, stages=None) -> dict:
    """bench.py's default fleet and backlog through the sidecar's RPCs, in
    the order an operator sends them: Init, UpdateCluster, one SyncPodGang
    per gang, Solve; then ReleasePods of one pod of the first admitted gang
    (its floor shrinks, its group stays pinned to its domain) and, for the
    last admitted gang, ReleasePods of all its pods, OnPodGangDelete and a
    re-sync; then the incremental Solve. `send(method, request)` is one RPC
    (over gRPC or in-process); `stages()` (optional) reads the servicer's
    last Solve stages. Returns the responses and timings."""
    from grove_tpu_torch.backend.proto import scheduler_backend_pb2 as pb

    out = {"solves": [], "stages": []}
    send("Init", pb.InitRequest(topology=[pb.TopologyLevel(domain=d, node_label_key=k)
                                          for d, k in topology]))
    out["node_count"] = send("UpdateCluster", pb.UpdateClusterRequest(
        nodes=nodes, full_replace=True)).node_count
    t0 = time.perf_counter()
    for spec in specs:
        send("SyncPodGang", pb.SyncPodGangRequest(pod_gang=spec))
    out["sync_rpcs"], out["sync_wall_s"] = len(specs), time.perf_counter() - t0

    def solve():
        resp = send("Solve", pb.SolveRequest())
        out["solves"].append(resp)
        if stages is not None:
            out["stages"].append(dict(stages()))
        return resp

    first = solve()
    admitted = [g for g in first.gangs if g.admitted and len(g.bindings) >= 2]
    shrink, gone = admitted[0], admitted[-1]
    out["released_pod"] = shrink.bindings[0].pod_name
    send("ReleasePods", pb.ReleasePodsRequest(pod_names=[out["released_pod"]]))
    send("ReleasePods", pb.ReleasePodsRequest(pod_names=[b.pod_name for b in gone.bindings]))
    send("OnPodGangDelete", pb.OnPodGangDeleteRequest(name=gone.name, namespace="default"))
    send("SyncPodGang", pb.SyncPodGangRequest(
        pod_gang=next(s for s in specs if s.name == gone.name)))
    out["resynced_gang"] = gone.name
    solve()
    return out


def run_sidecar_bench(scale: float = 1.0, frac: float = 1.0, device=None,
                      cpu_side: bool = True) -> dict:
    """The port's GREP-375 sidecar at bench.py's default size (at `scale` 1
    and `frac` 1: 4 zones x 4 blocks x 16 racks x 20 hosts = 5120 nodes,
    1250 PodGangs, 10,000 pods), served over gRPC on 127.0.0.1 by
    `TPUSchedulerBackend(device=device)` (None = the card) and driven by
    the port's `BackendClient` through `sidecar_sequence`. The sidecar's
    SolverConfig floors its shape buckets at the backlog's own (groups,
    pods, pack-sets, gang pad), so the incremental second Solve reuses the
    first one's prepared launch. Then one contended Solve: bench.py's replay
    world (16 nodes of 8 cpus, one rack-packed 4-pod job too many), which
    escalates to a portfolio of 4 (B5 on the card).

    Gates (`ok`): every gang admitted by the first Solve, no node over
    capacity after the second, 0 new launch preparations (lowerings) in the
    second, 64 SyncPodGang RPCs answered while the first Solve's device phase
    is parked on its gRPC worker thread (which then runs it), the contended Solve's escalation launched ("portfolio" >= 1 on
    the card), and the same RPC sequences sent to an in-process
    `TPUSchedulerBackend(device="cpu")` answer with equal SolveResponses
    (solve_micros aside). `cpu_side` False skips that comparison (a caller
    holds a cut run to the CPU servicer instead): the gate `equal_to_cpu`
    and `cpu_equal` are then None and `ok` reads the other gates."""
    import threading

    import torch

    from grove_tpu_torch.backend.client import BackendClient, gang_to_proto, node_to_proto
    from grove_tpu_torch.backend.proto import scheduler_backend_pb2 as pb
    from grove_tpu_torch.backend.service import TPUSchedulerBackend, serve_backend
    from grove_tpu_torch.kernels.place_wave import VARIANTS, place_wave, reset_launches
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.runtime.config import SolverConfig
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_cluster
    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.solver.encode import next_pow2, pack_set_count
    from grove_tpu_torch.utils.metrics import Registry

    dev = resolve_device(device)
    topo = bench_topology()
    topology = [(lv.domain.value, lv.node_label_key) for lv in topo.levels]
    fleet = synthetic_cluster(racks_per_block=max(1, round(16 * scale)))
    gangs, pods = build_backlog(frac)
    nodes = [node_to_proto(n) for n in fleet]
    specs = [gang_to_proto(g, pods) for g in gangs]
    cfg = SolverConfig(
        max_groups=next_pow2(max(len(g.spec.pod_groups) for g in gangs)),
        max_pods=next_pow2(max(g.total_pods() for g in gangs)),
        max_sets=next_pow2(max(max(pack_set_count(g) for g in gangs), 1)),
        pad_gangs_to=next_pow2(len(gangs)),
    )

    # The contended world: bench.py's replay scenario's fleet and backlog.
    ctopo, cfleet, cbacklog = replay_world(1.0)
    c_gangs, c_pods = [], {}
    for pcs in cbacklog():
        ds = expand_podcliqueset(pcs, ctopo)
        c_gangs += ds.podgangs
        c_pods.update({p.name: p for p in ds.pods})
    c_nodes = [node_to_proto(n) for n in cfleet()]
    c_specs = [gang_to_proto(g, c_pods) for g in c_gangs]
    c_topology = [(lv.domain.value, lv.node_label_key) for lv in ctopo.levels]

    def contended(send) -> "pb.SolveResponse":
        send("Init", pb.InitRequest(topology=[pb.TopologyLevel(domain=d, node_label_key=k)
                                              for d, k in c_topology]))
        send("UpdateCluster", pb.UpdateClusterRequest(nodes=c_nodes, full_replace=True))
        for spec in c_specs:
            send("SyncPodGang", pb.SyncPodGangRequest(pod_gang=spec))
        return send("Solve", pb.SolveRequest())

    reg = Registry()
    backend = TPUSchedulerBackend(solver_config=cfg, metrics=reg, device=dev)
    c_backend = TPUSchedulerBackend(solver_config=SolverConfig(portfolio_escalation=4),
                                    device=dev)
    server, port = serve_backend(backend)
    c_server, c_port = serve_backend(c_backend)
    misses = reg.counter("grove_backend_exec_cache_misses_total", "")
    lowerings = []

    def stages():
        lowerings.append(misses.value())
        return backend.last_stages

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Control RPCs during a device phase (the GREP-375 lock contract, as the
    # JAX sidecar's hardening test pins it): the first Solve is parked once
    # its device phase is entered, on a gRPC worker thread, until SyncPodGang
    # re-syncs of unchanged specs have come back; then it runs there.
    entered, release = threading.Event(), threading.Event()
    inflight = {}
    solve_unlocked = backend._solve_unlocked

    def parked(work):
        if not entered.is_set():
            entered.set()
            if not release.wait(timeout=120):
                raise RuntimeError("sidecar: SyncPodGang blocked behind the in-flight Solve")
        return solve_unlocked(work)

    backend._solve_unlocked = parked

    def resync_while_parked(client):
        if entered.wait(timeout=600):
            t = time.perf_counter()
            for spec in specs[:64]:
                client._stubs["SyncPodGang"](pb.SyncPodGangRequest(pod_gang=spec))
            inflight.update(syncs=min(64, len(specs)), wall_s=time.perf_counter() - t)
        release.set()

    try:
        with BackendClient(f"127.0.0.1:{port}") as client, \
                BackendClient(f"127.0.0.1:{c_port}") as c_client:
            sync()
            reset_launches()
            prober = threading.Thread(target=resync_while_parked, args=(client,))
            prober.start()
            t0 = time.perf_counter()
            try:
                card = sidecar_sequence(lambda m, r: client._stubs[m](r), nodes, specs,
                                        topology, stages)
            finally:
                entered.set()
                prober.join()
            wall = time.perf_counter() - t0
            sync()
            launches = dict(place_wave.variant_launches)
            reset_launches()
            c_resp = contended(lambda m, r: c_client._stubs[m](r))
            sync()
            c_launches = dict(place_wave.variant_launches)
            c_stages = dict(c_backend.last_stages)
    finally:
        server.stop(grace=None)
        c_server.stop(grace=None)

    # Bindings after the two Solves, against the nodes' capacity.
    first, second = card["solves"]
    bound = {b.pod_name: b.node_name for g in first.gangs if g.admitted for b in g.bindings}
    resynced = next(g for g in first.gangs if g.name == card["resynced_gang"])
    for b in resynced.bindings:
        bound.pop(b.pod_name, None)
    bound.pop(card["released_pod"], None)
    bound.update({b.pod_name: b.node_name for g in second.gangs if g.admitted
                  for b in g.bindings})
    cap = {n.name: n.capacity for n in fleet}
    used: dict[str, dict[str, float]] = {}
    for pod_name, node in bound.items():
        acc = used.setdefault(node, {})
        for res, qty in pods[pod_name].spec.total_requests().items():
            acc[res] = acc.get(res, 0.0) + qty
    over = sorted(n for n, acc in used.items()
                  if any(q > cap[n].get(r, 0.0) + 1e-6 for r, q in acc.items()))

    def plain(resp):
        out = pb.SolveResponse()
        out.CopyFrom(resp)
        out.solve_micros = 0
        return out

    cpu_equal = cpu_s = None
    if cpu_side:
        t1 = time.perf_counter()
        ctx = _Ctx()
        ref = TPUSchedulerBackend(solver_config=cfg, device="cpu")
        cpu = sidecar_sequence(lambda m, r: getattr(ref, m)(r, ctx), nodes, specs, topology)
        c_ref = TPUSchedulerBackend(solver_config=SolverConfig(portfolio_escalation=4),
                                    device="cpu")
        c_cpu = contended(lambda m, r: getattr(c_ref, m)(r, ctx))
        cpu_s = time.perf_counter() - t1
        cpu_equal = ([plain(r) for r in card["solves"]] == [plain(r) for r in cpu["solves"]]
                     and plain(c_resp) == plain(c_cpu))
    gates = {
        "all_admitted_uncontended": sum(g.admitted for g in first.gangs) == len(gangs),
        "no_node_over_capacity": not over,
        "incremental_solve_prepares_nothing": lowerings[1] - lowerings[0] == 0,
        "contended_rejects_one": sum(not g.admitted for g in c_resp.gangs) >= 1,
        "escalation_launched": dev.type != "cuda" or c_launches["portfolio"] >= 1,
        "syncs_not_blocked_by_inflight_solve": inflight.get("syncs", 0) > 0,
        "equal_to_cpu": cpu_equal,
    }
    return {
        "scenario": "sidecar",
        "nodes": card["node_count"],
        "gangs": len(gangs),
        "pods": len(pods),
        "sync_rpcs": card["sync_rpcs"],
        "sync_wall_s": card["sync_wall_s"],
        "inflight_sync_rpcs": inflight.get("syncs", 0),
        "inflight_sync_wall_s": inflight.get("wall_s"),
        "sequence_wall_s": wall,
        "solve_micros": [r.solve_micros for r in card["solves"]] + [c_resp.solve_micros],
        "stages": card["stages"] + [c_stages],
        "admitted": [sum(g.admitted for g in r.gangs) for r in card["solves"]],
        "gangs_solved": [len(r.gangs) for r in card["solves"]],
        "lowerings": [lowerings[0], lowerings[1] - lowerings[0]],
        "overcommitted_nodes": over,
        "contended_gangs": len(c_resp.gangs),
        "contended_admitted": sum(g.admitted for g in c_resp.gangs),
        "launches": {k: launches.get(k, 0) + c_launches.get(k, 0) for k in VARIANTS},
        "contended_launches": c_launches,
        "cpu_equal": cpu_equal,
        "cpu_s": cpu_s,
        "gates": gates,
        "ok": all(v for v in gates.values() if v is not None),
    }


# ---- the cellular control plane: sharded cells with journal recovery -------------

# Keys of the cells document that carry host wall-clock time or describe the
# host; a card run and a CPU run agree on every other key.
CELLS_WALL_KEYS = ("host_total_s", "host_blocked_s", "max_cell_host_total_s", "host_cpus")


def cells_doc_core(doc):
    """A cells document without its wall-clock keys, at every depth."""
    if isinstance(doc, dict):
        return {k: cells_doc_core(v) for k, v in doc.items() if k not in CELLS_WALL_KEYS}
    if isinstance(doc, list):
        return [cells_doc_core(v) for v in doc]
    return doc


def run_cells_bench(device=None, *, duration_s: float | None = None, rate: float = 4.0,
                    seed: int = 20260807, chunk: int = 12, soak: bool = False) -> dict:
    """bench.py's `run_cells_bench` on the port, with its keys and gates:
    sharded reconcile cells (grove_tpu_torch/cells) on a 32-node fleet
    (4 zones x 1 block x 2 racks x 4 hosts) under `arrival_process(seed,
    duration_s, rate)`, every cell's stream drain on `device` (None = the
    card). bench.py's GROVE_BENCH_CELLS_* knobs are the arguments here, with
    its defaults (`duration_s` None: 25 s, or 60 s with `soak`).

    Phase 1, kill and resume: two cells stream the trace; an injected
    `cell.crash` kills cell-0 between chunks; its replacement recovers from
    the journal tail (replayed bitwise on `device` first) and resumes the
    trace. Gates: zero lost gangs, zero double-bound gangs, zero
    oversubscribed node-ticks in both journals (`audit_journal`), the replay
    verified, the rebuilt state equal to the state before the crash.
    Phase 2, scaling over {1, 2, 4} cells on the same trace: bindings
    disjoint across cells and the busiest cell's share of the trace shrinking
    as cells are added. A `cell.partition` probe defers once, then passes."""
    import shutil
    import tempfile

    from grove_tpu_torch.cells import (
        Cell,
        CellCoordinator,
        CellCrash,
        audit_journal,
        fleet_slices,
        partition_tree,
        recover,
        with_fleet,
    )
    from grove_tpu_torch.faults import FaultInjector, SiteSpec
    from grove_tpu_torch.sim.workloads import (
        ZONE_KEY,
        arrival_process,
        bench_topology,
        expand_arrivals,
        synthetic_cluster,
    )
    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.trace.recorder import read_journal, read_manifest

    dev = resolve_device(device)
    duration = float(duration_s if duration_s is not None else (60.0 if soak else 25.0))
    topo = bench_topology()
    nodes = synthetic_cluster(zones=4, blocks_per_zone=1, racks_per_block=2, hosts_per_rack=4)
    events = arrival_process(seed, duration_s=duration, base_rate=rate)
    arrivals, pods = expand_arrivals(events, topo)
    root = tempfile.mkdtemp(prefix="grove-bench-cells-")

    def build(count: int, tag: str, faults_by_cell: dict | None = None):
        plan = with_fleet(partition_tree(None, count), nodes, ZONE_KEY)
        slices = fleet_slices(plan, nodes, ZONE_KEY)
        cells = {}
        for cname in plan.cells:
            cells[cname] = Cell(cname, slices[cname], topo,
                                journal_path=os.path.join(root, tag, cname),
                                faults=(faults_by_cell or {}).get(cname),
                                crash_check_every=chunk, device=dev)
            cells[cname].start()
        return plan, slices, cells, CellCoordinator(plan, cells)

    try:
        # ---- phase 1: kill and resume a cell mid-stream ------------------------
        crash_inj = FaultInjector({"cell.crash": SiteSpec(kind="error", rate=1.0, count=1)},
                                  seed=seed)
        plan, slices, cells, coord = build(2, "killresume", {"cell-0": crash_inj})
        assigned = coord.assign(arrivals)
        survivor = cells["cell-1"].serve(assigned["cell-1"], pods)
        crashed = False
        try:
            cells["cell-0"].serve(assigned["cell-0"], pods)
        except CellCrash:
            crashed = True
        pre_decided = set(cells["cell-0"].decided)
        pre_bound = dict(cells["cell-0"].bindings)
        jp0 = os.path.join(root, "killresume", "cell-0")
        replacement, report = recover("cell-0", slices["cell-0"], topo, journal_path=jp0,
                                      crash_check_every=chunk, device=dev)
        recovery_state_ok = (replacement.decided == pre_decided
                             and set(replacement.bindings) == set(pre_bound))
        replacement.start()
        resumed = replacement.serve(assigned["cell-0"], pods)
        replacement.close()
        cells["cell-1"].close()
        double_bound = sorted(set(resumed) & set(pre_bound))
        offered_names = {g.name for _, g in assigned["cell-0"]}
        lost = sorted(offered_names - replacement.decided)
        audit0 = audit_journal(read_journal(jp0))
        audit1 = audit_journal(read_journal(os.path.join(root, "killresume", "cell-1")))
        manifest0 = read_manifest(jp0) or {}
        kill_gates = {
            "crash_injected": crashed,
            "replay_verified": bool(report.verified),
            "recovery_state_matches_precrash": recovery_state_ok,
            "zero_lost_gangs": not lost,
            "zero_double_bound_gangs": not double_bound,
            "zero_oversubscribed_node_ticks": (audit0["oversubscribed"] == 0
                                               and audit1["oversubscribed"] == 0),
        }

        # ---- phase 2: scaling over {1, 2, 4} cells -----------------------------
        scaling = []
        for count in (1, 2, 4):
            _, _, sc_cells, sc_coord = build(count, f"scale{count}")
            sc_assigned = sc_coord.assign(arrivals)
            bound_by_cell = {cname: sc_cells[cname].serve(arr, pods)
                             for cname, arr in sc_assigned.items()}
            per_cell = {
                cname: {
                    "gangs_offered": c.stats.offered,
                    "gangs_admitted": c.stats.admitted,
                    "dispatches": c.stats.dispatches,
                    "host_total_s": round(c.stats.host_total_s, 4),
                    "host_blocked_s": round(c.stats.host_blocked_s, 4),
                    "nodes": len(c.nodes),
                }
                for cname, c in sc_cells.items()
            }
            all_bound = [g for b in bound_by_cell.values() for g in b]
            scaling.append({
                "cells": count,
                "per_cell": per_cell,
                "aggregate_dispatches": sum(c.stats.dispatches for c in sc_cells.values()),
                "aggregate_admitted": sum(c.stats.admitted for c in sc_cells.values()),
                "max_cell_host_total_s": round(
                    max(c.stats.host_total_s for c in sc_cells.values()), 4),
                "max_cell_gangs_offered": max(c.stats.offered for c in sc_cells.values()),
                "bound_disjoint": len(all_bound) == len(set(all_bound)),
            })
            for c in sc_cells.values():
                c.close()
        scaling_gates = {
            "bound_disjoint_all_counts": all(s["bound_disjoint"] for s in scaling),
            "per_cell_share_shrinks": (scaling[2]["max_cell_gangs_offered"]
                                       < scaling[0]["max_cell_gangs_offered"]),
            "aggregate_admitted_stable": len({s["aggregate_admitted"] for s in scaling}) <= 3,
        }

        # ---- the cell.partition probe: cross-cell routing defers, never splits --
        part_inj = FaultInjector({"cell.partition": SiteSpec(kind="error", rate=1.0, count=1)},
                                 seed=seed)
        _, _, pcells, pcoord = build(2, "partition")
        pcoord.faults = part_inj
        partition_deferred_then_ok = not pcoord.reachable("cell-1") and pcoord.reachable("cell-1")
        for c in pcells.values():
            c.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    gates = {**kill_gates, **scaling_gates,
             "partition_defers_then_recovers": partition_deferred_then_ok}
    green = all(gates.values())
    return {
        "scenario": "cells",
        "metric": "cells_gates_green",
        "unit": "bool",
        "value": 1.0 if green else 0.0,
        "vs_baseline": 1.0 if green else 0.0,
        "soak": soak,
        "host_cpus": len(os.sched_getaffinity(0)),
        "nodes": len(nodes),
        "trace_seed": seed,
        "trace_duration_s": duration,
        "trace_base_rate": rate,
        "gangs_offered": len(arrivals),
        "crash_check_every": chunk,
        "gates": gates,
        "kill_resume": {
            "precrash_decided": len(pre_decided),
            "precrash_bound": len(pre_bound),
            "resumed_bound": len(resumed),
            "survivor_bound": len(survivor),
            "lost_gangs": lost[:8],
            "double_bound_gangs": double_bound[:8],
            "replay": report.to_doc(),
            "audit_cell0": audit0,
            "audit_cell1": audit1,
            "manifest_segments": len(manifest0.get("segments", [])),
            "manifest_last_wave": manifest0.get("lastWave"),
        },
        "scaling": scaling,
        "partition_deferred_count": part_inj.fired.get("cell.partition", 0),
    }


# ---- the serving path: GroveController under the Simulator -----------------------

# Reconcile phases timed per tick by the serving bench (GroveController.reconcile's
# calls, in order).
RECONCILE_PHASES = ("sync_workload", "rolling_updates", "revocation_tick", "solve_pending",
                    "update_statuses", "gang_termination", "maybe_defrag")
# Keys of the replay document that carry wall-clock time or a temporary path;
# a card run and a CPU run agree on every other key.
REPLAY_WALL_KEYS = ("drain_wall_off_s", "drain_wall_on_s", "record_overhead_frac",
                    "vs_baseline", "recorded_solve_s", "replayed_solve_s", "record_windows",
                    "record_split", "record_calibration")
RECORDER_WALL_KEYS = ("path", "segmentsWritten", "manifestWrites", "queueDepth")
# The controller's counters and in-flight maps a serving comparison holds
# equal beside the store.
CONTROLLER_COUNTERS = ("solve_pass_counts", "quality_counts", "resilience_counts",
                       "defrag_counts", "rollout_counts", "revocation_counts",
                       "_defrag_migrating", "_defrag_migrated_at", "_preempted_for_at",
                       "_reclaimed_for_at", "_pending_since", "_aging_boost",
                       "_reclaim_evicting", "_rollout_replacing", "last_admission_scores")
# A serving run's CPU replay: past this many seconds for the first floors
# wave the other waves are left out.
REPLAY_BUDGET_S = 60.0
SERVING_MAX_TICKS = 40


def plain_view(o):
    """A structural, order-keeping view of a host object (dataclasses by
    type name and field, enums by value, numpy scalars as Python values);
    a managed secret's random token is left out."""
    import dataclasses
    import enum

    if o is None or isinstance(o, (bool, str)):
        return o
    if isinstance(o, enum.Enum):
        return o.value
    if isinstance(o, (int, float, np.integer, np.floating, np.bool_)):
        return o.item() if hasattr(o, "item") else o
    if dataclasses.is_dataclass(o):
        return (type(o).__name__, [(f.name, plain_view(getattr(o, f.name)))
                                   for f in dataclasses.fields(o) if f.name != "token"])
    if isinstance(o, dict):
        return [(k if isinstance(k, str) else plain_view(k), plain_view(v)) for k, v in o.items()]
    if isinstance(o, (list, tuple)) or hasattr(o, "maxlen"):
        return [plain_view(x) for x in o]
    if isinstance(o, (set, frozenset)):
        return sorted(plain_view(x) for x in o)
    return repr(o)


def store_view(cluster, ctrl) -> dict:
    """Everything a serving run leaves in the store, and the controller's
    counters and tenancy ledger: each node, PodCliqueSet (with its status),
    PodClique, scaling group, PodGang, pod and managed resource, the events
    list in order."""
    doc = {k: plain_view(getattr(cluster, k)) for k in (
        "nodes", "podcliquesets", "podcliques", "scaling_groups", "podgangs", "pods",
        "services", "hpas", "service_accounts", "roles", "role_bindings", "secrets",
        "scale_overrides", "events")}
    doc["events_total"] = cluster.events_total
    for k in CONTROLLER_COUNTERS:
        doc["ctrl." + k] = plain_view(getattr(ctrl, k))
    doc["ctrl.tenancy_ledger"] = ctrl.tenancy_ledger.snapshot()
    return doc


def serving_state(cluster, ctrl) -> dict:
    """The part of `store_view` a step changes, cheap enough to compare
    after every step: each pod's node, phase, readiness, gates, stamps and
    index, each node's schedulable and revocation state, each gang's phase,
    conditions and score, each PodClique's and PodCliqueSet's status, the
    events list and the controller's counters."""
    doc = {
        "pods": [(p.name, p.node_name, p.phase.value, p.ready, tuple(p.scheduling_gates),
                  p.deletion_timestamp, p.started_at, p.crashlooping, p.pod_index)
                 for p in cluster.pods.values()],
        "nodes": [(n.name, n.schedulable, n.revocable, n.revocation_deadline)
                  for n in cluster.nodes.values()],
        "podgangs": [(g.name, plain_view(g.status)) for g in cluster.podgangs.values()],
        "podcliques": [(c.metadata.name, plain_view(c.status))
                       for c in cluster.podcliques.values()],
        "podcliquesets": [(p.metadata.name, plain_view(p.status))
                          for p in cluster.podcliquesets.values()],
        "events": list(cluster.events),
        "events_total": cluster.events_total,
    }
    for k in CONTROLLER_COUNTERS:
        doc["ctrl." + k] = plain_view(getattr(ctrl, k))
    return doc


def first_difference(a, b, path: str = "") -> str:
    """Where two views first differ, as a path and the two values."""
    if type(a) is not type(b):
        return f"{path}: {a!r} != {b!r}"
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    if isinstance(a, dict):
        for k in a:
            if a[k] != b.get(k):
                return first_difference(a[k], b.get(k), f"{path}.{k}")
    return f"{path}: {a!r:.200} != {b!r:.200}"


def strip_wall(x, keys=("solveSeconds", "planSolveSeconds", "planEncodeSeconds",
                        "planDecodeSeconds")):
    """A document (or journal) without its wall-clock fields."""
    if isinstance(x, dict):
        return {k: strip_wall(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [strip_wall(v, keys) for v in x]
    return x


def node_overcommit(cluster) -> list[str]:
    """Nodes whose bound, active pods request more than the node holds, as
    the sum of the pods' requests (independent of any snapshot)."""
    used: dict[str, dict[str, float]] = {}
    for p in cluster.pods.values():
        if p.is_scheduled and p.is_active:
            acc = used.setdefault(p.node_name, {})
            for res, qty in p.spec.total_requests().items():
                acc[res] = acc.get(res, 0.0) + qty
    return sorted(name for name, acc in used.items()
                  if name not in cluster.nodes
                  or any(q > cluster.nodes[name].capacity.get(r, 0.0) + 1e-6
                         for r, q in acc.items()))


def timed_reconcile(ctrl) -> dict:
    """Time each reconcile phase of `ctrl` (RECONCILE_PHASES): the returned
    dict accumulates seconds per phase until the caller clears it."""
    spent = {name: 0.0 for name in RECONCILE_PHASES}

    def wrap(name):
        fn = getattr(ctrl, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0

        setattr(ctrl, name, timed)

    for name in RECONCILE_PHASES:
        wrap(name)
    return spent


def serving_world(scale: float = 1.0, frac: float = 1.0):
    """(topology, nodes, backlog): bench.py's default scenario as a serving
    workload — the synthetic cluster (4 zones x 4 blocks x 16 x `scale`
    racks x 20 hosts; 5120 nodes at 1) and the synthetic backlog at `frac`
    of its size (900 PodCliqueSets, 1250 gangs, 10,000 pods at 1)."""
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_backlog, synthetic_cluster

    nodes = synthetic_cluster(racks_per_block=max(1, round(16 * scale)))
    backlog = synthetic_backlog(n_disagg=max(1, round(350 * frac)),
                                n_agg=max(1, round(250 * frac)),
                                n_frontend=max(1, round(300 * frac)))
    return bench_topology(), nodes, backlog


def replay_first_floors_then_rest(records) -> dict:
    """Replay the journal's first floors wave alone on the CPU's plain
    versions, then, if that took no more than REPLAY_BUDGET_S, every other
    wave: (waves replayed of the journal's waves, divergences, seconds)."""
    from grove_tpu_torch.trace.replay import replay_journal

    waves = [r for r in records if r.get("kind") == "wave"]
    fleets = [r for r in records if r.get("kind") == "fleet"]
    first = next((r for r in waves if r.get("wave") == "floors"), None)
    out = {"journal_waves": len(waves), "replayed_waves": 0, "divergences": 0,
           "replay_s": 0.0, "replay_scope": "none"}
    if first is None:
        return out
    t0 = time.perf_counter()
    rep = replay_journal(fleets + [first], device="cpu")
    first_s = time.perf_counter() - t0
    out.update(replayed_waves=len(rep.waves), divergences=rep.divergence_count,
               replay_s=first_s, first_floors_replay_s=first_s,
               first_floors_gangs=rep.waves[0].gangs if rep.waves else 0)
    rest = [r for r in waves if r is not first]
    if first_s <= REPLAY_BUDGET_S and rest:
        t0 = time.perf_counter()
        rep2 = replay_journal(fleets + rest, device="cpu")
        out["replay_s"] += time.perf_counter() - t0
        out["replayed_waves"] += len(rep2.waves)
        out["divergences"] += rep2.divergence_count
    out["replay_scope"] = ("every wave" if out["replayed_waves"] == len(waves)
                           else "first floors wave")
    return out


def time_wave_solve(records, dev) -> tuple[float, int]:
    """The journal's first floors wave re-solved on the card through its own
    WarmPath: (ms per solve by CUDA events, after one untimed solve; the
    wave's gangs). A solve here is solve() on the recorded snapshot and
    batch: the batch's upload, the launch and its verdicts."""
    import torch

    from grove_tpu_torch.solver.core import SolverParams, solve
    from grove_tpu_torch.solver.warm import WarmPath
    from grove_tpu_torch.trace.replay import encode_wave_record, snapshot_from_wave

    fleets = {r["digest"]: r for r in records if r.get("kind") == "fleet"}
    wave = next(r for r in records if r.get("kind") == "wave" and r.get("wave") == "floors")
    snap = snapshot_from_wave(wave, fleets[wave["fleet"]])
    batch, decode = encode_wave_record(wave, snap)
    params = SolverParams(*wave["solver"]["params"])
    warm = WarmPath()
    solve(snap, batch, params, device=dev, warm=warm)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    e0.record()
    for _ in range(5):
        solve(snap, batch, params, device=dev, warm=warm)
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / 5, len(decode.gang_names)


def run_serving_bench(scale: float = 1.0, frac: float = 1.0, device=None) -> dict:
    """The serving path at bench.py's default size: apply the synthetic
    backlog to a `Cluster` of the synthetic fleet and run `GroveController`
    (recorder on) under `Simulator` until every pod is Ready. Reports ticks,
    the sim seconds to all-bound and all-Ready, each tick's wall, its
    reconcile phases and host stages (encodeS, solveS, decodeS), the solve
    passes, the launches per kernel variant; gates: every gang's base
    scheduled, no node over capacity, every pod Ready, every PodCliqueSet
    Available, and the journal replayed on the CPU's plain versions with 0
    divergences (`replay_first_floors_then_rest`)."""
    import shutil
    import tempfile

    import torch

    from grove_tpu_torch.orchestrator.controller import GroveController
    from grove_tpu_torch.orchestrator.store import Cluster
    from grove_tpu_torch.sim.simulator import Simulator
    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal

    dev = resolve_device(device)
    t0 = time.perf_counter()
    topo, nodes, backlog = serving_world(scale, frac)
    cluster = Cluster()
    for n in nodes:
        cluster.nodes[n.name] = n
    journal = tempfile.mkdtemp(prefix="grove-serving-journal-")
    rec = TraceRecorder(journal)
    rec.start()
    ctrl = GroveController(cluster=cluster, topology=topo, device=dev, recorder=rec)
    sim = Simulator(cluster=cluster, controller=ctrl)
    spent = timed_reconcile(ctrl)
    for pcs in backlog:
        cluster.podcliquesets[pcs.metadata.name] = pcs
    setup_s = time.perf_counter() - t0
    reset, read = launch_counter(dev)
    reset()
    ticks, bound_at, ready_at = [], None, None
    passes = dict(ctrl.solve_pass_counts)
    try:
        while len(ticks) < SERVING_MAX_TICKS:
            for k in spent:
                spent[k] = 0.0
            t1 = time.perf_counter()
            sim.step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            now_passes = dict(ctrl.solve_pass_counts)
            solved = now_passes != passes
            passes = now_passes
            active = [p for p in cluster.pods.values() if p.is_active]
            tick = {"now": sim.now, "wall_s": wall, "phases_s": dict(spent),
                    "pods": len(active), "bound": sum(p.is_scheduled for p in active),
                    "ready": sum(p.ready for p in active)}
            if solved:
                tick["host_stages"] = dict(ctrl.last_host_stages)
            ticks.append(tick)
            if bound_at is None and active and tick["bound"] == len(active):
                bound_at = sim.now
            if active and tick["ready"] == len(active):
                ready_at = sim.now
                break
    finally:
        rec.stop()
    launches = read()
    records = read_journal(journal)
    shutil.rmtree(journal, ignore_errors=True)
    gangs = list(cluster.podgangs.values())
    scheduled = sum(1 for g in gangs if g.is_base_gang_scheduled())
    available = sum(1 for p in cluster.podcliquesets.values()
                    if p.status.available_replicas == p.spec.replicas)
    over = node_overcommit(cluster)
    replay = replay_first_floors_then_rest(records)
    walls = [t["wall_s"] for t in ticks]
    out = {
        "scenario": "serving",
        "device": str(dev),
        "nodes": len(nodes),
        "podcliquesets": len(backlog),
        "gangs": len(gangs),
        "pods": len(cluster.pods),
        "setup_s": setup_s,
        "ticks": len(ticks),
        "sim_s_to_all_bound": bound_at,
        "sim_s_to_all_ready": ready_at,
        "wall_s_total": sum(walls),
        "wall_s_per_tick_mean": sum(walls) / max(1, len(walls)),
        "wall_s_per_tick_max": max(walls, default=0.0),
        "tick_log": ticks,
        "solve_pass_counts": dict(ctrl.solve_pass_counts),
        "quality_counts": dict(ctrl.quality_counts),
        "launches": launches,
        "gangs_base_scheduled": scheduled,
        "pcs_available": available,
        "overcommitted_nodes": over,
        "journal_records": len(records),
        "recorder_dropped": rec.dropped,
        **replay,
    }
    if dev.type == "cuda" and replay["replayed_waves"]:
        out["floors_wave_solve_ms"], out["floors_wave_gangs"] = time_wave_solve(records, dev)
    out["ok"] = bool(scheduled == len(gangs) and not over and ready_at is not None
                     and available == len(backlog) and rec.dropped == 0
                     and replay["replayed_waves"] >= 1 and replay["divergences"] == 0)
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def replay_world(scale: float = 1.0):
    """bench.py's replay scenario: (topology, fleet builder, backlog
    builder). 4 x `scale` racks (at least 2) of 4 hosts with 8 cpus, and one
    rack-packed 4-pod job per rack plus one: the backlog overfills the fleet
    by a rack, so the recorded window holds rejections."""
    from grove_tpu_torch.sim.workloads import _clique, _pcs, bench_topology, synthetic_cluster

    racks, hosts = max(2, round(4 * scale)), 4

    def fleet():
        return synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=racks,
                                 hosts_per_rack=hosts, cpu=8.0, tpu=0.0)

    def backlog():
        return [_pcs(f"job{i}", cliques=[_clique("w", hosts, "8")], constraint_domain="rack")
                for i in range(racks + 1)]

    return bench_topology(), fleet, backlog


# The order of the windows in the record-overhead reading's rounds, even
# rounds first: over an even number of rounds each side holds each place of
# a round equally often, so a drift inside a round or a bias of the place
# falls on both sides alike.
ROUND_ORDERS = (("off", "on", "on", "off"), ("on", "off", "off", "on"))


def read_record_overhead(drain, new_recorder, *, window_s: float = 0.0, rounds: int = 1,
                         aa: bool = False, clock=time.perf_counter) -> dict:
    """The record-overhead reading of `run_replay_bench`: bench.py's formula,
    (ON - OFF) / OFF over the summed walls of `rounds` rounds of timed
    windows, OFF, ON, ON, OFF and ON, OFF, OFF, ON in turn (ROUND_ORDERS),
    each of the same number of calls of
    `drain(recorder)` (which returns what it admitted; `recorder` is None
    OFF). An ON window starts a recorder from `new_recorder()` outside its
    timing, times its drains and then `recorder.flush()` inside it, and
    stops it outside; the recorder's `stats(split=True)` add up into
    "split". With `window_s` 0 a window is one drain; with `window_s` > 0 an
    untimed calibration window (no recorder) drains until `window_s`
    seconds have passed, sets the count and is in neither sum. With `aa`
    the ON windows run without a recorder. `clock` times the windows.
    Returns {"windows": [[side, drains, wall_s, gc_pause_s, collections,
    cpu_s, voluntary switches, involuntary switches], ...] (the collector's
    pauses inside the window, read through `gc.callbacks`; the draining
    thread's CPU seconds, `time.thread_time`, and its context switches,
    `getrusage(RUSAGE_THREAD)`), "calibration":
    [drains, wall_s] or None, "wall_off", "wall_on" (seconds a drain),
    "overhead", "admitted" (the set of what the drains admitted), "split":
    {"drains", "parts", "writer_cpu_s", "writer_switches"}}."""
    import gc
    import shutil

    from grove_tpu_torch.trace.recorder import SPLIT_PARTS

    split = {part: {"s": 0.0, "n": 0} for part in SPLIT_PARTS}
    writer = [0.0, 0, 0]  # the writer threads' CPU seconds and switches
    pauses = [0.0, 0, 0.0]  # seconds, collections, start of the current one

    def on_gc(phase, _info):
        if phase == "start":
            pauses[2] = time.perf_counter()
        else:
            pauses[0] += time.perf_counter() - pauses[2]
            pauses[1] += 1

    def window(side, count):
        recorder = new_recorder() if side == "on" and not aa else None
        if recorder is not None:
            recorder.start()
        pauses[:2] = [0.0, 0]
        gc.callbacks.append(on_gc)
        try:
            admitted = []
            ru0 = thread_rusage()
            cpu0 = time.thread_time()
            t0 = clock()
            while len(admitted) < count or (count == 0 and clock() - t0 < window_s):
                admitted.append(drain(recorder))
            if recorder is not None and not recorder.flush(timeout=60.0):
                raise RuntimeError("replay bench: the recorder did not flush in 60 s")
            wall = clock() - t0
            cpu = time.thread_time() - cpu0
            ru1 = thread_rusage()
        finally:
            gc.callbacks.remove(on_gc)
            if recorder is not None:
                recorder.stop()
                st = recorder.stats(split=True)
                for part, v in st["split"].items():
                    split[part]["s"] += v["s"]
                    split[part]["n"] += v["n"]
                writer[0] += st["writerCpuSeconds"]
                writer[1] += st["writerSwitches"][0]
                writer[2] += st["writerSwitches"][1]
                shutil.rmtree(recorder.path, ignore_errors=True)
        return ([side, len(admitted), wall, pauses[0], pauses[1], cpu, ru1[0] - ru0[0],
                 ru1[1] - ru0[1]], admitted)

    windows, admitted_seen = [], set()
    count, calibration = 1, None
    if window_s > 0:
        w, admitted = window("off", 0)
        count, calibration = w[1], [w[1], w[2]]
        admitted_seen.update(admitted)
    for r in range(max(1, int(rounds))):
        for side in ROUND_ORDERS[r % 2]:
            w, admitted = window(side, count)
            windows.append(w)
            admitted_seen.update(admitted)
    n_side = sum(1 for w in windows if w[0] == "off") * count
    wall_off = sum(w[2] for w in windows if w[0] == "off") / n_side
    wall_on = sum(w[2] for w in windows if w[0] == "on") / n_side
    # bench.py's formula (run_replay_bench), on the seconds a drain.
    overhead = (wall_on - wall_off) / wall_off if wall_off > 0 else 0.0
    return {"windows": windows, "calibration": calibration, "wall_off": wall_off,
            "wall_on": wall_on, "overhead": overhead, "admitted": admitted_seen,
            "split": {"drains": n_side, "parts": split, "writer_cpu_s": writer[0],
                      "writer_switches": writer[1:]}}


def run_replay_bench(scale: float = 1.0, device=None, window_s: float = 0.0,
                     rounds: int = 1, aa: bool = False, journal_dir: str | None = None) -> dict:
    """bench.py's `run_replay_bench` on the port, with its keys: the replay
    world drained by `GroveController` under `Simulator` with the recorder
    OFF and ON (the overhead), the journal of one recorded drain replayed
    (the divergences) and a +1-rack what-if over it (the counterfactual).
    Solves, the replay and the what-if run on `device` (None = the card).

    The overhead is bench.py's formula and 0.05 gate, read by
    `read_record_overhead` (`window_s`, `rounds`, `aa`) after a warm-up of
    one drain without the recorder and one with a recorder that is flushed
    and stopped, untimed: the recorder path's first-use costs are paid
    there, as bench.py's warm-up drain pays XLA's compiles. An ON window is
    timed through `recorder.flush()`, so every record its drains captured
    has been rendered and written to disk inside it; the recorder's start
    and stop stay outside, as in bench.py; the collector runs as it would.
    Many short windows, in rounds whose order turns about, cancel more of
    the host's drift than a few long ones; a window shorter than the recorder's flush interval
    still flushes at its end, so it charges more writes per drain, not
    fewer. With `window_s` > 0 the document also holds
    `record_calibration`, `record_windows` and `record_split` (see
    read_record_overhead), and with `aa` `record_aa` True. With
    `journal_dir` the recorded drain journals there and the journal is kept
    (else into a temporary directory that is removed)."""
    import shutil
    import tempfile

    from grove_tpu_torch.orchestrator.controller import GroveController
    from grove_tpu_torch.orchestrator.store import Cluster
    from grove_tpu_torch.sim.simulator import Simulator
    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal
    from grove_tpu_torch.trace.replay import replay_journal
    from grove_tpu_torch.trace.whatif import whatif_journal

    dev = resolve_device(device)
    topo, fleet, backlog = replay_world(scale)

    def drain(recorder):
        cluster = Cluster()
        for n in fleet():
            cluster.nodes[n.name] = n
        ctrl = GroveController(cluster=cluster, topology=topo, recorder=recorder, device=dev)
        sim = Simulator(cluster=cluster, controller=ctrl)
        for pcs in backlog():
            cluster.podcliquesets[pcs.metadata.name] = pcs
        sim.run_until(
            lambda: all(p.ready for p in cluster.pods.values() if p.is_scheduled)
            and any(p.is_scheduled for p in cluster.pods.values()),
            timeout=120.0,
        )
        admitted = sum(1 for g in cluster.podgangs.values() if g.is_base_gang_scheduled())
        return admitted, len(cluster.podgangs)

    def new_recorder():
        return TraceRecorder(tempfile.mkdtemp(prefix="grove-trace-bench-"))

    # Warm-up: one drain without the recorder (builds the kernels and fills
    # the process caches) and one with a recorder, flushed and stopped (the
    # recorder path's first use: its renderer, its writer thread, its file
    # I/O), so the OFF/ON comparison measures recording, not first-call
    # costs.
    drain(None)
    warm_rec = new_recorder()
    warm_rec.start()
    try:
        drain(warm_rec)
        warm_rec.flush(timeout=60.0)
    finally:
        warm_rec.stop()
        shutil.rmtree(warm_rec.path, ignore_errors=True)
    reading = read_record_overhead(lambda rec: drain(rec)[0], new_recorder,
                                   window_s=window_s, rounds=rounds, aa=aa)
    windows, admitted_seen = reading["windows"], reading["admitted"]
    wall_off, wall_on, overhead = reading["wall_off"], reading["wall_on"], reading["overhead"]

    # The recorded drain: its journal is the one replayed.
    keep = journal_dir is not None
    journal_dir = journal_dir if keep else tempfile.mkdtemp(prefix="grove-trace-bench-")
    recorder = TraceRecorder(journal_dir)
    recorder.start()
    try:
        admitted_on, gangs_total = drain(recorder)
    finally:
        recorder.stop()
    admitted_seen.add(admitted_on)
    records = read_journal(journal_dir)
    replay = replay_journal(records, device=dev)
    whatif = whatif_journal(records, add_rack_count=1, device=dev)
    if not keep:
        shutil.rmtree(journal_dir, ignore_errors=True)
    rep_doc = replay.to_doc()
    wi_doc = whatif.to_doc()
    divergences = rep_doc["divergences"]
    ok = divergences == 0 and overhead < 0.05 and len(admitted_seen) == 1
    out = {
        "scenario": "replay",
        "metric": "replay_divergence_total",
        "unit": "count",
        "value": divergences,
        "vs_baseline": 1.0 if ok else 0.0,
        "gangs": gangs_total,
        "gangs_admitted": admitted_on,
        "drain_wall_off_s": wall_off,
        "drain_wall_on_s": wall_on,
        "record_overhead_frac": overhead,
        "journal_records": len(records),
        "journal_waves": rep_doc["waves"],
        "recorder_stats": recorder.stats(),
        "recorded_solve_s": rep_doc["recordedSolveSeconds"],
        "replayed_solve_s": rep_doc["replayedSolveSeconds"],
        "whatif_add_racks": 1,
        "whatif_recorded_admitted_ratio": wi_doc["recorded"]["admittedRatio"],
        "whatif_cf_admitted_ratio": wi_doc["counterfactual"]["admittedRatio"],
        "whatif_admitted_delta": wi_doc["delta"]["admitted"],
        "whatif_admitted_ratio_delta": wi_doc["delta"]["admittedRatio"],
        "whatif_score_delta": wi_doc["delta"]["meanPlacementScore"],
    }
    if window_s > 0:
        out["record_calibration"] = reading["calibration"]
        out["record_windows"] = windows
        out["record_split"] = reading["split"]
    if aa:
        out["record_aa"] = True
    if divergences:
        out["diverged"] = rep_doc["diverged"][:3]  # evidence, bounded
    return out


def thread_rusage() -> tuple[int, int]:
    """The calling thread's voluntary and involuntary context switches so
    far (getrusage(RUSAGE_THREAD); (0, 0) where the platform has no
    per-thread reading)."""
    import resource

    who = getattr(resource, "RUSAGE_THREAD", None)
    if who is None:
        return 0, 0
    ru = resource.getrusage(who)
    return ru.ru_nvcsw, ru.ru_nivcsw


def replay_doc_core(doc: dict) -> dict:
    """A replay document without its wall-clock keys and the recorder's
    path and flush-timed counters: what a card run and a CPU run share."""
    out = {k: v for k, v in doc.items() if k not in REPLAY_WALL_KEYS}
    out["recorder_stats"] = {k: v for k, v in doc["recorder_stats"].items()
                             if k not in RECORDER_WALL_KEYS}
    return out


CHURN_FAULTS = ((4.0, "kill_node", "z0b0r0h0"), (6.0, "cordon", "z0b1r1h3"),
                (8.0, "revoke_node", "z1b0r2h5"))


def churn_world():
    """(topology, nodes, backlog, controller settings, simulator settings,
    scripted faults): a 256-node fleet (2 zones x 2 blocks x 4 racks x 16 hosts, 4 TPUs each)
    under a contended backlog with priority classes — 40 disaggregated sets
    ("low"), 30 aggregated sets ("high"; together they ask more TPUs than
    the fleet holds, so high-priority gangs preempt), 20 frontends — with a
    scripted node death, a cordon and a revocation notice (6 s of grace, so
    it expires inside the run), and defrag on."""
    from grove_tpu_torch.sim.workloads import (aggregated_pcs, bench_topology, disagg_pcs,
                                               frontend_pcs, synthetic_cluster)

    nodes = synthetic_cluster(zones=2, blocks_per_zone=2, racks_per_block=4,
                              hosts_per_rack=16, tpu=4.0)
    backlog = []
    for i in range(40):
        pcs = disagg_pcs(f"disagg-{i}")
        pcs.spec.template.priority_class_name = "low"
        backlog.append(pcs)
    for i in range(30):
        pcs = aggregated_pcs(f"agg-{i}")
        pcs.spec.template.priority_class_name = "high"
        backlog.append(pcs)
    backlog += [frontend_pcs(f"fe-{i}") for i in range(20)]
    ctl = {"priority_classes": {"high": 100, "low": 0}, "defrag_enabled": True,
           "defrag_threshold": 0.05, "defrag_interval_seconds": 5.0,
           "defrag_max_concurrent": 2}
    return bench_topology(), nodes, backlog, ctl, {"revocation_grace_s": 6.0}, CHURN_FAULTS


def same_views(views: list[dict], when: str) -> None:
    """Raise AssertionError at the first key where a view differs from the
    first one."""
    for v in views[1:]:
        if v != views[0]:
            key = next(k for k in views[0] if views[0][k] != v[k])
            raise AssertionError(f"stores differ {when}: "
                                 + first_difference(views[0][key], v[key], key))


def run_serving_lockstep(devices=("cuda", "cpu"), steps: int = 20, world=churn_world) -> dict:
    """The same serving world under one controller per device, stepped in
    lockstep: after every `Simulator.step` the stores must be equal
    (`serving_state`: each pod's node, phase, readiness and gates, each
    gang's phase and conditions, each PodCliqueSet's status, the events
    list), and at the end the whole stores (`store_view`) and the journals,
    seconds aside. Raises AssertionError at the first difference."""
    import shutil
    import tempfile

    from grove_tpu_torch.orchestrator.controller import GroveController
    from grove_tpu_torch.orchestrator.store import Cluster
    from grove_tpu_torch.sim.simulator import Simulator
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal

    root = tempfile.mkdtemp(prefix="grove-lockstep-")
    sides = []
    for i, dev in enumerate(devices):
        topo, nodes, backlog, ctl, sim_settings, faults = world()
        cluster = Cluster()
        for n in nodes:
            cluster.nodes[n.name] = n
        rec = TraceRecorder(os.path.join(root, f"side{i}"))
        rec.start()
        ctrl = GroveController(cluster=cluster, topology=topo, device=dev, recorder=rec, **ctl)
        sim = Simulator(cluster=cluster, controller=ctrl, **sim_settings)
        for at, action, target in faults:
            sim.schedule_fault(at, action, target)
        for pcs in backlog:
            cluster.podcliquesets[pcs.metadata.name] = pcs
        sides.append((cluster, ctrl, sim, rec))
    walls = [0.0] * len(sides)
    try:
        for step in range(steps):
            views = []
            for i, (cluster, ctrl, sim, _) in enumerate(sides):
                t0 = time.perf_counter()
                sim.step()
                walls[i] += time.perf_counter() - t0
                views.append(serving_state(cluster, ctrl))
            same_views(views, f"after step {step + 1}")
        same_views([store_view(cluster, ctrl) for cluster, ctrl, *_ in sides], "at the end")
    finally:
        for *_, rec in sides:
            rec.stop()
    journals = [strip_wall(read_journal(rec.path)) for *_, rec in sides]
    shutil.rmtree(root, ignore_errors=True)
    for j in journals[1:]:
        if j != journals[0]:
            i = next(i for i, (a, b) in enumerate(zip(journals[0], j)) if a != b) \
                if len(j) == len(journals[0]) else min(len(j), len(journals[0]))
            raise AssertionError(f"journals differ at record {i}")
    cluster, ctrl, sim, _ = sides[0]
    active = [p for p in cluster.pods.values() if p.is_active]
    return {
        "steps": steps,
        "nodes": len(cluster.nodes),
        "pods": len(active),
        "bound": sum(p.is_scheduled for p in active),
        "ready": sum(p.ready for p in active),
        "events": cluster.events_total,
        "journal_records": len(journals[0]),
        "journal_waves": sum(1 for r in journals[0] if r.get("kind") == "wave"),
        "solve_pass_counts": dict(ctrl.solve_pass_counts),
        "preemptions": sum(1 for r in journals[0] if r.get("action") == "preemption"),
        "defrag_counts": dict(ctrl.defrag_counts),
        "revocation_counts": dict(ctrl.revocation_counts),
        "defrag_score": ctrl.defrag_last.get("score"),
        "overcommitted_nodes": node_overcommit(cluster),
        "walls_s": walls,
    }


# bench.py's tenancy defaults (its GROVE_BENCH_TENANCY_* knobs unset, no
# soak): the arrival rate a second, the tenants, how long a bound workload
# holds, the sim seconds the backlog may drain after the trace, the trace's
# seed, the org's CPU quota and the fairness spread's cap. The quota sits
# below peak offered demand (rate * ~7 cpu * hold) so the tiers contend
# during the trace, but high enough that the backlog drains inside the tail.
TENANCY_DURATION_S = 75.0
TENANCY_RATE = 1.6
TENANCY_TENANTS = 200
TENANCY_HOLD_S = 12.0
TENANCY_TAIL_CAP_S = 240.0
TENANCY_SEED = 20260804
TENANCY_ORG_QUOTA = 64.0
TENANCY_SPREAD_CAP = 0.25


def run_tenancy_bench(device=None, *, duration_s: float = TENANCY_DURATION_S,
                      cpu_replay: bool = False) -> dict:
    """bench.py's `run_tenancy_bench` on the port, with its keys and gates:
    hundreds of churning tenants with a mixed SLO-class arrival trace pushed
    through the port's Manager reconcile loop under the Simulator, on the
    sim clock, every solve on `device` (None = the card), at bench.py's
    defaults (the TENANCY_* constants; `duration_s` seconds of trace) on 192
    nodes (1 x 2 x 8 x 12).

    One run, all surfaces: tenant queues under one borrowing org quota sized
    below peak demand, workloads departing TENANCY_HOLD_S after they bind,
    deterministic mid-trace chaos (node kill, un-cordon, pod fail), a flight
    recorder on the controller, and the fairness ledger read back at the
    end. Gates (vs_baseline is 1.0 only when all hold): the fairness spread
    bounded by TENANCY_SPREAD_CAP, tier p99 time-to-bind ordered latency <
    standard < batch-preemptible, the disruption budget never exceeded,
    reclaims exercised, zero lost gangs, zero oversubscribed ticks, the
    chaos injected and healed, and the journal replayed with zero
    divergences. With `cpu_replay` the journal is also replayed on the CPU's
    plain versions, and the document adds "cpu_replay_divergences" and
    "cpu_replay_waves"."""
    import shutil
    import tempfile

    from grove_tpu_torch.api import constants
    from grove_tpu_torch.runtime.config import parse_operator_config
    from grove_tpu_torch.runtime.manager import Manager
    from grove_tpu_torch.sim.simulator import Simulator
    from grove_tpu_torch.sim.workloads import (
        arrival_pcs,
        arrival_process,
        synthetic_cluster,
    )
    from grove_tpu_torch.tenancy import quantile
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal
    from grove_tpu_torch.trace.replay import replay_journal

    duration, n_tenants = float(duration_s), TENANCY_TENANTS

    events = arrival_process(
        TENANCY_SEED,
        duration_s=duration,
        base_rate=TENANCY_RATE,
        tenants=n_tenants,
        active_tenants=max(4, n_tenants // 16),
        tenant_churn_s=max(0.25, duration / max(1, n_tenants)),
        slo_mix=(
            ("latency", 0.2),
            ("standard", 0.5),
            ("batch-preemptible", 0.3),
        ),
    )
    tenant_names = sorted({ev.tenant for ev in events})
    # Every tenant's quota covers the LARGEST single workload (disagg, 17
    # cpu) so latency gangs — in-quota only — are always eventually
    # admissible, while a tenant running more than one workload at once has
    # to borrow; the org envelope below peak demand is what makes the tiers
    # contend (borrowers queue and get reclaimed, in-quota latency cuts
    # through).
    queues: dict = {"org": {"resources": {"cpu": {"quota": str(TENANCY_ORG_QUOTA)}}}}
    for t in tenant_names:
        queues[t] = {"parentQueue": "org", "resources": {"cpu": {"quota": "18"}}}
    cfg, errors = parse_operator_config(
        {
            "servers": {"healthPort": -1, "metricsPort": -1},
            "backend": {"enabled": False},
            "scheduling": {"queues": queues},
            "tenancy": {
                "enabled": True,
                "agingHalfLifeSeconds": 5.0,
                "agingMaxBoost": 4,
            },
            # Budget for a whole disagg family (base + 2 scaled gangs) with
            # one slot spare — whole-set reclaims fit, partials never happen.
            "defrag": {"maxConcurrentMigrations": 4},
        }
    )
    if errors:
        raise ValueError(f"operator config invalid: {errors}")
    m = Manager(cfg, device=device)
    for node in synthetic_cluster(
        zones=1, blocks_per_zone=2, racks_per_block=8, hosts_per_rack=12
    ):
        m.cluster.nodes[node.name] = node
    sim = Simulator(m.cluster, m.controller)
    trace_dir = tempfile.mkdtemp(prefix="grove-tenancy-trace-")
    recorder = TraceRecorder(trace_dir)
    recorder.start()
    m.controller.recorder = recorder

    pending_events = list(events)
    applied: dict[str, float] = {}  # workload -> sim time applied
    bound_at: dict[str, float] = {}
    delete_at: dict[str, float] = {}
    budget_peak = 0
    budget_samples = 0
    oversubscribed_ticks = 0
    fault_log: list[dict] = []
    killed_node: str | None = None
    uncordoned = False
    failed_pod: str | None = None
    kill_at = duration / 3.0
    uncordon_at = duration / 2.0
    fail_pod_at = 2.0 * duration / 3.0
    dt = 1.0
    wall0 = time.perf_counter()
    try:
        while True:
            now_next = sim.now + dt
            while pending_events and pending_events[0].t <= now_next:
                ev = pending_events.pop(0)
                pcs = arrival_pcs(ev)
                pcs.metadata.annotations[constants.ANNOTATION_QUEUE] = ev.tenant
                m.apply_podcliqueset(pcs)
                applied[ev.name] = now_next
            for name, at in list(delete_at.items()):
                if at <= now_next:
                    m.delete_podcliqueset(name)
                    del delete_at[name]
            # Deterministic chaos: targets are pure functions of sim state,
            # which is itself deterministic in the seed.
            if killed_node is None and now_next >= kill_at:
                busy: dict[str, int] = {}
                for p in m.cluster.pods.values():
                    if p.is_active and p.is_scheduled:
                        busy[p.node_name] = busy.get(p.node_name, 0) + 1
                if busy:
                    killed_node = min(
                        busy, key=lambda n: (-busy[n], n)
                    )  # busiest node, name-tiebroken
                    sim.kill_node(killed_node)
                    fault_log.append(
                        {"t": now_next, "action": "kill_node", "target": killed_node}
                    )
            if (
                killed_node is not None
                and not uncordoned
                and now_next >= uncordon_at
            ):
                sim.uncordon(killed_node)
                uncordoned = True
                fault_log.append(
                    {"t": now_next, "action": "uncordon", "target": killed_node}
                )
            if failed_pod is None and now_next >= fail_pod_at:
                victim = min(
                    (
                        p.name
                        for p in m.cluster.pods.values()
                        if p.is_active and p.is_scheduled
                    ),
                    default=None,
                )
                if victim is not None:
                    failed_pod = victim
                    sim.fail_pod(victim)
                    fault_log.append(
                        {"t": now_next, "action": "fail_pod", "target": victim}
                    )
            sim.step(dt)
            # Fresh FLOOR binds start the hold clock (churn departures).
            # Operational = every base gang scheduled; scaled gangs beyond
            # minAvailable are elastic extras, and holding a workload open
            # for them would deadlock the org quota on partial families.
            bases_by_pcs: dict[str, list] = {}
            for g in m.cluster.podgangs.values():
                if not g.is_scaled:
                    bases_by_pcs.setdefault(g.pcs_name, []).append(g)
            for name in list(applied):
                if name in bound_at or name not in m.cluster.podcliquesets:
                    continue
                bases = bases_by_pcs.get(name, [])
                if bases and all(g.is_base_gang_scheduled() for g in bases):
                    bound_at[name] = sim.now
                    delete_at[name] = sim.now + TENANCY_HOLD_S
            # Disruption budget + double-bind detectors, every tick.
            in_flight = m.controller.disrupted_now()
            budget_peak = max(budget_peak, in_flight)
            budget_samples += 1
            used: dict[str, dict[str, float]] = {}
            for p in m.cluster.pods.values():
                if p.is_active and p.is_scheduled:
                    node_used = used.setdefault(p.node_name, {})
                    for r, q in p.spec.total_requests().items():
                        node_used[r] = node_used.get(r, 0.0) + q
            for n, res in used.items():
                cap = m.cluster.nodes[n].capacity
                if any(q > cap.get(r, 0.0) + 1e-6 for r, q in res.items()):
                    oversubscribed_ticks += 1
                    break
            if not pending_events and not m.cluster.podcliquesets:
                break
            if sim.now >= duration + TENANCY_TAIL_CAP_S:
                break
        recorder.flush()
    finally:
        recorder.stop()
    wall_s = time.perf_counter() - wall0

    led = m.controller.tenancy_ledger
    pooled = led.tier_latencies()
    tiers = {
        cls: {
            "samples": len(samples),
            "p50_bind_s": round(quantile(samples, 0.50), 3),
            "p99_bind_s": round(quantile(samples, 0.99), 3),
        }
        for cls, samples in sorted(pooled.items())
    }
    p99 = {cls: d["p99_bind_s"] for cls, d in tiers.items()}
    tier_ordered = (
        all(cls in p99 for cls in ("latency", "standard", "batch-preemptible"))
        and p99["latency"] < p99["standard"] < p99["batch-preemptible"]
    )
    # Fairness on the FLOOR contract: per-tenant fraction of offered
    # workloads whose base gangs bound. Gang-level ledger ratios are
    # reported too but not gated — elastic extras deleted with their family
    # before binding depress them by design, not by unfairness.
    tenant_of = {ev.name: ev.tenant for ev in events}
    floor_offered: dict[str, int] = {}
    floor_bound: dict[str, int] = {}
    for name in applied:
        t = tenant_of[name]
        floor_offered[t] = floor_offered.get(t, 0) + 1
        if name in bound_at:
            floor_bound[t] = floor_bound.get(t, 0) + 1
    ratios = {
        t: floor_bound.get(t, 0) / n
        for t, n in floor_offered.items()
        if n >= 2
    }
    spread = (max(ratios.values()) - min(ratios.values())) if ratios else None
    gang_ratios = [
        st.admitted_ratio() for st in led.tenants.values() if st.submitted >= 2
    ]
    gang_spread = (max(gang_ratios) - min(gang_ratios)) if gang_ratios else None
    lost = sorted(n for n in applied if n not in bound_at)
    stranded = sorted(
        p.name
        for p in m.cluster.pods.values()
        if p.is_active
        and p.is_scheduled
        and not m.cluster.nodes[p.node_name].schedulable
    )

    records = read_journal(trace_dir)
    report = replay_journal(records, device=m.device)
    cpu_report = replay_journal(records, device="cpu") if cpu_replay else None
    shutil.rmtree(trace_dir, ignore_errors=True)
    reclaim_records = [
        r
        for r in records
        if r.get("kind") == "action" and r.get("action") == "quota-reclaim"
    ]

    gates = {
        "fairness_spread_bounded": (
            len(ratios) >= 5 and spread is not None and spread <= TENANCY_SPREAD_CAP
        ),
        "tier_p99_ordered": tier_ordered,
        "budget_never_exceeded": budget_peak <= m.controller.defrag_max_concurrent,
        "reclaims_exercised": led.totals["reclaims"] >= 1,
        "zero_lost_gangs": not lost and not m.cluster.podcliquesets,
        "zero_oversubscribed_ticks": oversubscribed_ticks == 0,
        "chaos_injected_and_healed": len(fault_log) >= 3 and not stranded,
        "replay_bit_identical": report.divergence_count == 0,
    }
    doc = {
        "scenario": "tenancy",
        "metric": "tenancy_fair_spread",
        "unit": "ratio",
        "value": round(spread, 4) if spread is not None else None,
        "vs_baseline": 1.0 if all(gates.values()) else 0.0,
        "gates": gates,
        "soak": False,
        "host_cpus": len(os.sched_getaffinity(0)),
        "trace_seed": TENANCY_SEED,
        "trace_duration_s": duration,
        "sim_seconds": round(sim.now, 1),
        "wall_s": round(wall_s, 3),
        "workloads_offered": len(events),
        "workloads_bound": len(bound_at),
        "tenant_count": len(led.tenants),
        "tenants_rated": len(ratios),
        "fair_spread_cap": TENANCY_SPREAD_CAP,
        "gang_admitted_ratio_spread": (
            round(gang_spread, 4) if gang_spread is not None else None
        ),
        "tiers": tiers,
        "ledger_totals": dict(led.totals),
        "budget_peak_in_flight": budget_peak,
        "budget_cap": m.controller.defrag_max_concurrent,
        "budget_samples": budget_samples,
        "oversubscribed_ticks": oversubscribed_ticks,
        "faults": fault_log,
        "lost_gangs": lost[:8],
        "stranded_pods": stranded[:8],
        "reclaim_decisions_journaled": len(reclaim_records),
        "replay_divergences": report.divergence_count,
        "replay_waves": len(report.waves),
    }
    if cpu_report is not None:
        doc["cpu_replay_divergences"] = cpu_report.divergence_count
        doc["cpu_replay_waves"] = len(cpu_report.waves)
    return doc


# The tenancy and rollout documents' keys that read the host's clock or its
# CPUs.
MANAGER_WALL_KEYS = ("wall_s", "host_cpus")


def manager_doc_core(doc: dict) -> dict:
    """A tenancy or rollout document without its wall-clock and host keys:
    what a card run, a CPU run and the JAX package's run share."""
    return {k: v for k, v in doc.items() if k not in MANAGER_WALL_KEYS}


# bench.py's rollout defaults (its GROVE_BENCH_ROLLOUT_* knobs unset, no
# soak): the trace's seconds, the arrival rate a second, the tenants, how
# long a bound workload holds, the sim seconds the run may go on after the
# trace, the trace's seed, the latency tier's p99 time-to-bind cap, and the
# busy revocable nodes each of the two storms hits.
ROLLOUT_DURATION_S = 90.0
ROLLOUT_RATE = 1.2
ROLLOUT_TENANTS = 60
ROLLOUT_HOLD_S = 10.0
ROLLOUT_TAIL_CAP_S = 300.0
ROLLOUT_SEED = 20260805
ROLLOUT_LAT_P99_S = 30.0
ROLLOUT_STORM1_NODES = 3
ROLLOUT_STORM2_NODES = 8


def run_rollout_bench(device=None, *, duration_s: float = ROLLOUT_DURATION_S,
                       cpu_replay: bool = False) -> dict:
    """bench.py's `run_rollout_bench` on the port, with its keys and gates,
    every solve on `device` (None = the card), at bench.py's defaults (the
    ROLLOUT_* constants; `duration_s` seconds of trace) on 64 nodes (1 x 2 x
    4 x 8), every other node revocable. The fleet-lifecycle chaos gate: a
    make-before-break rolling update of a long-lived resident workload
    OVERLAPPING a revocation storm on the revocable (spot) slice of the
    fleet, with a churning multi-tier arrival trace underneath — all through
    the Manager's reconcile loop on the sim clock, flight-recorded.

    Storm shape: wave 1 serves standard-grace notices on busy revocable
    nodes (the controller has room to rescue residents make-before-break);
    wave 2 serves short-grace notices (deadline already inside the eviction
    lead — the provider barely warned us), which MUST resolve by slo-ordered
    eviction. Between the waves the resident's generation hash changes with
    the make-before-break annotation set.

    Gates (vs_baseline is 1.0 only when ALL hold):
      - generation fully rolled: the rolling update ENDED, >= 1 MBB cutover
        committed, and no resident pod still carries the old template hash;
      - zero lost gangs: every offered arrival workload reached its floor
        binds and completed its hold; the resident is whole and ready;
      - zero oversubscribed ticks (double-bind detector, sampled per tick);
      - the shared disruption budget is NEVER exceeded at any sampled tick;
      - >= 1 revocation absorbed by make-before-break migration AND >= 1 by
        slo-ordered eviction;
      - latency-tier p99 time-to-bind bounded (the storm + rollout must not
        starve the latency tier);
      - replay: zero divergences re-solving the journal.

    With `cpu_replay` the journal is also replayed on the CPU's plain
    versions, and the document adds "cpu_replay_divergences" and
    "cpu_replay_waves"."""
    import shutil
    import tempfile

    from grove_tpu_torch.api import constants
    from grove_tpu_torch.orchestrator import expansion as _exp
    from grove_tpu_torch.runtime.config import parse_operator_config
    from grove_tpu_torch.runtime.manager import Manager
    from grove_tpu_torch.sim.simulator import Simulator
    from grove_tpu_torch.sim.workloads import (
        _clique,
        _pcs,
        arrival_pcs,
        arrival_process,
        synthetic_cluster,
    )
    from grove_tpu_torch.tenancy import quantile
    from grove_tpu_torch.trace.recorder import TraceRecorder, read_journal
    from grove_tpu_torch.trace.replay import replay_journal

    duration = float(duration_s)

    events = arrival_process(
        ROLLOUT_SEED,
        duration_s=duration,
        base_rate=ROLLOUT_RATE,
        tenants=ROLLOUT_TENANTS,
        active_tenants=max(4, ROLLOUT_TENANTS // 8),
        tenant_churn_s=max(0.5, duration / max(1, ROLLOUT_TENANTS)),
        slo_mix=(
            ("latency", 0.25),
            ("standard", 0.5),
            ("batch-preemptible", 0.25),
        ),
    )
    tenant_names = sorted({ev.tenant for ev in events})
    # Generous quotas: tenancy is on for the tier ledger (latency p99 gate),
    # not for contention — the storm and the rollout are the stressors here.
    queues: dict = {"org": {"resources": {"cpu": {"quota": "4096"}}}}
    for t in tenant_names:
        queues[t] = {"parentQueue": "org", "resources": {"cpu": {"quota": "128"}}}
    queues["resident-q"] = {
        "parentQueue": "org", "resources": {"cpu": {"quota": "512"}}
    }
    cfg, errors = parse_operator_config(
        {
            "servers": {"healthPort": -1, "metricsPort": -1},
            "backend": {"enabled": False},
            "scheduling": {"queues": queues},
            "tenancy": {"enabled": True},
            "defrag": {"maxConcurrentMigrations": 4},
            # The MBB machinery itself is opted into per-workload via the
            # grove.io/rollout-strategy annotation; the section here wires
            # the surge what-if + backoff knobs through the config path.
            "rollout": {"surgeRacks": 1, "deadlineSeconds": 120.0},
        }
    )
    if errors:
        raise ValueError(f"operator config invalid: {errors}")
    m = Manager(cfg, device=device)
    for node in synthetic_cluster(
        zones=1, blocks_per_zone=2, racks_per_block=4, hosts_per_rack=8
    ):
        m.cluster.nodes[node.name] = node
    # The revocable (spot) slice: every other node, interleaved across the
    # fleet — spot capacity mixed into the same racks as on-demand, so the
    # packing solver lands real work on it (a name-ordered tail slice would
    # sit idle and the storm would have nothing to hit).
    names_sorted = sorted(m.cluster.nodes)
    revocable_slice = set(names_sorted[1::2])
    for n in revocable_slice:
        m.cluster.nodes[n].revocable = True
    sim = Simulator(m.cluster, m.controller)
    trace_dir = tempfile.mkdtemp(prefix="grove-rollout-trace-")
    recorder = TraceRecorder(trace_dir)
    recorder.start()
    m.controller.recorder = recorder

    # The long-lived resident the rolling update targets: 6 replicas of
    # {srv x4 @8cpu, aux x2 @4cpu} — 36 pods, opted into make-before-break.
    resident = _pcs(
        "resident",
        cliques=[_clique("srv", 4, "8"), _clique("aux", 2, "4")],
        replicas=6,
    )
    resident.metadata.annotations[constants.ANNOTATION_QUEUE] = "resident-q"
    resident.metadata.annotations[constants.ANNOTATION_ROLLOUT_STRATEGY] = (
        constants.ROLLOUT_STRATEGY_MAKE_BEFORE_BREAK
    )
    resident = m.apply_podcliqueset(resident)

    pending_events = list(events)
    applied: dict[str, float] = {}
    bound_at: dict[str, float] = {}
    delete_at: dict[str, float] = {}
    budget_peak = 0
    budget_samples = 0
    oversubscribed_ticks = 0
    fault_log: list[dict] = []
    update_pushed = False
    storm_done = [False, False]
    update_at = duration * 0.3
    storm1_at = duration * 0.4
    storm2_at = duration * 0.6
    dt = 1.0
    wall0 = time.perf_counter()

    def _busy_revocable(k: int) -> list[str]:
        """The k busiest revocable nodes not yet under a notice — a pure
        function of (deterministic) sim state."""
        busy: dict[str, int] = {}
        for p in m.cluster.pods.values():
            if p.is_active and p.is_scheduled and p.node_name in revocable_slice:
                busy[p.node_name] = busy.get(p.node_name, 0) + 1
        alive = [
            n
            for n in busy
            if m.cluster.nodes[n].schedulable
            and m.cluster.nodes[n].revocation_deadline is None
        ]
        return sorted(alive, key=lambda n: (-busy[n], n))[:k]

    try:
        while True:
            now_next = sim.now + dt
            while pending_events and pending_events[0].t <= now_next:
                ev = pending_events.pop(0)
                pcs = arrival_pcs(ev)
                pcs.metadata.annotations[constants.ANNOTATION_QUEUE] = ev.tenant
                m.apply_podcliqueset(pcs)
                applied[ev.name] = now_next
            for name, at in list(delete_at.items()):
                if at <= now_next:
                    m.delete_podcliqueset(name)
                    del delete_at[name]
            if not update_pushed and now_next >= update_at:
                # Generation change: new image on the srv clique of the
                # STORED object — the controller's reconcile picks up the
                # hash change, and the MBB annotation routes it through
                # orchestrator/rollout.py.
                live = m.cluster.podcliquesets["resident"]
                for tmpl in live.spec.template.cliques:
                    if tmpl.name == "srv":
                        for c in tmpl.spec.pod_spec.containers:
                            c.image = c.image.rsplit(":", 1)[0] + ":v2"
                update_pushed = True
                fault_log.append(
                    {"t": now_next, "action": "rolling_update", "target": "resident"}
                )
            if not storm_done[0] and now_next >= storm1_at:
                for n in _busy_revocable(ROLLOUT_STORM1_NODES):
                    sim.revoke_node(n)
                    fault_log.append(
                        {"t": now_next, "action": "revoke_node", "target": n,
                         "grace_s": sim.revocation_grace_s}
                    )
                storm_done[0] = True
            if not storm_done[1] and now_next >= storm2_at:
                # Short-grace wave: the deadline lands inside the eviction
                # lead, so migration never gets a turn — the slo-ordered
                # eviction ladder MUST absorb these.
                sim.revocation_grace_s = (
                    m.controller.revocation_eviction_lead_seconds
                )
                for n in _busy_revocable(ROLLOUT_STORM2_NODES):
                    sim.revoke_node(n)
                    fault_log.append(
                        {"t": now_next, "action": "revoke_node", "target": n,
                         "grace_s": sim.revocation_grace_s}
                    )
                storm_done[1] = True
            sim.step(dt)
            bases_by_pcs: dict[str, list] = {}
            for g in m.cluster.podgangs.values():
                if not g.is_scaled:
                    bases_by_pcs.setdefault(g.pcs_name, []).append(g)
            for name in list(applied):
                if name in bound_at or name not in m.cluster.podcliquesets:
                    continue
                bases = bases_by_pcs.get(name, [])
                if bases and all(g.is_base_gang_scheduled() for g in bases):
                    bound_at[name] = sim.now
                    delete_at[name] = sim.now + ROLLOUT_HOLD_S
            in_flight = m.controller.disrupted_now()
            budget_peak = max(budget_peak, in_flight)
            budget_samples += 1
            used: dict[str, dict[str, float]] = {}
            for p in m.cluster.pods.values():
                if p.is_active and p.is_scheduled:
                    node_used = used.setdefault(p.node_name, {})
                    for r, q in p.spec.total_requests().items():
                        node_used[r] = node_used.get(r, 0.0) + q
            for n, res in used.items():
                cap = m.cluster.nodes[n].capacity
                if any(q > cap.get(r, 0.0) + 1e-6 for r, q in res.items()):
                    oversubscribed_ticks += 1
                    break
            prog = m.cluster.podcliquesets["resident"].status.rolling_update_progress
            rc = m.controller.revocation_counts
            drained = not pending_events and len(m.cluster.podcliquesets) == 1
            rolled = (
                update_pushed
                and prog is not None
                and prog.update_ended_at is not None
            )
            if (
                drained
                and rolled
                and rc["migrated"] >= 1
                and rc["evicted"] >= 1
                and sum(
                    1
                    for p in m.cluster.pods.values()
                    if p.pclq_fqn.startswith("resident-")
                    and p.is_active
                    and p.ready
                ) == 36
            ):
                break
            if sim.now >= duration + ROLLOUT_TAIL_CAP_S:
                break
        recorder.flush()
    finally:
        recorder.stop()
    wall_s = time.perf_counter() - wall0

    live_resident = m.cluster.podcliquesets["resident"]
    prog = live_resident.status.rolling_update_progress
    want_hash = _exp.compute_pod_template_hash(
        live_resident.clique_template("srv"),
        live_resident.spec.template.priority_class_name,
    )
    resident_pods = [
        p
        for p in m.cluster.pods.values()
        if p.pclq_fqn.startswith("resident-") and p.is_active
    ]
    stale_resident = [
        p.name
        for p in resident_pods
        if p.pclq_fqn.endswith("-srv") and p.pod_template_hash != want_hash
    ]
    resident_ready = sum(1 for p in resident_pods if p.ready)
    rollout_counts = dict(m.controller.rollout_counts)
    rc = dict(m.controller.revocation_counts)

    led = m.controller.tenancy_ledger
    pooled = led.tier_latencies()
    tiers = {
        cls: {
            "samples": len(samples),
            "p50_bind_s": round(quantile(samples, 0.50), 3),
            "p99_bind_s": round(quantile(samples, 0.99), 3),
        }
        for cls, samples in sorted(pooled.items())
    }
    lat_p99 = tiers.get("latency", {}).get("p99_bind_s")
    lost = sorted(n for n in applied if n not in bound_at)

    records = read_journal(trace_dir)
    report = replay_journal(records, device=m.device)
    cpu_report = replay_journal(records, device="cpu") if cpu_replay else None
    shutil.rmtree(trace_dir, ignore_errors=True)
    action_counts: dict[str, int] = {}
    for r in records:
        if r.get("kind") == "action":
            a = r.get("action", "")
            if a.startswith(("rollout.", "revocation.", "chaos.")):
                action_counts[a] = action_counts.get(a, 0) + 1

    gates = {
        "generation_rolled": (
            update_pushed
            and prog is not None
            and prog.update_ended_at is not None
            and rollout_counts["cutovers"] >= 1
            and not stale_resident
        ),
        "zero_lost_gangs": (
            not lost
            and len(m.cluster.podcliquesets) == 1
            and resident_ready == 36
        ),
        "zero_oversubscribed_ticks": oversubscribed_ticks == 0,
        "budget_never_exceeded": budget_peak <= m.controller.defrag_max_concurrent,
        "revocations_migrated_and_evicted": (
            rc["migrated"] >= 1 and rc["evicted"] >= 1
        ),
        "latency_p99_bounded": (
            lat_p99 is not None and lat_p99 <= ROLLOUT_LAT_P99_S
        ),
        "replay_bit_identical": report.divergence_count == 0,
    }
    doc = {
        "scenario": "rollout",
        "metric": "rollout_chaos_gates_green",
        "unit": "bool",
        "value": 1.0 if all(gates.values()) else 0.0,
        "vs_baseline": 1.0 if all(gates.values()) else 0.0,
        "gates": gates,
        "soak": False,
        "host_cpus": len(os.sched_getaffinity(0)),
        "trace_seed": ROLLOUT_SEED,
        "trace_duration_s": duration,
        "sim_seconds": round(sim.now, 1),
        "wall_s": round(wall_s, 3),
        "workloads_offered": len(events),
        "workloads_bound": len(bound_at),
        "lost_gangs": lost[:8],
        "resident_pods_ready": resident_ready,
        "resident_stale_pods": stale_resident[:8],
        "rollout_counts": rollout_counts,
        "revocation_counts": rc,
        "revocable_nodes": len(revocable_slice),
        "budget_peak_in_flight": budget_peak,
        "budget_cap": m.controller.defrag_max_concurrent,
        "budget_samples": budget_samples,
        "oversubscribed_ticks": oversubscribed_ticks,
        "latency_p99_cap_s": ROLLOUT_LAT_P99_S,
        "tiers": tiers,
        "faults": fault_log,
        "lifecycle_actions_journaled": action_counts,
        "replay_divergences": report.divergence_count,
        "replay_waves": len(report.waves),
    }
    if cpu_report is not None:
        doc["cpu_replay_divergences"] = cpu_report.divergence_count
        doc["cpu_replay_waves"] = len(cpu_report.waves)
    return doc


def json_patch(doc, ops: list):
    """`doc` with the RFC 6902 "add"/"replace" operations `ops` applied (the
    ones the mutating webhook answers with), as a new document."""
    import copy

    out = copy.deepcopy(doc)
    for op in ops:
        if op["op"] not in ("add", "replace"):
            raise ValueError(f"json_patch: unsupported op {op['op']!r}")
        tokens = [t.replace("~1", "/").replace("~0", "~") for t in op["path"].split("/")[1:]]
        parent = out
        for t in tokens[:-1]:
            parent = parent[int(t)] if isinstance(parent, list) else parent[t]
        last = tokens[-1]
        if isinstance(parent, list):
            if last == "-":
                parent.append(op["value"])
            elif op["op"] == "add":
                parent.insert(int(last), op["value"])
            else:
                parent[int(last)] = op["value"]
        else:
            parent[last] = op["value"]
    return out


def operator_config_doc(workdir: str, kwok_nodes: int = 24) -> dict:
    """examples/operator-config.yaml as the operator binary's smoke run
    takes it: `cluster.source: kwok` with `kwok_nodes` fabricated nodes
    (hosts of 8 CPU, 4 to a rack), the probe/API and webhook ports picked by
    the kernel, the hosted sidecar on a free port, JSON logs, a 50 ms
    reconcile interval, the flight recorder on, and every path it writes
    under `workdir`."""
    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "operator-config.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["log"]["format"] = "json"
    doc["leaderElection"]["leaseFile"] = os.path.join(workdir, "leader.lease")
    doc["servers"].update(bindAddress="127.0.0.1", healthPort=0, metricsPort=-1, webhookPort=0,
                          tlsCertDir=os.path.join(workdir, "certs"))
    doc["controllers"]["reconcileIntervalSeconds"] = 0.05
    doc["solver"]["shapeHistoryPath"] = os.path.join(workdir, "solve-shapes.json")
    doc["trace"].update(enabled=True, path=os.path.join(workdir, "trace"))
    doc["persistence"]["path"] = os.path.join(workdir, "state.json")
    doc["backend"]["port"] = 0
    doc["cluster"].update(source="kwok", kwokNodes=int(kwok_nodes), kwokHostsPerRack=4,
                          runningDelaySeconds=0.05, readyDelaySeconds=0.05)
    return doc


def run_operator_binary(device=None, *, kwok_nodes: int = 24, workload: str = "simple1.yaml",
                        timeout_s: float = 120.0) -> dict:
    """The operator binary as a user runs it: `python -m
    grove_tpu_torch.runtime --config <operator_config_doc>` in a subprocess
    (with `--device` when `device` is given; without it the solves run on the
    card). Waits for its "manager started" log line, reads /healthz and
    /readyz, waits for the KWOK fleet in /api/v1/nodes, sends
    examples/<workload> through the admission webhook over HTTPS (pinned to
    the binary's self-signed certificate): /webhook/v1/default's JSON patch
    applied, then /webhook/v1/validate; posts the admitted object to
    /api/v1/podcliquesets and waits until every pod is bound to a KWOK node
    and Ready and every PodGang is Starting or Running; reads /statusz;
    sends SIGTERM and waits for exit code 0. Returns the walls of each
    step, the counts, /statusz's "solver" section (its "device" holds the
    child's kernel launches) and the exit code; raises with the child's
    log on any failure."""
    import base64
    import queue
    import shutil
    import signal
    import subprocess
    import sys
    import tempfile
    import threading
    import urllib.request

    import yaml

    from grove_tpu_torch.runtime.certs import pinned_client_context

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    workdir = tempfile.mkdtemp(prefix="grove-operator-")
    cfg_path = os.path.join(workdir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(operator_config_doc(workdir, kwok_nodes), f)
    cmd = [sys.executable, "-m", "grove_tpu_torch.runtime", "--config", cfg_path]
    if device is not None:
        cmd += ["--device", str(device)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines: list[str] = []
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

    reader = threading.Thread(target=read_log, daemon=True)
    reader.start()

    def fail(msg):
        raise RuntimeError(f"operator binary: {msg}\n--- its log ---\n{''.join(lines[-60:])}")

    def http(port, path, body=None, method=None, ctx=None, scheme="http"):
        req = urllib.request.Request(f"{scheme}://127.0.0.1:{port}{path}", data=body,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
            return r.status, r.read().decode()

    def get(port, path):
        return json.loads(http(port, path)[1])

    def wait(what, cond, limit):
        deadline = time.perf_counter() + limit
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                fail(f"exited {proc.returncode} while waiting for {what}")
            got = cond()
            if got:
                return got
            time.sleep(0.05)
        fail(f"timed out after {limit} s waiting for {what}")

    out: dict = {"command": " ".join(cmd[1:]), "kwok_nodes": kwok_nodes}
    try:
        start = wait("the 'manager started' line",
                     lambda: started.get_nowait() if not started.empty() else None, timeout_s)
        out["boot_s"] = time.perf_counter() - t0
        hp, wp = start["health_port"], start["webhook_port"]
        out["probe"] = {p: http(hp, p)[0] for p in ("/healthz", "/readyz")}
        if set(out["probe"].values()) != {200}:
            fail(f"probes answered {out['probe']}")
        wait("the KWOK fleet", lambda: len(get(hp, "/api/v1/nodes")) == kwok_nodes, timeout_s)
        out["fleet_s"] = time.perf_counter() - t0

        with open(os.path.join(root, "examples", workload)) as f:
            obj = yaml.safe_load(f)
        ctx = pinned_client_context(os.path.join(workdir, "certs", "webhook", "tls.crt"))
        t_adm = time.perf_counter()

        def review(path, o, uid):
            body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                               "request": {"uid": uid, "operation": "CREATE", "object": o}})
            return json.loads(http(wp, path, body.encode(), "POST", ctx, "https")[1])["response"]

        mutated = review("/webhook/v1/default", obj, "smoke-default")
        if not mutated.get("allowed"):
            fail(f"the mutating webhook refused {workload}: {mutated}")
        ops = json.loads(base64.b64decode(mutated["patch"])) if mutated.get("patch") else []
        admitted = json_patch(obj, ops)
        validated = review("/webhook/v1/validate", admitted, "smoke-validate")
        if not validated.get("allowed"):
            fail(f"the validating webhook refused {workload}: {validated}")
        out["admission"] = {"patch_ops": len(ops), "allowed": True, "tls": True,
                            "wall_s": time.perf_counter() - t_adm}
        name = json.loads(http(hp, "/api/v1/podcliquesets", json.dumps(admitted).encode(),
                               "POST")[1])["name"]
        t_apply = time.perf_counter()

        def scheduled():
            names = get(hp, "/api/v1/pods")
            if not names:
                return None
            pods = [get(hp, f"/api/v1/pods/{n}") for n in names]
            if not all(p.get("ready") and str(p.get("node_name") or "").startswith("kwok-")
                       for p in pods):
                return None
            gangs = [get(hp, f"/api/v1/podgangs/{g}") for g in get(hp, "/api/v1/podgangs")]
            if not gangs or any(g.get("status", {}).get("phase") not in ("Starting", "Running")
                                for g in gangs):
                return None
            return len(pods), len(gangs)

        out["pods"], out["podgangs"] = wait(f"{name} scheduled and Ready", scheduled, timeout_s)
        out["workload"] = name
        out["schedule_s"] = time.perf_counter() - t_apply
        statusz = get(hp, "/statusz")
        out["statusz_solver"] = statusz["solver"]
        out["statusz_warm_path"] = statusz.get("warmPath")
        out["launches"] = statusz["solver"]["device"]["launches"]
        proc.send_signal(signal.SIGTERM)
        out["exit_code"] = proc.wait(timeout=60)
        if out["exit_code"] != 0:
            fail(f"exit code {out['exit_code']} after SIGTERM")
        reader.join(timeout=10)
        out["stopped_cleanly"] = any('"manager stopped"' in line for line in lines)
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(workdir, ignore_errors=True)


# bench.py's shard scenario: the drain's waves, and the top step's stream
# re-measure (its arrival trace's seconds and seed).
SHARD_WAVE_SIZE = 64
SHARD_STREAM_S = 8.0
SHARD_STREAM_SEED = 20260804


def shard_worker_problem(scale: float = 1.0, backlog_frac: float = 0.25):
    """The shard scenario's fixed (topology, fleet, gangs, pods, snapshot)
    (bench.py `_shard_worker_problem`): every ladder step solves the same
    problem, so the bindings must match across shard counts."""
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_backlog, synthetic_cluster
    from grove_tpu_torch.state import build_snapshot

    topo = bench_topology()
    nodes = synthetic_cluster(racks_per_block=max(1, round(16 * scale)))
    gangs, pods = _expand(synthetic_backlog(
        n_disagg=max(1, round(350 * backlog_frac)),
        n_agg=max(1, round(250 * backlog_frac)),
        n_frontend=max(1, round(300 * backlog_frac)),
    ))
    return topo, nodes, gangs, pods, build_snapshot(nodes, topo)


def bindings_digest(bindings: dict) -> str:
    """sha256 of the bindings as bench.py's shard worker serialises them."""
    import hashlib

    return hashlib.sha256(json.dumps(
        {g: dict(sorted(b.items())) for g, b in sorted(bindings.items())}).encode()).hexdigest()


def run_shard_worker(shards: int, *, scale: float = 1.0, backlog_frac: float = 0.25,
                     stream: bool = False, device=None, problem=None) -> dict:
    """One ladder step of the shard scenario (bench.py `run_shard_worker`),
    under a fresh list of `shards` virtual devices of `device` (None: the
    card): a warm-up drain, then the measured drain, both under
    MeshConfig(enabled, minNodes 64). With `stream` the pipelined stream is
    re-measured (the `stream` sub-document, unsharded as bench.py's).
    `problem` reuses shard_worker_problem's tuple."""
    from grove_tpu_torch.parallel import mesh as mesh_mod
    from grove_tpu_torch.solver.core import SolverParams, resolve_device
    from grove_tpu_torch.solver.drain import drain_backlog
    from grove_tpu_torch.solver.warm import WarmPath

    dev = resolve_device(device)
    topo, nodes, gangs, pods, snapshot = problem or shard_worker_problem(scale, backlog_frac)
    devices = mesh_mod.force_virtual_devices(shards, dev)
    try:
        wp = WarmPath()
        mesh_cfg = mesh_mod.MeshConfig(enabled=True, min_nodes=64)
        fallbacks0 = mesh_mod.shard_fallbacks()
        drain_backlog(gangs, pods, snapshot, wave_size=SHARD_WAVE_SIZE, params=SolverParams(),
                      warm_path=wp, mesh=mesh_cfg, device=dev)
        bindings, stats = drain_backlog(gangs, pods, snapshot, wave_size=SHARD_WAVE_SIZE,
                                        params=SolverParams(), warm_path=wp, mesh=mesh_cfg,
                                        device=dev)
        split = []
        if stats.shard_devices > 1:
            layout = mesh_cfg.layout_for(int(snapshot.free.shape[0]))
            split = [{"device": d.id, "nodeRows": hi - lo}
                     for d, (lo, hi) in zip(layout.mesh.flat,
                                            layout.spans(int(snapshot.free.shape[0])))]
        out = {
            "devices": 1 if dev.type == "cuda" else len({str(d.device) for d in devices}),
            "devices_requested": shards,
            "nodes": len(nodes),
            "node_pad": int(snapshot.free.shape[0]),
            "gangs": len(gangs),
            "wave_size": SHARD_WAVE_SIZE,
            "shard_devices": stats.shard_devices,
            "shard_fallbacks": mesh_mod.shard_fallbacks() - fallbacks0,
            "solve_total_s": round(stats.total_s, 3),
            "encode_s": round(stats.encode_s, 3),
            "dispatch_s": round(stats.dispatch_s, 3),
            "harvest_s": round(stats.harvest_s, 3),
            "admitted": stats.admitted,
            "pods_bound": stats.pods_bound,
            "lowerings_measured_run": stats.lowerings,
            "bindings_sha256": bindings_digest(bindings),
            "per_device_split": split,
        }
        if stream:
            from grove_tpu_torch.sim.workloads import arrival_process, expand_arrivals
            from grove_tpu_torch.solver.stream import StreamConfig, drain_stream

            events = arrival_process(SHARD_STREAM_SEED, duration_s=SHARD_STREAM_S,
                                     base_rate=6.0)
            arrivals, spods = expand_arrivals(events, topo)
            scfg = StreamConfig(depth=2, wave_size=32)
            drain_stream(arrivals, spods, snapshot, config=scfg, warm_path=wp, pipeline=True,
                         device=dev)
            b_ser, s_ser = drain_stream(arrivals, spods, snapshot, config=scfg, warm_path=wp,
                                        pipeline=False, device=dev)
            b_pipe, s_pipe = drain_stream(arrivals, spods, snapshot, config=scfg,
                                          warm_path=wp, pipeline=True, device=dev)
            out["stream"] = {
                "gangs_offered": s_pipe.offered,
                "admitted_parity": set(b_ser) == set(b_pipe),
                "serial_wall_s": round(s_ser.wall_s, 3),
                "pipeline_wall_s": round(s_pipe.wall_s, 3),
                "pipeline_speedup": round(s_ser.wall_s / s_pipe.wall_s, 3)
                if s_pipe.wall_s > 0 else None,
                "host_blocked_serial_s": round(s_ser.drain.harvest_s, 3),
                "host_blocked_pipeline_s": round(s_pipe.drain.harvest_s, 3),
            }
        return out
    finally:
        mesh_mod.force_virtual_devices(0)


def run_shard_bench(scale: float = 1.0, backlog_frac: float = 0.25,
                    ladder=(1, 2, 4, 8), *, stream: bool = True, device=None) -> dict:
    """bench.py's `run_shard_bench` on the port: run_shard_worker at every
    step of `ladder` (virtual shards of one card), the parity of the
    bindings digests across the steps, and the top step's solve speedup
    over the one-shard step, reported and not gated (`vs_baseline` reads
    the parity alone: virtual shards share one card's SMs)."""
    problem = shard_worker_problem(scale, backlog_frac)
    points = [run_shard_worker(nd, device=device, problem=problem,
                               stream=stream and nd == max(ladder))
              for nd in ladder]
    parity = len({p["bindings_sha256"] for p in points}) == 1
    base = next((p for p in points if p["devices_requested"] == 1), points[0])
    top = max(points, key=lambda p: p["devices_requested"])
    speedup = base["solve_total_s"] / top["solve_total_s"] if top["solve_total_s"] > 0 else 0.0
    out = {
        "scenario": "shard",
        "metric": "shard_solve_speedup",
        "unit": "x",
        "value": round(speedup, 3),
        "vs_baseline": 1.0 if parity else 0.0,
        "host_cpus": len(os.sched_getaffinity(0)),
        "virtual_shards": True,
        "device_ladder": list(ladder),
        "admitted_parity_across_devices": parity,
        "shard_scale": float(scale),
        "points": points,
    }
    if top.get("stream"):
        out["stream_remeasure"] = top["stream"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario",
                    choices=("default", "scale", "sweep", "stream", "chaos", "defrag", "replay",
                             "serving", "cells", "sidecar", "tenancy", "rollout", "quality",
                             "shard"),
                    default="default")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--portfolio", type=int, default=1)
    ap.add_argument("--no-baseline", dest="baseline", action="store_false")
    ap.add_argument("--harvest", choices=("wave", "chained"), default="wave")
    ap.add_argument("--scales", default="1,2,4")
    ap.add_argument("--backlog-frac", type=float, default=None)
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--prune-max", type=int, default=8191)
    ap.add_argument("--min-fleet", type=int, default=256)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default=None)
    ap.add_argument("--window-s", type=float, default=0.0,
                    help="replay: seconds of drains in the first OFF window (0: one drain)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="replay: rounds of windows, OFF, ON, ON, OFF and ON, OFF, OFF, "
                    "ON in turn")
    ap.add_argument("--aa", action="store_true",
                    help="replay: ON windows without a recorder (an A/A reading)")
    ap.add_argument("--duration-s", type=float, default=None,
                    help="tenancy, rollout: the arrival trace's seconds (default bench.py's "
                    "75 and 90)")
    args = ap.parse_args(argv)
    from grove_tpu_torch import faults

    faults.install(faults.from_config(None))  # GROVE_FAULTS arms the port's injector
    frac = args.backlog_frac
    if frac is None:
        frac = 0.25 if args.scenario == "shard" else 1.0
    args.backlog_frac = frac
    if args.scenario == "shard":
        out = run_shard_bench(args.scale, frac,
                              tuple(int(x) for x in args.shards.split(",") if x.strip()),
                              device=args.device)
    elif args.scenario == "tenancy":
        out = run_tenancy_bench(device=args.device, duration_s=(
            TENANCY_DURATION_S if args.duration_s is None else args.duration_s))
    elif args.scenario == "rollout":
        out = run_rollout_bench(device=args.device, duration_s=(
            ROLLOUT_DURATION_S if args.duration_s is None else args.duration_s))
    elif args.scenario == "quality":
        out = run_quality_bench(args.portfolio, device=args.device)
    elif args.scenario == "replay":
        out = run_replay_bench(args.scale, device=args.device, window_s=args.window_s,
                               rounds=args.rounds, aa=args.aa)
    elif args.scenario == "cells":
        out = run_cells_bench(device=args.device)
    elif args.scenario == "sidecar":
        out = run_sidecar_bench(args.scale, args.backlog_frac, device=args.device)
    elif args.scenario == "serving":
        out = run_serving_bench(args.scale, args.backlog_frac, device=args.device)
    elif args.scenario == "chaos":
        out = run_chaos_bench(device=args.device)
    elif args.scenario == "defrag":
        out = run_defrag_bench(args.scale, device=args.device)
    elif args.scenario == "sweep":
        out = run_sweep_bench(args.scale, k=args.k, device=args.device)
    elif args.scenario == "stream":
        out = run_stream_bench(args.scale, device=args.device)
    elif args.scenario == "scale":
        out = run_scale_bench(
            tuple(float(x) for x in args.scales.split(",") if x.strip()),
            backlog_frac=args.backlog_frac, max_candidates=args.prune_max,
            min_fleet=args.min_fleet, device=args.device,
        )
    else:
        out = run_bench(args.scale, device=args.device, portfolio=args.portfolio,
                        baseline=args.baseline, harvest=args.harvest)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
