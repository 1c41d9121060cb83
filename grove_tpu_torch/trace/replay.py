"""Deterministic replay: rebuild each journaled solve wave and re-solve it
(grove_tpu/trace/replay.py counterpart).

The solver is deterministic in its inputs, so re-encoding a wave's recorded
input closure and re-solving it must reproduce the recorded plan bit for
bit: the same verdicts, the same pod->node bindings, the same placement
scores. A journal recorded by the JAX package replays here as one recorded
by the port does: the records' gangs and pods decode onto the port's types
(utils/serde.py), and the port's solve equals the JAX package's exactly.
Any divergence is reported as a structured diff.

A recorded mesh fingerprint is rebuilt into a layout
(parallel/mesh.py `layout_from_fingerprint`) when this process can host it
(enough devices, virtual ones included, on the replay's device type): the
wave then re-solves node-sharded, as recorded. Otherwise it re-solves
unsharded, which gives the same verdicts. Either way the fingerprint's node
axis sets the candidate pad: the pad was negotiated divisible by it.

Every solve goes through one warm path (solver/warm.py `WarmPath`, a fresh
one per replay unless the caller passes its own): a shape seen before
replays its prepared launch, and each fleet's node state and DomainIndex
are uploaded once.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.api.types import ClusterTopology
import torch

from grove_tpu_torch.solver.core import (
    SolverParams,
    decode_bindings,
    fetch_result,
    resolve_device,
    solve,
)
from grove_tpu_torch.solver.encode import encode_gangs
from grove_tpu_torch.solver.pruning import PruningConfig, plan_from_indices
from grove_tpu_torch.solver.warm import default_warm_path
from grove_tpu_torch.state.cluster import ClusterSnapshot, Node, build_snapshot
from grove_tpu_torch.trace import recorder as _recorder  # noqa: F401  (registers the types)
from grove_tpu_torch.utils import serde


@dataclass
class WaveReplay:
    """One wave's recorded-vs-replayed outcome."""

    index: int  # position among wave records in the journal
    wave: str
    gangs: int
    recorded_admitted: int
    replayed_admitted: int
    recorded_solve_s: float
    replayed_solve_s: float
    divergences: list = field(default_factory=list)  # structured diffs

    def to_doc(self) -> dict:
        return {
            "index": self.index,
            "wave": self.wave,
            "gangs": self.gangs,
            "recordedAdmitted": self.recorded_admitted,
            "replayedAdmitted": self.replayed_admitted,
            "recordedSolveSeconds": round(self.recorded_solve_s, 4),
            "replayedSolveSeconds": round(self.replayed_solve_s, 4),
            "divergences": self.divergences,
        }


@dataclass
class ReplayReport:
    waves: list = field(default_factory=list)  # WaveReplay, journal order

    @property
    def divergence_count(self) -> int:
        return sum(len(w.divergences) for w in self.waves)

    @property
    def recorded_solve_s(self) -> float:
        return sum(w.recorded_solve_s for w in self.waves)

    @property
    def replayed_solve_s(self) -> float:
        return sum(w.replayed_solve_s for w in self.waves)

    def to_doc(self) -> dict:
        return {
            "waves": len(self.waves),
            "divergences": self.divergence_count,
            "recordedSolveSeconds": round(self.recorded_solve_s, 4),
            "replayedSolveSeconds": round(self.replayed_solve_s, 4),
            "diverged": [w.to_doc() for w in self.waves if w.divergences],
        }


def nodes_from_fleet(fleet: dict) -> list[Node]:
    """Fleet record -> Node objects, in recorded order (order IS identity:
    snapshot node indices derive from it)."""
    return [
        Node(
            name=nd["name"],
            capacity=dict(nd.get("capacity", {})),
            labels=dict(nd.get("labels", {})),
            schedulable=bool(nd.get("schedulable", True)),
            taints=list(nd.get("taints", [])),
        )
        for nd in fleet["nodes"]
    ]


def topology_from_fleet(fleet: dict) -> ClusterTopology:
    return ClusterTopology.from_dict({"name": "trace", "levels": fleet["topology"]})


def snapshot_from_wave(wave: dict, fleet: dict, nodes: list[Node] | None = None,
                       bases: dict | None = None) -> ClusterSnapshot:
    """Rebuild the wave's pre-solve snapshot: recorded fleet + recorded
    per-node allocated rows (f32 round-trips JSON exactly: every f32 is a
    double). `bases`, a dict the caller keeps across waves, holds each
    fleet's snapshot by (digest, resources, node pad), built once: the
    wave's snapshot shares its node arrays and has its own allocated rows."""

    def build():
        return build_snapshot(
            nodes if nodes is not None else nodes_from_fleet(fleet),
            topology_from_fleet(fleet),
            resource_names=tuple(wave["resources"]),
            pad_nodes_to=wave["padNodesTo"],
        )

    if bases is None:
        snap = build()
    else:
        key = (wave["fleet"], tuple(wave["resources"]), wave["padNodesTo"])
        if key not in bases:
            bases[key] = build()
        base = bases[key]
        snap = dataclasses.replace(base, allocated=np.zeros_like(base.allocated))
    for name, row in wave.get("allocated", {}).items():
        if name in snap.node_index_map:
            snap.allocated[snap.node_index(name)] = np.asarray(row, np.float32)
    return snap


def pruning_of(cfg: dict) -> PruningConfig | None:
    """The recorded pruning fingerprint as a PruningConfig, or None (dense)."""
    pr = cfg.get("pruning")
    if not (pr and pr.get("enabled")):
        return None
    return PruningConfig(
        enabled=True,
        max_candidates=int(pr.get("maxCandidates", 8191)),
        pad_ladder=tuple(pr.get("padLadder", ())),
        min_pad=int(pr.get("minPad", 64)),
        min_fleet=int(pr.get("minFleet", 256)),
    )


def recorded_node_axis(cfg: dict) -> int:
    """The recorded mesh's node axis (1 without a mesh): a recorded
    candidate list's pad was rounded to a multiple of it."""
    mesh_fp = cfg.get("mesh")
    return int(mesh_fp.get("node", 1)) if mesh_fp else 1


def recut_node_axis(cfg: dict, n_nodes: int) -> int:
    """The node axis a plan re-cut at replay rounds its pad to: the
    recorded one where it divides the node axis (the JAX package rebuilds
    the recorded layout then), else 1."""
    k = recorded_node_axis(cfg)
    return k if k > 1 and n_nodes % k == 0 else 1


def recorded_layout(cfg: dict, n_nodes: int, dev):
    """The recorded mesh as a layout this process can launch on `dev`, or
    None (replay then solves unsharded)."""
    from grove_tpu_torch.parallel import mesh as mesh_mod

    layout = mesh_mod.layout_from_fingerprint(cfg.get("mesh"), n_nodes)
    if layout is None or layout.device.type != dev.type:
        return None
    return layout


def encode_wave_record(wave: dict, snapshot: ClusterSnapshot):
    """The wave's recorded encode closure, re-encoded: (batch, decode)."""
    gangs = [serde.decode(d) for d in wave["gangs"]]
    pods = {n: serde.decode(d) for n, d in wave["pods"].items()}
    return encode_gangs(
        gangs,
        pods,
        snapshot,
        max_groups=wave.get("maxGroups"),
        max_sets=wave.get("maxSets"),
        max_pods=wave.get("maxPods"),
        pad_gangs_to=wave.get("padGangsTo"),
        scheduled_gangs=set(wave.get("scheduled", [])),
        bound_nodes_by_group=wave.get("boundNodes") or None,
        reuse_nodes_by_gang=wave.get("reuseNodes") or None,
        spread_avoid_by_gang=wave.get("spreadAvoid") or None,
    )


def free_override_of(wave: dict, snapshot: ClusterSnapshot) -> np.ndarray | None:
    """The wave's exact entering free, where the record carries it (a
    drain's waves: the chained carry, fetched bit for bit); rows absent from
    freeRows entered the wave untouched (free == capacity)."""
    if not wave.get("freeRows"):
        return None
    free = np.array(snapshot.capacity, dtype=np.float32, copy=True)
    for name, row in wave["freeRows"].items():
        if name in snapshot.node_index_map:
            free[snapshot.node_index(name)] = np.asarray(row, np.float32)
    return free


def solve_wave_record(
    wave: dict,
    snapshot: ClusterSnapshot,
    *,
    warm=None,
    params: SolverParams | None = None,
    portfolio: int | None = None,
    escalate_portfolio: int | None = None,
    device=None,
) -> tuple[dict, dict, dict, float]:
    """Re-encode + re-solve one wave record against `snapshot`; returns
    (plan, ok_by_name, scores_by_name, solve_seconds). The solver config
    defaults to the recorded fingerprint. `warm` (a solver.warm.WarmPath;
    None = the process-shared one) holds the launch and device caches the
    solve goes through. `device` None means the card."""
    dev = resolve_device(device)
    warm = warm if warm is not None else default_warm_path()
    cfg = wave["solver"]
    pruning = pruning_of(cfg)
    params = params if params is not None else SolverParams(*cfg["params"])
    layout = recorded_layout(cfg, int(snapshot.capacity.shape[0]), dev)
    t0 = time.perf_counter()
    batch, decode = encode_wave_record(wave, snapshot)
    free_override = free_override_of(wave, snapshot)
    candidates = wave.get("candidates")
    if candidates is not None and pruning is not None:
        # A drain's pruned wave: its plan was cut against the drain's
        # initial free, which the record does not carry, so the recorded
        # candidate list rebuilds the exact gather. Escalation is moot: a
        # wave whose dense re-solve changed a verdict was journaled dense.
        plan = plan_from_indices(snapshot, candidates, pruning,
                                 int(np.asarray(batch.gang_valid).shape[0]),
                                 mesh_axis=recorded_node_axis(cfg))
        free = np.asarray(free_override if free_override is not None else snapshot.free,
                          np.float32)
        cache = warm.device
        result = warm.executables.solve(
            free, cache.device_array(plan.capacity, torch.float32, dev),
            cache.device_array(plan.schedulable, torch.bool, dev),
            cache.device_array(plan.node_domain_id, torch.int32, dev), plan.gather_batch(batch),
            params, None, device=dev,
            domains=cache.domain_index(plan.node_domain_id, dev,
                                       shards=layout and layout.node_devices)
            if dev.type == "cuda" else None,
            cand_idx=plan.padded_idx(), cand_count=plan.count, layout=layout,
        )
    else:
        portfolio = portfolio if portfolio is not None else cfg["portfolio"]
        result = solve(
            snapshot,
            batch,
            params,
            free=free_override,
            portfolio=portfolio,
            escalate_portfolio=(escalate_portfolio if escalate_portfolio is not None
                                else cfg["escalatePortfolio"]),
            device=dev,
            pruning=pruning,
            mesh_axis=recut_node_axis(cfg, int(snapshot.capacity.shape[0])),
            warm=warm,
            # A portfolio re-solve ignores it, as the JAX package's does.
            mesh=layout,
        )
    ok_np, assigned_np, score_np = fetch_result(result)
    plan = decode_bindings(ok_np, assigned_np, decode, snapshot)
    elapsed = time.perf_counter() - t0
    ok = dict(zip(decode.gang_names, (bool(x) for x in ok_np)))
    scores = dict(zip(decode.gang_names, (float(x) for x in score_np)))
    return plan, ok, scores, elapsed


def diff_wave(wave: dict, plan: dict, ok: dict, scores: dict) -> list[dict]:
    """Structured recorded-vs-replayed diff for one wave: verdict flips,
    binding differences, and (for admitted gangs) exact score mismatches."""
    divergences: list[dict] = []
    rec_ok = wave["ok"]
    rec_plan = wave["plan"]
    rec_scores = wave.get("scores", {})
    for gang in sorted(rec_ok):
        r_ok = bool(rec_ok[gang])
        p_ok = bool(ok.get(gang, False))
        if r_ok != p_ok:
            divergences.append({"gang": gang, "type": "verdict", "recorded": r_ok, "replayed": p_ok})
            continue
        if not r_ok:
            continue
        rb = rec_plan.get(gang, {})
        pb = plan.get(gang, {})
        if rb != pb:
            moved = {pod: [rb[pod], pb[pod]] for pod in rb.keys() & pb.keys() if rb[pod] != pb[pod]}
            divergences.append({
                "gang": gang,
                "type": "bindings",
                "moved": moved,
                "missing": sorted(rb.keys() - pb.keys()),
                "extra": sorted(pb.keys() - rb.keys()),
            })
            continue
        r_score = rec_scores.get(gang)
        p_score = scores.get(gang)
        if r_score is not None and p_score is not None and r_score != p_score:
            divergences.append({"gang": gang, "type": "score", "recorded": r_score,
                                "replayed": p_score})
    return divergences


def replay_journal(records: list[dict], *, warm_path=None, device=None) -> ReplayReport:
    """Replay every wave record in `records` (as `recorder.read_journal`
    returns them) through one warm path (`warm_path`, a fresh WarmPath when
    None) and diff it against its recorded plan. Raises ValueError when a
    wave references a fleet digest the journal does not contain (dropped
    under queue pressure, or a hand-pruned segment set)."""
    from grove_tpu_torch.solver.warm import WarmPath

    warm = warm_path if warm_path is not None else WarmPath()
    fleets: dict[str, dict] = {}
    bases: dict = {}
    report = ReplayReport()
    index = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "fleet":
            fleets[rec["digest"]] = rec
            continue
        if kind != "wave":
            continue
        fleet = fleets.get(rec["fleet"])
        if fleet is None:
            raise ValueError(
                f"wave {index} references fleet {rec['fleet']!r} which this journal does not "
                "contain (record dropped under queue pressure, or segments pruned apart) — "
                "cannot replay"
            )
        snapshot = snapshot_from_wave(rec, fleet, bases=bases)
        plan, ok, scores, elapsed = solve_wave_record(rec, snapshot, warm=warm, device=device)
        report.waves.append(WaveReplay(
            index=index,
            wave=rec.get("wave", "?"),
            gangs=len(rec["ok"]),
            recorded_admitted=sum(1 for v in rec["ok"].values() if v),
            replayed_admitted=sum(1 for v in ok.values() if v),
            recorded_solve_s=float(rec.get("solveSeconds", 0.0)),
            replayed_solve_s=elapsed,
            divergences=diff_wave(rec, plan, ok, scores),
        ))
        index += 1
    return report
