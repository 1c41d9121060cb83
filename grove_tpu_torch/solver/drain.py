"""Mass admission: drain a whole gang backlog through the solver, one wave at
a time, chained on the device (grove_tpu/solver/drain.py counterpart, the
"chained" harvest discipline only).

  1. Shape-bucketed waves (plan_waves): gangs batch with others of their own
     padded encode shape; base gangs dispatch before scaled gangs.
  2. Every wave is encoded on the host, uploaded through pinned memory, and
     solved by one kernel launch on the current stream. The wave carry — the
     fleet's `free` tensor and the `ok_global` verdict bitmap — stays on the
     card and is updated in place by each launch (the JAX package donates
     the same two buffers), so the host never waits between waves.
  3. One harvest: a single synchronise, then every wave's verdicts come to
     the host. Waves retire in order and decode into pod -> node bindings.

Candidate pruning (`pruning`, solver/pruning.py): each wave's plan is cut
against the initial snapshot, and the wave solves on its candidate axis —
on the card the gather, the scatter back into the fleet carry and the remap
run inside the wave's one launch. Each pruned wave keeps a copy of the
carry it entered with. At retirement a wave holding a valid gang that was
rejected and marked lossy by its plan re-solves DENSE from that copy:
identical verdicts CONFIRM the pruned result; changed ones ADOPT the dense
result, re-chain every later wave from the adopted carry and harvest them
again. Admitted sets equal the dense drain's.

Portfolio (`portfolio` P > 1, the solver.portfolio knob): every wave is
solved under P weight variants and the winner's free_after and verdicts
chain forward — on the card one stacked launch per wave, the winner picked
on the card and written into the carry in place. The population is drawn
once per drain. Portfolio drains never prune (the JAX package's rule).

Warm paths, recording, meshes, faults and the other harvest modes of the
JAX package are later slices of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from grove_tpu_torch.solver.core import (
    SolverParams,
    decode_bindings,
    resolve_device,
    solve_batch,
    stack_on,
)
from grove_tpu_torch.solver.encode import encode_gangs, gang_shape, next_pow2
from grove_tpu_torch.solver.pruning import PruningConfig, lossy_rejections, plan_candidates


@dataclass
class DrainStats:
    """Phase breakdown of one drain (host wall seconds unless noted)."""

    encode_s: float = 0.0  # host dense encode, all waves
    prune_s: float = 0.0  # host candidate-plan cutting, all waves
    dispatch_s: float = 0.0  # upload + launch of every wave (no waiting)
    harvest_s: float = 0.0  # synchronises + device->host copies
    decode_s: float = 0.0  # host decode of all bindings into the result
    total_s: float = 0.0  # encode + prune + dispatch + harvest + decode
    waves: int = 0
    gangs: int = 0
    admitted: int = 0
    pods_bound: int = 0
    scores: list = field(default_factory=list)  # per admitted gang
    # Candidate pruning: waves solved on a candidate axis, the largest
    # candidate count and pad among them, and the escalation ledger (a
    # lossy-rejected wave re-solves dense; `escalations_adopted` counts the
    # re-solves that changed a verdict).
    pruned_waves: int = 0
    candidate_nodes: int = 0
    candidate_pad: int = 0
    escalations: int = 0
    escalations_adopted: int = 0
    # Host-blocking device->host fetches: 1 + escalations + adoptions that
    # left later waves to re-chain (each re-chain is harvested in one fetch).
    device_roundtrips: int = 0
    portfolio: int = 1  # weight variants per wave
    # The fleet's free capacity after the last wave, as the solver left it
    # (fetched in the one harvest).
    free_after: np.ndarray | None = None


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


def drain_backlog(
    gangs: list,
    pods_by_name: dict,
    snapshot,
    *,
    wave_size: int = 256,
    params: SolverParams | None = None,
    device=None,
    pruning: PruningConfig | None = None,
    portfolio: int = 1,
) -> tuple[dict[str, dict[str, str]], DrainStats]:
    """Admit a whole backlog; returns ({gang: {pod: node}}, DrainStats).

    All-or-nothing per gang; scaled gangs wait for their base's verdict on
    the device. `device` None means the card; "cpu" runs the plain PyTorch
    versions. `pruning` (enabled) solves each wave on its candidate axis,
    with the escalation described in the module docstring. `portfolio` > 1
    solves every wave under that many weight variants (pruning is then
    off)."""
    dev = resolve_device(device)
    params = params or SolverParams()
    if pruning is not None and (not pruning.enabled or portfolio > 1):
        pruning = None
    stats = DrainStats(gangs=len(gangs), portfolio=portfolio)
    if not gangs:
        return {}, stats
    waves = plan_waves(gangs, wave_size)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    chain = _Chain(snapshot, params, dev, len(gangs), stats, portfolio)

    t0 = time.perf_counter()
    recs = []
    for wave, (mg_c, ms_c, mp_c), pad in waves:
        te = time.perf_counter()
        batch, decode = encode_gangs(
            wave,
            pods_by_name,
            snapshot,
            max_groups=mg_c,
            max_sets=ms_c,
            max_pods=mp_c,
            pad_gangs_to=pad,
            global_index_of=gidx,
        )
        tp = time.perf_counter()
        stats.encode_s += tp - te
        plan = None
        if pruning is not None:
            # Cut against the initial snapshot: free only shrinks while
            # draining, so these candidates cover every later state.
            plan = plan_candidates(snapshot, batch, pruning)
            stats.prune_s += time.perf_counter() - tp
        if plan is not None:
            stats.pruned_waves += 1
            stats.candidate_nodes = max(stats.candidate_nodes, plan.count)
            stats.candidate_pad = max(stats.candidate_pad, plan.pad)
        rec = {"batch": batch, "decode": decode, "plan": plan}
        chain.dispatch(rec)
        recs.append(rec)
        stats.waves += 1

    chain.harvest(recs)
    bindings: dict[str, dict[str, str]] = {}
    for k, rec in enumerate(recs):
        if rec["plan"] is not None:
            lossy = lossy_rejections(rec["plan"], rec["batch"].gang_valid, rec["ok_np"])
            if lossy.any():
                chain.escalate(rec, recs[k + 1 :])
        td = time.perf_counter()
        wave_bindings = decode_bindings(rec["ok_np"], rec["assigned_np"], rec["decode"], snapshot)
        stats.scores.extend(rec["score_np"][rec["ok_np"]].tolist())
        for gang_name, pod_bindings in wave_bindings.items():
            bindings[gang_name] = pod_bindings
            stats.admitted += 1
            stats.pods_bound += len(pod_bindings)
        stats.decode_s += time.perf_counter() - td
    stats.total_s = time.perf_counter() - t0
    return bindings, stats


class _Chain:
    """The fleet's static tensors and the wave carry on one device, and the
    three things a drain does with them: dispatch a wave, harvest waves,
    escalate a lossy-rejected pruned wave."""

    def __init__(self, snapshot, params, dev, n_gangs, stats, portfolio=1):
        self.params, self.dev, self.stats = params, dev, stats
        self.portfolio, self.pstack = portfolio, None
        if portfolio > 1:
            from grove_tpu_torch.parallel.portfolio import params_population

            # Hoisted: drawn and uploaded once per drain, not per wave.
            self.pstack = stack_on(params_population(portfolio, base=params), dev)
        self.capacity = torch.as_tensor(snapshot.capacity, device=dev)
        self.schedulable = torch.as_tensor(snapshot.schedulable, device=dev)
        self.node_domain_id = torch.as_tensor(snapshot.node_domain_id, device=dev)
        self.domains = None
        if dev.type == "cuda":
            from grove_tpu_torch.kernels.place_wave import domain_index

            self.domains = domain_index(snapshot.node_domain_id, dev)
        # The wave carry. On the card each launch updates both in place.
        self.free = torch.as_tensor(snapshot.free, dtype=torch.float32, device=dev)
        self.ok_g = torch.zeros((n_gangs,), dtype=torch.bool, device=dev)

    def _solve(self, rec, free, ok_g, plan):
        if self.pstack is not None:
            from grove_tpu_torch.parallel.portfolio import portfolio_solve

            return portfolio_solve(
                free, self.capacity, self.schedulable, self.node_domain_id, rec["batch"],
                self.params, self.portfolio, ok_g, pstack=self.pstack, device=self.dev,
                domains=self.domains,
            )
        return solve_batch(
            free, self.capacity, self.schedulable, self.node_domain_id, rec["batch"],
            self.params, ok_g, device=self.dev, domains=self.domains, plan=plan,
        )

    def dispatch(self, rec) -> None:
        """Solve one wave from the current carry and advance the carry. A
        pruned wave keeps a copy of the carry it entered with."""
        td = time.perf_counter()
        if rec["plan"] is not None:
            rec["free_in"], rec["okg_in"] = self.free.clone(), self.ok_g.clone()
        res = self._solve(rec, self.free, self.ok_g, rec["plan"])
        self.free, self.ok_g = res.free_after, res.ok_global
        rec["res"] = res
        self.stats.dispatch_s += time.perf_counter() - td

    def harvest(self, recs) -> None:
        """One synchronise; the verdicts of `recs` and the carry's free come
        to the host."""
        th = time.perf_counter()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        for r in recs:
            res = r["res"]
            r["ok_np"] = res.ok.cpu().numpy()
            r["score_np"] = res.placement_score.cpu().numpy()
            r["assigned_np"] = res.assigned.cpu().numpy()
        self.stats.free_after = self.free.cpu().numpy()
        self.stats.device_roundtrips += 1
        self.stats.harvest_s += time.perf_counter() - th

    def escalate(self, rec, later) -> None:
        """Re-solve a lossy-rejected pruned wave dense from its entering
        carry. Identical verdicts confirm the pruned result; changed ones
        adopt the dense result and re-chain every later wave from the
        adopted carry."""
        stats = self.stats
        stats.escalations += 1
        th = time.perf_counter()
        dense = self._solve(rec, rec["free_in"].clone(), rec["okg_in"].clone(), None)
        dense_ok = dense.ok.cpu().numpy()
        stats.device_roundtrips += 1
        stats.harvest_s += time.perf_counter() - th
        if np.array_equal(dense_ok, rec["ok_np"]):
            return
        stats.escalations_adopted += 1
        rec.update(
            res=dense,
            plan=None,
            ok_np=dense_ok,
            score_np=dense.placement_score.cpu().numpy(),
            assigned_np=dense.assigned.cpu().numpy(),
        )
        self.free, self.ok_g = dense.free_after, dense.ok_global
        if not later:
            stats.free_after = self.free.cpu().numpy()
            return
        for r in later:
            self.dispatch(r)
        self.harvest(later)
