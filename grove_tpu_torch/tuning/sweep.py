"""Batched config-sweep replay: score K solver configs from one pass over a
journal (grove_tpu/tuning/sweep.py counterpart).

Each wave record is re-encoded once (exactly as trace/replay.py rebuilds
it), and the K candidate weight rows ride the stacked solve (B5: one launch
of K chain blocks on the card) instead of K replays. Row k equals a
single-config solve under config k bit for bit, so every row's verdicts are
what production would have decided under that config. What the stacked
solve cannot express falls back, for the affected row only, to the
production `solve()`:

  - portfolio > 1 configs (multi-variant themselves),
  - rows whose config would portfolio-escalate (a valid gang rejected and
    escalatePortfolio > portfolio),
  - candidate-pruned rows re-cut from the snapshot whose lossy witness fired
    on a rejection (production re-solves dense before it stands).

The row matching the recorded solver fingerprint is also diffed against the
journal's plans: its divergence count is the replay gate.

A drain's pruned waves carry their candidate list: the plan is rebuilt once
(`plan_from_indices`) and its gathered arrays are shared by all K rows of
one dense stacked launch. Same-shape runs of the dense waves a scan or
resident drain journals are solved as one launch of B6 (stacked_scan_solve:
W waves x K rows, each wave from its recorded entering free, no carry
between them), their lengths padded to powers of two with null waves (zero
free, all-invalid batch: they admit nothing).

Every launch goes through one warm path (solver/warm.py `WarmPath`; a fresh
one unless the caller passes its own): the B6 and B5 launches through its
launch cache (`solve_scan_stacked`, `solve_stacked`), the production
fallbacks through `solve(warm=)`, each fleet's node state and DomainIndex
uploaded once.
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
    solve,
)
from grove_tpu_torch.solver.encode import GangBatch
from grove_tpu_torch.solver.pruning import lossy_rejections, plan_candidates, plan_from_indices
from grove_tpu_torch.trace.replay import (
    diff_wave,
    encode_wave_record,
    free_override_of,
    pruning_of,
    recorded_node_axis,
    recut_node_axis,
    snapshot_from_wave,
)

_N_WEIGHTS = len(SolverParams._fields)

# Longest same-signature wave run solved as one stacked-scan launch; runs pad
# to power-of-two lengths.
_MAX_RUN = 64


@dataclass(frozen=True)
class SweepConfig:
    """One candidate solver config in the sweep grid."""

    name: str
    weights: tuple  # floats, SolverParams field order
    portfolio: int = 1
    escalate_portfolio: int = 1

    def solver_params(self) -> SolverParams:
        return SolverParams(*(float(w) for w in self.weights))

    def matches_fingerprint(self, cfg: dict) -> bool:
        """True iff this config IS the recorded solver fingerprint — its
        sweep row must then reproduce the journal bit for bit."""
        return (
            [float(w) for w in self.weights] == [float(w) for w in cfg["params"]]
            and self.portfolio == int(cfg["portfolio"])
            and self.escalate_portfolio == int(cfg["escalatePortfolio"])
        )

    def to_doc(self) -> dict:
        return {
            "name": self.name,
            "weights": {f: float(w) for f, w in zip(SolverParams._fields, self.weights)},
            "portfolio": self.portfolio,
            "escalatePortfolio": self.escalate_portfolio,
        }


def incumbent_config(records: list) -> SweepConfig:
    """The recorded solver fingerprint as a SweepConfig (from the first wave
    record). Raises on a journal with no waves: there is nothing to tune."""
    for rec in records:
        if rec.get("kind") == "wave":
            cfg = rec["solver"]
            return SweepConfig(
                name="incumbent",
                weights=tuple(float(w) for w in cfg["params"]),
                portfolio=int(cfg["portfolio"]),
                escalate_portfolio=int(cfg["escalatePortfolio"]),
            )
    raise ValueError("journal contains no wave records — nothing to sweep")


def default_grid(incumbent: SweepConfig, k: int, *, spread: float = 0.5,
                 seed: int = 0) -> list[SweepConfig]:
    """K-config grid around the incumbent: row 0 is the incumbent itself,
    the rest deterministic log-normal weight perturbations, odd rows with
    w_tight's sign flipped (worst fit), every fourth row without portfolio
    escalation (the JAX package's grid, drawn from the same numpy stream)."""
    if k < 1:
        raise ValueError(f"grid size {k} < 1")
    rng = np.random.default_rng(seed)
    factors = np.exp(rng.normal(0.0, spread, size=(k, _N_WEIGHTS))).astype(np.float64)
    factors[0, :] = 1.0
    base = np.asarray([float(w) for w in incumbent.weights], dtype=np.float64)
    stack = factors * base[None, :]
    tight_i = SolverParams._fields.index("w_tight")
    stack[1::2, tight_i] *= -1.0
    grid = [SweepConfig(name="incumbent", weights=incumbent.weights,
                        portfolio=incumbent.portfolio,
                        escalate_portfolio=incumbent.escalate_portfolio)]
    for i in range(1, k):
        esc = 1 if i % 4 == 3 else incumbent.escalate_portfolio
        grid.append(SweepConfig(name=f"cand-{i:02d}", weights=tuple(float(x) for x in stack[i]),
                                portfolio=incumbent.portfolio, escalate_portfolio=esc))
    return grid


@dataclass
class ConfigTally:
    """One config's accumulated outcome over the waves it has seen."""

    config: SweepConfig
    waves: int = 0
    gangs: int = 0  # solver-valid gangs offered
    admitted: int = 0
    score_sum: float = 0.0  # placement score over admitted gangs
    solve_s: float = 0.0  # attributed share of the wave's cost
    escalations: int = 0  # production-semantics fallback rows (this config)
    divergences: int = 0  # vs recorded plans (fingerprint-matching rows only)
    # Per wave, in consumption order: (plan, ok_by_name, scores_by_name).
    plans: list = field(default_factory=list)

    @property
    def admitted_ratio(self) -> float:
        return self.admitted / self.gangs if self.gangs else 0.0

    @property
    def mean_score(self) -> float:
        return self.score_sum / self.admitted if self.admitted else 0.0

    def rank_key(self) -> tuple:
        """Winner order: admitted first, quality tie-break, then name."""
        return (self.admitted, self.score_sum, self.config.name)

    def to_doc(self) -> dict:
        return {
            "config": self.config.to_doc(),
            "waves": self.waves,
            "gangs": self.gangs,
            "admitted": self.admitted,
            "admittedRatio": round(self.admitted_ratio, 4),
            "meanPlacementScore": round(self.mean_score, 4),
            "solveSeconds": round(self.solve_s, 4),
            "escalations": self.escalations,
            "divergences": self.divergences,
        }


@dataclass
class _WavePrep:
    """One wave record's host-side preparation (encode + snapshot rebuild),
    done once whether the wave solves alone or inside a stacked-scan run."""

    rec: dict
    snapshot: object
    cfg: dict
    batch: GangBatch  # numpy leaves
    decode: object
    valid_np: np.ndarray
    free_override: object  # np [N, R] | None
    free_np: np.ndarray  # the entering free actually solved from
    pruning: object  # PruningConfig | None
    prep_s: float  # host seconds spent building this prep


class SweepEngine:
    """Replays journal records once, scoring every active config per wave.

    Feed it record batches with `consume`; restrict the grid between batches
    with `keep`. Fleet records are cached across batches. `warm_path` (a
    solver.warm.WarmPath, a fresh one when None) holds the launch, device
    and encode caches every solve goes through. `device` None means the
    card; "cpu" runs the plain versions."""

    def __init__(self, configs: list, *, warm_path=None, device=None) -> None:
        from grove_tpu_torch.solver.warm import WarmPath

        if not configs:
            raise ValueError("sweep needs at least one config")
        names = [c.name for c in configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate config names in grid: {names}")
        self.dev = resolve_device(device)
        self.warm = warm_path if warm_path is not None else WarmPath()
        self.configs = list(configs)
        self.tallies: dict[str, ConfigTally] = {c.name: ConfigTally(c) for c in configs}
        self.waves_seen = 0
        self.stacked_solves = 0
        self.scan_stacked_solves = 0  # same-shape wave runs solved as one launch
        self.fallback_solves = 0  # production-semantics per-row re-solves
        self._fleets: dict[str, dict] = {}
        self._bases: dict = {}  # snapshot_from_wave's per-fleet snapshots

    # ---- grid management ---------------------------------------------------

    def keep(self, names: set) -> None:
        """Restrict the active grid to `names`: eliminated configs keep their
        tallies for the report but stop accruing."""
        survivors = [c for c in self.configs if c.name in names]
        if not survivors:
            raise ValueError("halving eliminated every config")
        self.configs = survivors

    def _param_stack(self, sel) -> np.ndarray:
        """f32 [len(sel), 5]: the weight rows of the configs at `sel`."""
        return np.asarray([[float(w) for w in self.configs[i].weights] for i in sel],
                          dtype=np.float32)

    def _node_state(self, capacity, schedulable, node_domain_id):
        """(capacity, schedulable, node_domain_id, DomainIndex or None) from
        the warm path's device cache: a fleet (or plan) seen before uploads
        nothing."""
        cache, dev = self.warm.device, self.dev
        return (
            cache.device_array(capacity, torch.float32, dev),
            cache.device_array(schedulable, torch.bool, dev),
            cache.device_array(node_domain_id, torch.int32, dev),
            cache.domain_index(node_domain_id, dev) if dev.type == "cuda" else None,
        )

    # ---- consumption -------------------------------------------------------

    def consume(self, records: list) -> None:
        """Process one batch of journal records (fleets + waves).

        Consecutive wave records with matching signatures (a scan drain's
        runs) buffer and solve as one stacked-scan launch; a signature
        break, a run reaching _MAX_RUN or the end of the batch flushes. Runs
        never span consume() calls."""
        run: list[_WavePrep] = []
        run_sig = None

        def flush() -> None:
            nonlocal run, run_sig
            if len(run) >= 2:
                self._wave_run(run)
            elif run:
                self._wave_single(run[0])
            run = []
            run_sig = None

        for rec in records:
            kind = rec.get("kind")
            if kind == "fleet":
                self._fleets[rec["digest"]] = rec
                continue
            if kind != "wave":
                continue
            fleet = self._fleets.get(rec["fleet"])
            if fleet is None:
                raise ValueError(
                    f"wave {self.waves_seen} references fleet {rec['fleet']!r} missing from "
                    "this journal — cannot sweep (recorder drops? check journal_stats' "
                    "recorderDropped)"
                )
            prep = self._prep_wave(rec, fleet)
            self.waves_seen += 1
            sig = self._run_sig(prep)
            if sig is None:
                flush()
                self._wave_single(prep)
                continue
            if run and sig != run_sig:
                flush()
            run.append(prep)
            run_sig = sig
            if len(run) >= _MAX_RUN:
                flush()
        flush()

    def _run_sig(self, prep: _WavePrep):
        """Stacked-scan run signature, or None when the wave cannot join a
        run: runs are dense. A recorded-candidate wave needs its own gather,
        and a pruned wave without recorded free re-cuts its plan from the
        snapshot. Equal signatures rebuild equal capacity, schedulable and
        node_domain_id and stack leaf for leaf."""
        if prep.rec.get("candidates") is not None:
            return None
        if prep.pruning is not None and prep.free_override is None:
            return None
        leaves = tuple(None if x is None else (tuple(np.shape(x)), str(np.asarray(x).dtype))
                       for x in prep.batch)
        return (prep.rec["fleet"], tuple(prep.rec["resources"]), prep.rec["padNodesTo"], leaves)

    def _prep_wave(self, rec: dict, fleet: dict) -> _WavePrep:
        t0 = time.perf_counter()
        snapshot = snapshot_from_wave(rec, fleet, bases=self._bases)
        # One encode for all K rows: the closure replay rebuilds.
        batch, decode = encode_wave_record(rec, snapshot)
        free_override = free_override_of(rec, snapshot)
        free_np = free_override if free_override is not None else np.asarray(snapshot.free,
                                                                               np.float32)
        return _WavePrep(
            rec=rec, snapshot=snapshot, cfg=rec["solver"], batch=batch, decode=decode,
            valid_np=np.asarray(batch.gang_valid, dtype=bool), free_override=free_override,
            free_np=free_np, pruning=pruning_of(rec["solver"]),
            prep_s=time.perf_counter() - t0,
        )

    def _wave_single(self, prep: _WavePrep) -> None:
        t0 = time.perf_counter()
        rows = self._solve_rows(prep)
        self._tally(prep, rows, prep.prep_s + time.perf_counter() - t0)

    def _tally(self, prep: _WavePrep, rows: list, elapsed: float) -> None:
        rec, snapshot, decode = prep.rec, prep.snapshot, prep.decode
        per_cfg = elapsed / max(len(self.configs), 1)
        g_real = len(decode.gang_names)
        for config, (ok_row, assigned_row, score_row) in zip(self.configs, rows):
            plan = decode_bindings(ok_row, assigned_row, decode, snapshot)
            ok = dict(zip(decode.gang_names, (bool(x) for x in ok_row)))
            scores = dict(zip(decode.gang_names, (float(x) for x in score_row)))
            tally = self.tallies[config.name]
            tally.waves += 1
            tally.gangs += int(prep.valid_np.sum())
            ok_arr = np.asarray(ok_row, dtype=bool)[:g_real]
            tally.admitted += int(ok_arr.sum())
            tally.score_sum += float(np.asarray(score_row)[:g_real][ok_arr].sum())
            tally.solve_s += per_cfg
            tally.plans.append((plan, ok, scores))
            if config.matches_fingerprint(prep.cfg):
                tally.divergences += len(diff_wave(rec, plan, ok, scores))

    # ---- the stacked-scan run solve ----------------------------------------

    def _wave_run(self, run: list) -> None:
        """A same-signature run of journaled waves under every active config
        as one B6 launch: each step replays its wave from its recorded
        entering free with no carry between steps, so row (w, k) is what
        _wave_single's stacked solve gives wave w; the per-wave escalation
        fallbacks apply unchanged afterwards."""
        t0 = time.perf_counter()
        w_real = len(run)
        rows_by_wave: list = [[None] * len(self.configs) for _ in run]
        stackable = [i for i, c in enumerate(self.configs) if c.portfolio == 1]
        if stackable:
            # Power-of-two run length, padded with null waves (zero free,
            # all-invalid batch): a null step admits nothing and there is no
            # carry to disturb, so its rows are discarded.
            w_pad = 1 << (w_real - 1).bit_length()

            def stack(arrs, dtype=None):
                out = np.stack([np.asarray(a) for a in arrs])
                if dtype is not None:
                    out = out.astype(dtype, copy=False)
                if w_pad > w_real:
                    out = np.concatenate(
                        [out, np.zeros((w_pad - w_real,) + out.shape[1:], out.dtype)])
                return out

            sbatch = GangBatch(*(None if leaf0 is None else stack([p.batch[i] for p in run])
                                 for i, leaf0 in enumerate(run[0].batch)))
            snap = run[0].snapshot
            cap, sched, ndid, domains = self._node_state(snap.capacity, snap.schedulable,
                                                         snap.node_domain_id)
            result = self.warm.executables.solve_scan_stacked(
                stack([p.free_np for p in run], np.float32), cap, sched, ndid, sbatch,
                self._param_stack(stackable), device=self.dev, domains=domains,
            )
            self.scan_stacked_solves += 1
            ok_wk = result.ok.cpu().numpy()
            assigned_wk = result.assigned.cpu().numpy()
            score_wk = result.placement_score.cpu().numpy()
            for w, prep in enumerate(run):
                for j, i in enumerate(stackable):
                    config = self.configs[i]
                    if config.escalate_portfolio > config.portfolio and bool(
                            np.any(prep.valid_np & ~ok_wk[w, j])):
                        # Production would escalate: the per-row fallback.
                        rows_by_wave[w][i] = self._solve_row_production(prep, config)
                        self.tallies[config.name].escalations += 1
                    else:
                        rows_by_wave[w][i] = (ok_wk[w, j], assigned_wk[w, j], score_wk[w, j])
        for w, prep in enumerate(run):
            for i, config in enumerate(self.configs):
                if rows_by_wave[w][i] is None:
                    rows_by_wave[w][i] = self._solve_row_production(prep, config)
        solve_s = (time.perf_counter() - t0) / w_real
        for w, prep in enumerate(run):
            self._tally(prep, rows_by_wave[w], prep.prep_s + solve_s)

    # ---- the per-wave K-row solve ------------------------------------------

    def _solve_rows(self, prep: _WavePrep) -> list:
        """One wave under every active config: [(ok [G], assigned [G, MP],
        score [G])] in config order, each row equal to the production solve
        under that config."""
        rec, snapshot, batch, valid_np = prep.rec, prep.snapshot, prep.batch, prep.valid_np
        cfg, pruning = prep.cfg, prep.pruning
        rows: list = [None] * len(self.configs)
        candidates = rec.get("candidates")
        if candidates is not None:
            # Recorded-candidate waves replay single-variant whatever the
            # portfolio (replay.py's candidates branch): every row stacks.
            stackable = list(range(len(self.configs)))
        else:
            stackable = [i for i, c in enumerate(self.configs) if c.portfolio == 1]
        pplan = None
        if candidates is not None and pruning is not None:
            # A drain's pruned wave: the recorded gather, rebuilt once and
            # shared by all K rows. Escalation is moot (replay.py).
            pplan = plan_from_indices(snapshot, candidates, pruning, int(valid_np.shape[0]),
                                      mesh_axis=recorded_node_axis(cfg))
        elif pruning is not None and prep.free_override is None and stackable:
            # A serving wave: re-cut the plan as solve() would.
            pplan = plan_candidates(snapshot, batch, pruning,
                                    mesh_axis=recut_node_axis(cfg, int(snapshot.capacity.shape[0])))

        if stackable:
            pstack = self._param_stack(stackable)
            if pplan is not None:
                # The dense stacked launch on the plan's gathered arrays.
                cap, sched, ndid, domains = self._node_state(
                    pplan.capacity, pplan.schedulable, pplan.node_domain_id)
                result = self.warm.executables.solve_stacked(
                    pplan.gather_free(prep.free_np), cap, sched, ndid,
                    pplan.gather_batch(batch), pstack, device=self.dev, domains=domains,
                )
                assigned_k = pplan.remap_assigned(result.assigned.cpu().numpy())
            else:
                cap, sched, ndid, domains = self._node_state(
                    snapshot.capacity, snapshot.schedulable, snapshot.node_domain_id)
                result = self.warm.executables.solve_stacked(
                    prep.free_np, cap, sched, ndid, batch, pstack, device=self.dev,
                    domains=domains,
                )
                assigned_k = result.assigned.cpu().numpy()
            self.stacked_solves += 1
            ok_k = result.ok.cpu().numpy()
            score_k = result.placement_score.cpu().numpy()
            recut_pruned = pplan is not None and candidates is None
            for j, i in enumerate(stackable):
                config = self.configs[i]
                # A lossy pruned rejection would re-solve dense in
                # production; so would a valid rejection that escalates.
                needs_fallback = recut_pruned and bool(
                    lossy_rejections(pplan, valid_np, ok_k[j]).any())
                if (candidates is None and config.escalate_portfolio > config.portfolio
                        and bool(np.any(valid_np & ~ok_k[j]))):
                    needs_fallback = True
                if needs_fallback:
                    rows[i] = self._solve_row_production(prep, config)
                    self.tallies[config.name].escalations += 1
                else:
                    rows[i] = (ok_k[j], assigned_k[j], score_k[j])

        for i, config in enumerate(self.configs):
            if rows[i] is None:
                # portfolio > 1 rows: production straight through solve().
                rows[i] = self._solve_row_production(prep, config)
        return rows

    def _solve_row_production(self, prep: _WavePrep, config: SweepConfig):
        """The fallback that is production by construction: solve() under
        this config, as a standalone replay would run it."""
        self.fallback_solves += 1
        result = solve(
            prep.snapshot, prep.batch, config.solver_params(), free=prep.free_override,
            portfolio=config.portfolio, escalate_portfolio=config.escalate_portfolio,
            device=self.dev, pruning=prep.pruning, warm=self.warm,
        )
        return (result.ok.cpu().numpy(), result.assigned.cpu().numpy(),
                result.placement_score.cpu().numpy())

    # ---- reporting ---------------------------------------------------------

    def to_doc(self) -> dict:
        ranked = sorted(self.tallies.values(), key=lambda t: t.rank_key(), reverse=True)
        return {
            "waves": self.waves_seen,
            "stackedSolves": self.stacked_solves,
            "scanStackedSolves": self.scan_stacked_solves,
            "fallbackSolves": self.fallback_solves,
            "configs": [t.to_doc() for t in ranked],
        }


def sweep_journal(records: list, configs: list, *, warm_path=None,
                  device=None) -> SweepEngine:
    """One-shot sweep of a whole journal under a fixed grid."""
    engine = SweepEngine(configs, warm_path=warm_path, device=device)
    engine.consume(records)
    return engine
