"""Successive-halving search over a solver-config grid, from one journal
(grove_tpu/tuning/search.py counterpart).

The sweep engine (tuning/sweep.py) scores K configs at about the cost of one
replay; halving shrinks K while the journal plays: after each rung (a
contiguous chunk of the journal's waves) the bottom half of the surviving
grid is dropped, so late waves run at K/2, K/4, ... The incumbent (the
recorded config) never halves away: it is the baseline every candidate must
beat and the replay-divergence probe.

The winner, max(rank_key) over the finalists, is validated two ways before
it is recommended:

1. **Bitwise replay agreement**: the winner's sweep-row plans must equal a
   plain single-config replay of the same journal under the winner config.
2. **Exact-reference audit** (quality/audit.py): the winner's admitted count
   against the exact branch-and-bound optimum on the seeded audit
   instances must not fall below the incumbent's.

A recommendation that fails a gate (or whose incumbent row diverges from
the journal) comes back with `"valid": false` and the failing gates named.
Every solve goes through one warm path, on the card unless `device` says
otherwise; the exact optimum is computed on the host.
"""

from __future__ import annotations

import math

from grove_tpu_torch.trace.replay import diff_wave, snapshot_from_wave, solve_wave_record
from grove_tpu_torch.tuning.sweep import SweepEngine, default_grid, incumbent_config

MIN_CONFIGS = 2  # halving never cuts the grid below this many configs


def _wave_count(records: list) -> int:
    return sum(1 for r in records if r.get("kind") == "wave")


def _chunk_records(records: list, rungs: int) -> list[list]:
    """Split a record list into `rungs` contiguous chunks of roughly equal
    wave counts (fleet records ride with the chunk they precede; the engine
    keeps fleets across chunks)."""
    total = _wave_count(records)
    if total == 0:
        raise ValueError("journal contains no wave records — nothing to sweep")
    rungs = max(1, min(rungs, total))
    per = math.ceil(total / rungs)
    chunks: list[list] = [[]]
    waves_in_chunk = 0
    for rec in records:
        if waves_in_chunk >= per and rec.get("kind") == "wave" and len(chunks) < rungs:
            chunks.append([])
            waves_in_chunk = 0
        chunks[-1].append(rec)
        if rec.get("kind") == "wave":
            waves_in_chunk += 1
    return chunks


def successive_halving(
    records: list,
    grid: list,
    *,
    rungs: int = 3,
    warm_path=None,
    device=None,
) -> tuple[SweepEngine, list]:
    """Sweep `records` under `grid`, halving the surviving set between rungs
    (ceil(n / 2) kept, never fewer than MIN_CONFIGS, the incumbent always).
    Returns (engine, schedule): one doc per rung, the configs that entered
    it and their standing when it closed."""
    engine = SweepEngine(grid, warm_path=warm_path, device=device)
    chunks = _chunk_records(records, rungs)
    schedule: list[dict] = []
    for ri, chunk in enumerate(chunks):
        entered = [c.name for c in engine.configs]
        engine.consume(chunk)
        ranked = sorted((engine.tallies[n] for n in entered), key=lambda t: t.rank_key(),
                        reverse=True)
        schedule.append({
            "rung": ri,
            "waves": _wave_count(chunk),
            "configs": entered,
            "ranking": [
                {
                    "name": t.config.name,
                    "admitted": t.admitted,
                    "admittedRatio": round(t.admitted_ratio, 4),
                    "meanPlacementScore": round(t.mean_score, 4),
                }
                for t in ranked
            ],
        })
        if ri < len(chunks) - 1 and len(entered) > MIN_CONFIGS:
            keep_n = max(MIN_CONFIGS, math.ceil(len(entered) / 2))
            survivors = {t.config.name for t in ranked[:keep_n]}
            survivors.add("incumbent")  # the baseline never halves away
            survivors &= set(entered)
            engine.keep(survivors)
    return engine, schedule


def _validate_bitwise(records: list, winner, tally, warm, device=None) -> dict:
    """Gate 1: a plain single-config replay of the journal under the winner
    config reproduces the winner's sweep-row plans bit for bit."""
    fleets: dict[str, dict] = {}
    divergences = 0
    waves = 0
    diverged: list = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "fleet":
            fleets[rec["digest"]] = rec
            continue
        if kind != "wave":
            continue
        snapshot = snapshot_from_wave(rec, fleets[rec["fleet"]])
        plan, ok, scores, _s = solve_wave_record(
            rec, snapshot, warm=warm, params=winner.solver_params(),
            portfolio=winner.portfolio, escalate_portfolio=winner.escalate_portfolio,
            device=device,
        )
        sweep_plan, sweep_ok, sweep_scores = tally.plans[waves]
        pseudo = {"ok": sweep_ok, "plan": sweep_plan, "scores": sweep_scores}
        diffs = diff_wave(pseudo, plan, ok, scores)
        if diffs:
            divergences += len(diffs)
            if len(diverged) < 3:
                diverged.append({"wave": waves, "diffs": diffs})
        waves += 1
    out = {"waves": waves, "divergences": divergences}
    if diverged:
        out["diverged"] = diverged
    return out


def _validate_exact(winner, incumbent, seeds=None, warm=None, device=None) -> dict:
    """Gate 2: the winner's admitted count against the exact optimum must
    not fall below the incumbent's on the seeded audit instances."""
    from grove_tpu_torch.quality.audit import AUDIT_SEEDS, audit_config

    seeds = tuple(seeds) if seeds else AUDIT_SEEDS

    def run(cfg):
        return audit_config(cfg.weights, portfolio=cfg.portfolio,
                            escalate_portfolio=cfg.escalate_portfolio, seeds=seeds,
                            warm_path=warm, device=device)

    w = run(winner)
    inc = run(incumbent) if winner.name != incumbent.name else w
    return {
        "seeds": list(seeds),
        "winner": w.to_doc(),
        "incumbent": inc.to_doc(),
        "admittedPass": w.admitted >= inc.admitted,
    }


def recommend(
    records: list,
    *,
    k: int = 16,
    rungs: int = 3,
    spread: float = 0.5,
    seed: int = 0,
    audit_seeds=None,
    warm_path=None,
    device=None,
) -> dict:
    """The default K-config grid around the recorded config (of `spread`
    and `seed`) -> halving sweep -> validated recommendation: the
    recommended config's JSON document (the gates in the module docstring).
    `audit_seeds` None means AUDIT_SEEDS; `warm_path` None means a fresh
    WarmPath; `device` None means the card."""
    from grove_tpu_torch.solver.warm import WarmPath

    warm = warm_path if warm_path is not None else WarmPath()
    incumbent = incumbent_config(records)
    grid = default_grid(incumbent, k, spread=spread, seed=seed)
    engine, schedule = successive_halving(records, grid, rungs=rungs, warm_path=warm,
                                          device=device)
    finalists = [engine.tallies[c.name] for c in engine.configs]
    winner_tally = max(finalists, key=lambda t: t.rank_key())
    winner = winner_tally.config
    incumbent_tally = engine.tallies["incumbent"]

    bitwise = _validate_bitwise(records, winner, winner_tally, warm, device)
    exact = _validate_exact(winner, incumbent, seeds=audit_seeds, warm=warm, device=device)
    replay_divergences = incumbent_tally.divergences
    valid = bitwise["divergences"] == 0 and exact["admittedPass"] and replay_divergences == 0
    failed = []
    if bitwise["divergences"]:
        failed.append("bitwiseReplay")
    if not exact["admittedPass"]:
        failed.append("exactAudit")
    if replay_divergences:
        failed.append("journalReplay")
    doc = {
        "winner": winner.to_doc(),
        "incumbent": incumbent.to_doc(),
        "valid": valid,
        "grid": len(grid),
        "rungs": schedule,
        "sweep": engine.to_doc(),
        "winnerTally": winner_tally.to_doc(),
        "incumbentTally": incumbent_tally.to_doc(),
        "validation": {
            "bitwiseReplay": bitwise,
            "journalReplayDivergences": replay_divergences,
            "exactAudit": exact,
        },
    }
    if failed:
        doc["failedGates"] = failed
    return doc
