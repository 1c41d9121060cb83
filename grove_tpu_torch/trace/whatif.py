"""What-if counterfactuals: replay a journal against a modified world
(grove_tpu/trace/whatif.py counterpart).

Every recorded solve wave is re-solved against an edited fleet (e.g. +1
rack) or an overridden solver config (score weights, portfolio width), and
both the recorded and the counterfactual plans are scored with the
placement-quality report (quality/report.py): admitted ratio, mean
placement score, plus the wave's solve seconds. Each wave replays against
its own recorded pre-solve state; admissions the counterfactual adds do not
cascade into later waves.

Config-override what-ifs (no fleet edit) are one pass of the batched sweep
(tuning/sweep.py): the variants and the incumbent stack on the variant axis
(B5 and B6 launches on the card), and the incumbent row, diffed against the
journal, gives `replayDivergences`. Fleet edits re-solve each wave with
`solve_wave_record` on the edited snapshot and report `replayDivergences:
null` (not measured). A fleet edit cannot combine with variants.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.quality.report import evaluate_placement
from grove_tpu_torch.solver.core import SolverParams
from grove_tpu_torch.solver.encode import next_pow2
from grove_tpu_torch.state.cluster import Node
from grove_tpu_torch.trace.replay import (
    nodes_from_fleet,
    snapshot_from_wave,
    solve_wave_record,
    topology_from_fleet,
)
from grove_tpu_torch.utils import serde


def clone_racks(
    nodes: list[Node], topology, count: int = 1, *, tag: str = "whatif"
) -> list[Node]:
    """`nodes` + `count` cloned racks. The template is the rack of the LAST
    node (narrowest non-host level of `topology`); clones keep its
    capacity/labels/taints shape with a fresh rack label value and fresh
    hostnames, so the counterfactual asks "one more rack of the same SKU",
    not an arbitrary fleet. Works on any live Node list — the journal
    what-if path and the rollout surge pricer share this one definition of
    "+N racks"."""
    if count <= 0:
        return list(nodes)
    non_host = [
        lvl for lvl in topology.sorted_levels() if lvl.domain.value != "host"
    ]
    if not non_host or not nodes:
        raise ValueError("fleet has no non-host topology level to clone a rack in")
    rack_key = non_host[-1].node_label_key
    template_rack = nodes[-1].labels.get(rack_key)
    template = [n for n in nodes if n.labels.get(rack_key) == template_rack]
    if not template:
        template = [nodes[-1]]
    out = list(nodes)
    for i in range(count):
        for j, src in enumerate(template):
            labels = dict(src.labels)
            labels[rack_key] = f"{tag}-r{i}"
            out.append(
                Node(
                    name=f"{tag}{i}h{j}",
                    capacity=dict(src.capacity),
                    labels=labels,
                    schedulable=True,
                    taints=[dict(t) for t in src.taints],
                )
            )
    return out


def add_racks(fleet: dict, count: int = 1) -> list[Node]:
    """Recorded fleet + `count` cloned racks (see clone_racks)."""
    return clone_racks(nodes_from_fleet(fleet), topology_from_fleet(fleet), count)


@dataclass
class WhatIfWave:
    index: int
    recorded: dict  # quality-report doc of the recorded plan
    counterfactual: dict  # quality-report doc of the counterfactual plan
    recorded_solve_s: float
    counterfactual_solve_s: float

    def to_doc(self) -> dict:
        return {
            "index": self.index,
            "recorded": self.recorded,
            "counterfactual": self.counterfactual,
            "recordedSolveSeconds": round(self.recorded_solve_s, 4),
            "counterfactualSolveSeconds": round(self.counterfactual_solve_s, 4),
        }


@dataclass
class WhatIfReport:
    """Aggregate recorded-vs-counterfactual quality over the journal."""

    waves: list = field(default_factory=list)  # WhatIfWave
    edits: dict = field(default_factory=dict)  # what was changed

    def _agg(self, which: str) -> dict:
        gangs = sum(getattr(w, which)["gangs"] for w in self.waves)
        admitted = sum(getattr(w, which)["admitted"] for w in self.waves)
        scored = [
            getattr(w, which)["meanPlacementScore"]
            for w in self.waves
            if getattr(w, which)["admitted"]
        ]
        return {
            "gangs": gangs,
            "admitted": admitted,
            "admittedRatio": round(admitted / gangs, 4) if gangs else 0.0,
            "meanPlacementScore": round(float(np.mean(scored)), 4) if scored else 0.0,
        }

    def to_doc(self) -> dict:
        rec = self._agg("recorded")
        cf = self._agg("counterfactual")
        return {
            "edits": self.edits,
            "waves": len(self.waves),
            "recorded": rec,
            "counterfactual": cf,
            "delta": {
                "admitted": cf["admitted"] - rec["admitted"],
                "admittedRatio": round(
                    cf["admittedRatio"] - rec["admittedRatio"], 4
                ),
                "meanPlacementScore": round(
                    cf["meanPlacementScore"] - rec["meanPlacementScore"], 4
                ),
            },
            # Fleet-edit path: divergence is NOT measurable without an extra
            # replay (the counterfactual legitimately differs). The
            # config-override path (WhatIfConfigsReport) measures it free.
            "replayDivergences": None,
            "recordedSolveSeconds": round(
                sum(w.recorded_solve_s for w in self.waves), 4
            ),
            "counterfactualSolveSeconds": round(
                sum(w.counterfactual_solve_s for w in self.waves), 4
            ),
        }


@dataclass
class WhatIfConfigsReport:
    """Config-override what-if via the batched sweep: every variant scored
    from ONE replay pass, deltas against the incumbent (recorded-config)
    row, plus the incumbent row's journal divergence count."""

    waves: int
    incumbent: dict  # incumbent row's tally doc (tuning ConfigTally.to_doc)
    variants: list  # per-variant tally docs, sweep rank order
    replay_divergences: int
    solve_s: float

    def to_doc(self) -> dict:
        rec = self.incumbent

        def delta(v):
            return {
                "admitted": v["admitted"] - rec["admitted"],
                "admittedRatio": round(
                    v["admittedRatio"] - rec["admittedRatio"], 4
                ),
                "meanPlacementScore": round(
                    v["meanPlacementScore"] - rec["meanPlacementScore"], 4
                ),
            }

        return {
            "edits": {"variants": [v["config"] for v in self.variants]},
            "waves": self.waves,
            "recorded": {
                k: rec[k]
                for k in (
                    "gangs", "admitted", "admittedRatio", "meanPlacementScore",
                )
            },
            "variants": [dict(v, delta=delta(v)) for v in self.variants],
            "replayDivergences": self.replay_divergences,
            "solveSeconds": round(self.solve_s, 4),
        }


_WEIGHT_KEYS = {
    "wTight": "w_tight",
    "wPref": "w_pref",
    "wReuse": "w_reuse",
    "wReserve": "w_reserve",
    "wSpread": "w_spread",
}


def _variant_config(incumbent, spec: dict, index: int):
    """One override spec ({"weights": {...}, "portfolio": N,
    "escalatePortfolio": N, "name": s}) -> SweepConfig based on the
    incumbent; unknown keys are errors (the config-validation stance)."""
    from grove_tpu_torch.tuning.sweep import SweepConfig

    allowed = {"weights", "portfolio", "escalatePortfolio", "name"}
    unknown = set(spec) - allowed
    if unknown:
        raise ValueError(f"variant {index}: unknown keys {sorted(unknown)}")
    weights = {
        f: float(w) for f, w in zip(SolverParams._fields, incumbent.weights)
    }
    for key, val in (spec.get("weights") or {}).items():
        snake = _WEIGHT_KEYS.get(key, key)
        if snake not in weights:
            raise ValueError(f"variant {index}: unknown weight {key!r}")
        weights[snake] = float(val)
    return SweepConfig(
        name=str(spec.get("name") or f"variant-{index}"),
        weights=tuple(weights[f] for f in SolverParams._fields),
        portfolio=int(spec.get("portfolio") or incumbent.portfolio),
        escalate_portfolio=int(
            spec.get("escalatePortfolio") or incumbent.escalate_portfolio
        ),
    )


def whatif_configs(
    records: list, variants: list, *, warm_path=None, device=None
) -> WhatIfConfigsReport:
    """Score N config-override variants against the recorded trace in ONE
    sweep pass (incumbent + variants stacked on the solver's variant axis).
    The incumbent row doubles as the replay-divergence probe."""
    from grove_tpu_torch.tuning.sweep import incumbent_config, sweep_journal

    if not variants:
        raise ValueError("whatif_configs needs at least one variant")
    incumbent = incumbent_config(records)
    configs = [incumbent] + [
        _variant_config(incumbent, spec, i) for i, spec in enumerate(variants)
    ]
    names = [c.name for c in configs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate variant names: {names}")
    engine = sweep_journal(records, configs, warm_path=warm_path, device=device)
    inc_tally = engine.tallies["incumbent"]
    variant_docs = [
        engine.tallies[c.name].to_doc() for c in configs[1:]
    ]
    return WhatIfConfigsReport(
        waves=engine.waves_seen,
        incumbent=inc_tally.to_doc(),
        variants=variant_docs,
        replay_divergences=inc_tally.divergences,
        solve_s=sum(t.solve_s for t in engine.tallies.values()),
    )


def whatif_journal(
    records: list[dict],
    *,
    add_rack_count: int = 0,
    params: SolverParams | None = None,
    portfolio: int | None = None,
    escalate_portfolio: int | None = None,
    variants: list | None = None,
    warm_path=None,
    device=None,
):
    """Score every recorded wave against the counterfactual world. At least
    one edit (fleet or solver config) should be given — with none this
    degenerates to a scored replay.

    Config-only edits (no fleet change) return a WhatIfConfigsReport from
    ONE batched sweep pass — `variants` carries N override specs at ~1x
    replay cost, and the single params/portfolio/escalate overrides are
    folded into one variant the same way. Fleet edits (add_rack_count > 0)
    keep the per-wave re-solve path and may combine with a config override
    (the counterfactual then changes both). `device` None means the card."""
    from grove_tpu_torch.solver.warm import WarmPath

    if variants is not None and add_rack_count:
        raise ValueError(
            "config-override variants cannot combine with fleet edits — "
            "the sweep shares the RECORDED encode across variants"
        )
    if add_rack_count == 0:
        specs = list(variants or [])
        if not specs and (
            params is not None
            or portfolio is not None
            or escalate_portfolio is not None
        ):
            spec: dict = {}
            if params is not None:
                spec["weights"] = {
                    f: float(w)
                    for f, w in zip(SolverParams._fields, params)
                }
            if portfolio is not None:
                spec["portfolio"] = int(portfolio)
            if escalate_portfolio is not None:
                spec["escalatePortfolio"] = int(escalate_portfolio)
            specs = [spec]
        if specs:
            return whatif_configs(records, specs, warm_path=warm_path, device=device)

    warm = warm_path if warm_path is not None else WarmPath()
    fleets: dict[str, dict] = {}
    cf_nodes_cache: dict[str, list[Node]] = {}
    report = WhatIfReport(
        edits={
            "addRacks": add_rack_count,
            "portfolio": portfolio,
            "escalatePortfolio": escalate_portfolio,
            "weights": None if params is None else [float(w) for w in params],
        }
    )
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
                f"wave {index} references fleet {rec['fleet']!r} missing from "
                "this journal — cannot evaluate"
            )
        gangs = [serde.decode(d) for d in rec["gangs"]]
        pods = {n: serde.decode(d) for n, d in rec["pods"].items()}

        # Recorded side: the plan as journaled, scored on the recorded fleet.
        rec_snap = snapshot_from_wave(rec, fleet)
        rec_report = evaluate_placement(gangs, pods, rec_snap, rec["plan"])

        # Counterfactual side: edited fleet (node pad grows with the fleet)
        # and/or overridden solver config, re-solved then scored.
        if rec["fleet"] not in cf_nodes_cache:
            cf_nodes_cache[rec["fleet"]] = add_racks(fleet, add_rack_count)
        cf_nodes = cf_nodes_cache[rec["fleet"]]
        cf_wave = dict(rec)
        cf_wave["padNodesTo"] = max(rec["padNodesTo"], next_pow2(len(cf_nodes)))
        cf_snap = snapshot_from_wave(cf_wave, fleet, nodes=cf_nodes)
        cf_plan, _cf_ok, _cf_scores, cf_s = solve_wave_record(
            cf_wave,
            cf_snap,
            warm=warm,
            params=params,
            portfolio=portfolio,
            escalate_portfolio=escalate_portfolio,
            device=device,
        )
        cf_report = evaluate_placement(gangs, pods, cf_snap, cf_plan)
        report.waves.append(
            WhatIfWave(
                index=index,
                recorded=rec_report.to_doc(),
                counterfactual=cf_report.to_doc(),
                recorded_solve_s=float(rec.get("solveSeconds", 0.0)),
                counterfactual_solve_s=cf_s,
            )
        )
        index += 1
    return report
