"""Seeded exact-reference audit instances (grove_tpu/quality/audit.py
counterpart): the instances the tuning search's recommendation is audited
on before it is recommended. A tuned weight vector that trades admitted
gangs for placement score loses to the incumbent here and is rejected.

Instances are sized under the exact packer's caps (quality/exact.py) and
contended enough that admission and locality both carry signal; each seed
builds the JAX package's instance gang for gang.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from grove_tpu_torch.api import PodCliqueSet, default_podcliqueset
from grove_tpu_torch.quality.exact import exact_pack
from grove_tpu_torch.quality.report import evaluate_placement
from grove_tpu_torch.state import Node, build_snapshot

AUDIT_SEEDS = (11, 23, 37, 41, 59, 73)


def audit_nodes(racks: int, hosts_per_rack: int, cpu: float) -> list[Node]:
    return [
        Node(
            name=f"r{r}h{h}",
            capacity={"cpu": cpu, "memory": 64.0 * 2**30},
            labels={
                "topology.kubernetes.io/zone": "z0",
                "topology.kubernetes.io/block": "b0",
                "topology.kubernetes.io/rack": f"r{r}",
            },
        )
        for r in range(racks)
        for h in range(hosts_per_rack)
    ]


def audit_gang_pcs(name: str, pods: int, cpu: int, constraint: str | None) -> PodCliqueSet:
    template: dict = {
        "startupType": "CliqueStartupTypeAnyOrder",
        "cliques": [
            {
                "name": "w",
                "spec": {
                    "roleName": "w",
                    "replicas": pods,
                    "minAvailable": pods,
                    "podSpec": {
                        "containers": [
                            {
                                "name": "w",
                                "image": "registry.local/w:latest",
                                "resources": {"requests": {"cpu": str(cpu)}},
                            }
                        ]
                    },
                },
            }
        ],
    }
    if constraint == "required":
        template["topologyConstraint"] = {"packDomain": "rack"}
    elif constraint == "preferred":
        template["topologyConstraint"] = {"preferredDomain": "rack"}
    doc = {
        "apiVersion": "grove.io/v1alpha1",
        "kind": "PodCliqueSet",
        "metadata": {"name": name},
        "spec": {"replicas": 1, "template": template},
    }
    return default_podcliqueset(PodCliqueSet.from_dict(doc))


def audit_instance(seed: int):
    """One randomized small instance: (gangs, pods_by_name, snapshot):
    2-3 racks x 2-3 hosts, 4-5 gangs (the JAX package's tier-1 shape)."""
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim.workloads import bench_topology

    rng = random.Random(seed)
    racks = rng.choice((2, 3))
    hosts = rng.choice((2, 3))
    cpu = 4.0
    nodes = audit_nodes(racks, hosts, cpu)
    topo = bench_topology()
    n_gangs = rng.choice((4, 5))
    gangs, pods = [], {}
    for i in range(n_gangs):
        pcs = audit_gang_pcs(
            f"s{seed}-g{i}",
            pods=rng.choice((1, 2, 2)),
            cpu=rng.choice((2, 3, 4)),
            constraint=rng.choice((None, "required", "preferred", "preferred")),
        )
        ds = expand_podcliqueset(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    return gangs, pods, build_snapshot(nodes, topo)


@dataclass
class AuditResult:
    """One config's aggregate standing against the exact optimum."""

    admitted: int
    exact_admitted: int
    locality: float  # mean placement score, admission-matched instances
    exact_locality: float
    instances: int

    @property
    def admitted_ratio(self) -> float:
        return self.admitted / self.exact_admitted if self.exact_admitted else 0.0

    @property
    def locality_ratio(self) -> float:
        return self.locality / self.exact_locality if self.exact_locality else 1.0

    def to_doc(self) -> dict:
        return {
            "instances": self.instances,
            "admitted": self.admitted,
            "exactAdmitted": self.exact_admitted,
            "admittedRatio": round(self.admitted_ratio, 4),
            "locality": round(self.locality, 4),
            "exactLocality": round(self.exact_locality, 4),
            "localityRatio": round(self.locality_ratio, 4),
        }


def audit_config(
    weights,
    *,
    portfolio: int = 1,
    escalate_portfolio: int = 1,
    seeds=AUDIT_SEEDS,
    warm_path=None,
    device=None,
) -> AuditResult:
    """Solve the seeded audit set under `weights` with the port's `solve()`
    (on the card unless `device` says otherwise, through `warm_path`, None
    = the process-shared WarmPath) and aggregate its admitted count and
    locality against the exact optimum (exact_pack, on the host).

    Locality aggregates only the instances where the config matches the
    exact admitted count, so admission differences do not confound it."""
    from grove_tpu_torch.solver.core import SolverParams, decode_bindings, solve
    from grove_tpu_torch.solver.encode import encode_gangs

    params = SolverParams(*(float(w) for w in weights))
    admitted = exact_admitted = 0
    loc: list[float] = []
    loc_exact: list[float] = []
    n_instances = 0
    for seed in seeds:
        gangs, pods, snap = audit_instance(seed)
        exact = exact_pack(gangs, pods, snap)
        # Fixed bucket dims across instances (the JAX package's): one launch
        # shape per gang pad (8 for the 4-5 gangs of an instance).
        batch, decode = encode_gangs(
            gangs, pods, snap, max_groups=1, max_sets=1, max_pods=2,
            pad_gangs_to=max(8, 1 << (max(len(gangs) - 1, 1)).bit_length()),
        )
        result = solve(snap, batch, params, portfolio=portfolio,
                       escalate_portfolio=escalate_portfolio, device=device, warm=warm_path)
        bindings = decode_bindings(result.ok.cpu().numpy(), result.assigned.cpu().numpy(),
                                   decode, snap)
        rep = evaluate_placement(gangs, pods, snap, bindings)
        admitted += rep.admitted
        exact_admitted += exact.admitted_count
        n_instances += 1
        if rep.admitted == exact.admitted_count and exact.admitted_count:
            loc.append(rep.mean_placement_score)
            loc_exact.append(exact.mean_score)
    return AuditResult(
        admitted=admitted,
        exact_admitted=exact_admitted,
        locality=float(np.mean(loc)) if loc else 0.0,
        exact_locality=float(np.mean(loc_exact)) if loc_exact else 0.0,
        instances=n_instances,
    )
