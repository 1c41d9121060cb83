"""The grove-initc agent's wait logic (grove_tpu/initc/agent.py
counterpart, cut to the in-process path): parse the injected init
container's `--podcliques` argument and test it against the store. The
simulator's default startup gate ("agent") runs pods through it. The HTTP
fetchers and the blocking wait loop of the binary are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable


@dataclass(frozen=True)
class Requirement:
    """One parent gate: clique FQN must have >= min_available Ready pods."""

    fqn: str
    min_available: int


def parse_podcliques_arg(value: str) -> list[Requirement]:
    """`a-0-prefill:2,a-0-router:1` -> [Requirement(...), ...] (options.go)."""
    reqs: list[Requirement] = []
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"--podcliques entry {part!r}: want <fqn>:<minAvailable>")
        fqn, _, min_s = part.rpartition(":")
        try:
            min_avail = int(min_s)
        except ValueError:
            raise ValueError(f"--podcliques entry {part!r}: minAvailable not an int")
        if not fqn or min_avail < 0:
            raise ValueError(f"--podcliques entry {part!r}: invalid")
        reqs.append(Requirement(fqn=fqn, min_available=min_avail))
    return reqs


# fetch: fqn -> (ready_count, exists). Missing cliques gate (wait.go treats a
# not-yet-created parent as not ready).
FetchFn = Callable[[str], tuple[int, bool]]


def requirements_met(fetch: FetchFn, reqs: Iterable[Requirement]) -> bool:
    for req in reqs:
        ready, exists = fetch(req.fqn)
        if not exists or ready < req.min_available:
            return False
    return True


def store_fetch(cluster) -> FetchFn:
    """In-process fetch over the store — the simulator's agent path uses the
    same wait/requirements code as the binary."""

    def fetch(fqn: str) -> tuple[int, bool]:
        clique = cluster.podcliques.get(fqn)
        if clique is None:
            return 0, False
        ready = sum(1 for p in cluster.pods_of_clique(fqn) if p.ready and p.is_active)
        return ready, True

    return fetch
