"""Deterministic fault injection: named sites, seeded dice, journaled fires
(grove_tpu/faults/__init__.py counterpart, whole).

Code threads named *sites* through the stack —

  solver.dispatch    a wave's launch raises (solver/drain._WavePipeline)
  solver.harvest     a dispatched wave hangs; the watchdog must recover
  bind.commit        the gang-bind commit fails mid-gang (controller)
  kube.request       the apiserver wire call returns 409/5xx (kubernetes.py)
  watch.disconnect   the watch stream drops (kubernetes.py reader loop)
  recorder.write     the journal segment write hits ENOSPC (trace/recorder)
  sim.node_death     schedulable chaos-script node kill (simulator)
  sim.node_revocation  a revocable node gets a revocation notice
  cell.crash         a reconcile cell dies mid-stream
  cell.partition     the coordinator cannot reach a cell

— and an injector decides, per evaluation, whether the fault fires. The
decision is a pure function of (site seed, evaluation index): two runs with
the same spec see the SAME fault schedule regardless of thread interleaving
across sites, and the same schedule as the JAX package's injector given the
same specs and seed. The port's modules evaluate every site above.

Gating: code calls `active()`, which returns a disabled no-op singleton
unless an injector was installed (`install`, or `from_config` with the
`GROVE_FAULTS` env override) — the hot path pays one attribute check. The
process-installed injector here is the port's own, separate from the JAX
package's. Every fire is counted per site and journaled to the flight
recorder (when one is attached) as an `action` record `fault.injected`, so
an incident trace shows the injected fault next to the recovery it
provoked.

GROVE_FAULTS syntax (env override, wins over config):

  GROVE_FAULTS="seed=7;solver.dispatch=error:0.5:3;recorder.write=enospc:1:2"

i.e. `;`-separated `site=kind:rate[:count[:after]]` entries plus an
optional `seed=N`. kind in error|timeout|http409|http500|http503|enospc|
disconnect; rate is the per-evaluation fire probability; count caps total
fires (0 = unlimited); after skips the first N evaluations.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass

# Site kinds and the exception they surface as (see maybe_raise).
KINDS = ("error", "timeout", "http409", "http500", "http503", "enospc", "disconnect")

# The named sites (the JAX package's table; docs/design.md).
SITES = (
    "solver.dispatch",
    "solver.harvest",
    "bind.commit",
    "kube.request",
    "watch.disconnect",
    "recorder.write",
    "sim.node_death",
    "sim.node_revocation",
    "cell.crash",
    "cell.partition",
)


class InjectedFault(RuntimeError):
    """An injected failure surfacing as a generic runtime error."""

    def __init__(self, site: str, kind: str = "error"):
        super().__init__(f"injected fault at {site} ({kind})")
        self.site = site
        self.kind = kind


@dataclass(frozen=True)
class SiteSpec:
    """One site's fault schedule (all fields validated by parse helpers)."""

    kind: str = "error"
    rate: float = 1.0  # per-evaluation fire probability
    count: int = 0  # max total fires; 0 = unlimited
    after: int = 0  # skip the first N evaluations (fault arrives "later")


class FaultInjector:
    """Seeded per-site dice + fire counters + journal hook.

    Thread-safe: sites are evaluated from the reconcile thread, the trace
    writer thread, and kube reader threads; each site's RNG stream is
    independent (seeded site-wise), so cross-site interleaving cannot
    change any site's schedule."""

    def __init__(
        self,
        specs: dict[str, SiteSpec] | None = None,
        *,
        seed: int = 0,
        recorder=None,  # trace.recorder.TraceRecorder (capture_action)
        clock=time.time,
    ) -> None:
        self.specs = dict(specs or {})
        self.seed = int(seed)
        self.recorder = recorder
        self.clock = clock
        self._lock = threading.Lock()
        self._rng: dict[str, random.Random] = {}
        self.evaluated: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.specs)

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rng.get(site)
        if rng is None:
            # Site-wise derivation keeps each site's schedule independent of
            # every other site's evaluation count (deterministic under any
            # thread interleaving).
            rng = self._rng[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def should_fire(self, site: str, **ctx) -> SiteSpec | None:
        """Evaluate one site; the spec when the fault fires, else None.
        A fire is counted AND journaled (action record `fault.injected`)."""
        spec = self.specs.get(site)
        if spec is None:
            return None
        with self._lock:
            n = self.evaluated.get(site, 0)
            self.evaluated[site] = n + 1
            if n < spec.after:
                return None
            if spec.count and self.fired.get(site, 0) >= spec.count:
                return None
            if spec.rate < 1.0 and self._site_rng(site).random() >= spec.rate:
                return None
            self.fired[site] = self.fired.get(site, 0) + 1
        if self.recorder is not None:
            try:
                self.recorder.capture_action(
                    self.clock(), "fault.injected", site, faultKind=spec.kind, **ctx
                )
            except Exception:  # noqa: BLE001 — injection must not need tracing
                pass
        return spec

    def maybe_raise(self, site: str, **ctx) -> None:
        """Raise the site's failure when its schedule fires (no-op spec-less).
        http* kinds raise whatever `exc_factory(status)` builds when the
        caller passes one in ctx (the kube client maps them to KubeApiError);
        everything else raises InjectedFault/OSError as appropriate."""
        exc_factory = ctx.pop("exc_factory", None)
        spec = self.should_fire(site, **ctx)
        if spec is None:
            return
        if spec.kind.startswith("http") and exc_factory is not None:
            raise exc_factory(int(spec.kind[4:]))
        if spec.kind == "enospc":
            raise OSError(28, f"injected ENOSPC at {site}")  # errno.ENOSPC
        if spec.kind == "disconnect":
            raise OSError(f"injected disconnect at {site}")
        raise InjectedFault(site, spec.kind)

    def maybe_timeout(self, site: str, **ctx) -> bool:
        """True when the site's schedule fires a simulated hang/timeout —
        the caller's watchdog path takes over (nothing is raised here)."""
        spec = self.should_fire(site, **ctx)
        return spec is not None and spec.kind in ("timeout", "error")

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    def stats(self) -> dict:
        """JSON-able injector state (sites with their schedules and counts)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "seed": self.seed,
                "sites": {
                    site: {
                        "kind": spec.kind,
                        "rate": spec.rate,
                        "count": spec.count,
                        "after": spec.after,
                        "evaluated": self.evaluated.get(site, 0),
                        "fired": self.fired.get(site, 0),
                    }
                    for site, spec in sorted(self.specs.items())
                },
            }


# Disabled singleton: the default `active()` result. Its specs dict is empty,
# so every evaluation is one dict miss — the hot-path cost of having fault
# sites compiled in at all.
_DISABLED = FaultInjector()
_active: FaultInjector = _DISABLED


def active() -> FaultInjector:
    """The process-wide injector (disabled no-op unless one was installed)."""
    return _active


def install(injector: FaultInjector | None) -> FaultInjector:
    """Install (or clear, with None) the process-wide injector; returns the
    now-active one. Tests install scoped injectors and clear them in
    teardown."""
    global _active
    _active = injector if injector is not None else _DISABLED
    return _active


def parse_spec_entry(site: str, doc) -> SiteSpec:
    """One config-block site entry ({kind, rate, count, after}) -> SiteSpec.
    Raises ValueError naming the field — config validation surfaces it."""
    if not isinstance(doc, dict):
        raise ValueError(f"{site}: must be a mapping")
    kind = doc.get("kind", "error")
    if kind not in KINDS:
        raise ValueError(f"{site}.kind: {kind!r} not in {'|'.join(KINDS)}")
    rate = doc.get("rate", 1.0)
    if not isinstance(rate, (int, float)) or isinstance(rate, bool) or not 0.0 <= float(rate) <= 1.0:
        raise ValueError(f"{site}.rate: must be a number in [0, 1]")
    count = doc.get("count", 0)
    after = doc.get("after", 0)
    for fname, v in (("count", count), ("after", after)):
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"{site}.{fname}: must be an int >= 0")
    unknown = set(doc) - {"kind", "rate", "count", "after"}
    if unknown:
        raise ValueError(f"{site}: unknown field(s) {sorted(unknown)}")
    return SiteSpec(kind=kind, rate=float(rate), count=int(count), after=int(after))


def parse_env(value: str) -> tuple[dict[str, SiteSpec], int]:
    """GROVE_FAULTS string -> (specs, seed). See the module docstring for
    the syntax; raises ValueError on malformed entries (a typo'd chaos
    schedule silently not firing is the worst failure mode of a chaos rig)."""
    specs: dict[str, SiteSpec] = {}
    seed = 0
    for entry in value.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"GROVE_FAULTS: {entry!r} is not site=kind:rate[:count[:after]]")
        site, _, rhs = entry.partition("=")
        site = site.strip()
        if site == "seed":
            seed = int(rhs)
            continue
        parts = rhs.split(":")
        kind = parts[0] or "error"
        if kind not in KINDS:
            raise ValueError(f"GROVE_FAULTS: {site}: kind {kind!r} not in {'|'.join(KINDS)}")
        rate = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
        count = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        after = int(parts[3]) if len(parts) > 3 and parts[3] else 0
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"GROVE_FAULTS: {site}: rate must be in [0, 1]")
        if count < 0 or after < 0:
            raise ValueError(f"GROVE_FAULTS: {site}: count/after must be >= 0")
        specs[site] = SiteSpec(kind=kind, rate=rate, count=count, after=after)
    return specs, seed


def from_config(cfg, *, recorder=None, env: str | None = None) -> FaultInjector | None:
    """Build the process injector from a faults config — any object with
    `enabled`, `sites` ({site: {kind, rate, count, after}}) and `seed`
    attributes — honoring the GROVE_FAULTS env override (env wins outright:
    an operator attaching a chaos schedule must not have to edit YAML).
    Returns None when injection is off both ways."""
    env = os.environ.get("GROVE_FAULTS", "") if env is None else env
    if env:
        specs, seed = parse_env(env)
        if specs:
            return FaultInjector(specs, seed=seed, recorder=recorder)
        return None
    if cfg is None or not getattr(cfg, "enabled", False):
        return None
    specs = {
        site: parse_spec_entry(site, doc) for site, doc in (cfg.sites or {}).items()
    }
    if not specs:
        return None
    return FaultInjector(specs, seed=int(cfg.seed), recorder=recorder)
