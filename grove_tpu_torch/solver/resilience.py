"""The graceful-degradation ladder: breakers, probation, step-down order
(grove_tpu/solver/resilience.py counterpart, whole).

Every rung below the fast path is a configuration the tests prove admits
the same gangs, so degrading is safe by construction and the ladder can
step down aggressively and step back up on probation:

  resident   device-resident drain   -> scanned        (bitwise-equal)
  scan       scan launches (B4)      -> per-wave       (bitwise-equal)
  mesh       mesh-sharded solve (B7) -> unsharded      (the same verdicts)
  pruning    candidate-pruned solve  -> dense          (admitted-equal)
  pipeline   depth-buffered harvest  -> wave-serial    (identical bindings)
  portfolio  P-variant solve         -> single-variant (escalation off)

Each rung has a circuit breaker: `threshold` failures inside `window`
seconds OPEN it (a step-down, counted and reported through on_event —
never silent); after `probation` seconds the breaker goes HALF-OPEN and the
next wave runs at full config as a trial — success CLOSES it (a step-up),
failure re-opens it and restarts probation. Failures not attributable to a
subsystem charge the first active rung, so repeated failures walk DOWN the
ladder one rung at a time until the drain runs dense, serial and single.

The ladder is control-plane state shared across the drains (the streaming
drain, drain_backlog); an injected clock makes every transition testable
without real sleeps, and makes the port's transitions comparable one for
one with the JAX package's under the same clock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

# Step-down order: fastest/most-optional first. An unattributed failure
# charges the first rung still at full config.
SUBSYSTEMS = ("resident", "scan", "mesh", "pruning", "pipeline", "portfolio")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


@dataclass(frozen=True)
class ResilienceConfig:
    """The `resilience.*` config block (the solver-side value object; the
    bind and backoff fields are read by the serving path)."""

    enabled: bool = False
    # Watchdog on in-flight waves: a dispatched wave whose verdicts are not
    # host-visible within this window is cancelled and re-dispatched from
    # its retained entering carry (the solve is deterministic, so the
    # re-dispatch reproduces the same verdicts).
    watchdog_seconds: float = 30.0
    # Re-dispatch attempts per wave (watchdog or dispatch failure) before
    # the failure escalates to the ladder.
    max_wave_retries: int = 2
    # Circuit breakers: failures within the window that OPEN a subsystem's
    # breaker, and how long it stays open before a half-open trial.
    breaker_threshold: int = 3
    breaker_window_seconds: float = 60.0
    probation_seconds: float = 30.0
    # Bind retry (kube push path): attempts and decorrelated-jitter pacing
    # before the binding goes back to the retry set.
    bind_max_attempts: int = 3
    backoff_base_seconds: float = 0.05
    backoff_cap_seconds: float = 2.0
    # Retire-time stale-plan revalidation: re-check that a gang's target
    # nodes are still alive+schedulable at bind time; a gang whose nodes
    # died in flight is requeued instead of bound into a dead node.
    stale_plan_revalidation: bool = True


@dataclass
class CircuitBreaker:
    """Closed -> open (threshold failures in window) -> half-open (after
    probation) -> closed (trial success) | open (trial failure)."""

    threshold: int = 3
    window_s: float = 60.0
    probation_s: float = 30.0
    state: str = CLOSED
    failures: list = field(default_factory=list)  # stamps inside the window
    opened_at: float = 0.0
    # True while a half-open probe has been dispensed and its verdict is
    # outstanding. Exactly ONE probe runs per half-open episode: further
    # allow() calls stay degraded until record_success/record_failure lands
    # the verdict, and record_success only closes the breaker when a probe
    # was actually dispensed — a success from a wave that never ran the
    # subsystem at full config must not re-close it (that eager close is
    # what makes sustained faults oscillate closed<->open).
    trial_pending: bool = False
    # Monotonic transition counters (the grove_degradation_* metrics and
    # /statusz rows are cut from these).
    step_downs: int = 0
    step_ups: int = 0

    def allow(self, now: float) -> bool:
        """May the subsystem run at full config right now? OPEN past its
        probation window flips to HALF-OPEN and allows ONE trial; while that
        trial's verdict is outstanding every other caller stays degraded."""
        if self.state == OPEN and now - self.opened_at >= self.probation_s:
            self.state = HALF_OPEN
            self.trial_pending = False
        if self.state == HALF_OPEN:
            if self.trial_pending:
                return False  # one probe per episode; verdict outstanding
            self.trial_pending = True
            return True
        return self.state != OPEN

    def record_failure(self, now: float) -> bool:
        """True when this failure OPENED the breaker (a step-down)."""
        if self.state == HALF_OPEN:
            # Failed trial: straight back to open, probation restarts with
            # its FULL window from the failure stamp.
            self.state = OPEN
            self.opened_at = now
            self.failures = []
            self.trial_pending = False
            return False  # the step-down was already counted when it opened
        self.failures = [t for t in self.failures if now - t < self.window_s]
        self.failures.append(now)
        if self.state == CLOSED and len(self.failures) >= self.threshold:
            self.state = OPEN
            self.opened_at = now
            self.failures = []
            self.step_downs += 1
            return True
        return False

    def record_success(self, now: float) -> bool:
        """True when a half-open trial CLOSED the breaker (a step-up). A
        success with no dispensed probe leaves the breaker half-open: the
        wave that succeeded ran at the degraded config and proves nothing
        about this subsystem."""
        if self.state == HALF_OPEN and self.trial_pending:
            self.state = CLOSED
            self.failures = []
            self.trial_pending = False
            self.step_ups += 1
            return True
        return False


class DegradationLadder:
    """Per-subsystem breakers + the ordered step-down policy.

    `on_event(event, subsystem)` fires on every transition with event in
    {"step_down", "step_up", "trial"} — the manager wires it to the flight
    recorder and the log so no degradation is ever silent."""

    def __init__(
        self,
        config: ResilienceConfig | None = None,
        *,
        clock=time.monotonic,
        on_event=None,
    ) -> None:
        self.config = config or ResilienceConfig(enabled=True)
        self.clock = clock
        self.on_event = on_event
        self._lock = threading.Lock()
        c = self.config
        self.breakers: dict[str, CircuitBreaker] = {
            s: CircuitBreaker(
                threshold=c.breaker_threshold,
                window_s=c.breaker_window_seconds,
                probation_s=c.probation_seconds,
            )
            for s in SUBSYSTEMS
        }
        # Wave-level ledger (surfaced beside the breaker states).
        self.wave_failures = 0
        self.wave_successes = 0

    def _emit(self, event: str, subsystem: str) -> None:
        if self.on_event is not None:
            try:
                self.on_event(event, subsystem)
            except Exception:  # noqa: BLE001 — observability must not break recovery
                pass

    def allows(self, subsystem: str, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        with self._lock:
            br = self.breakers[subsystem]
            was_open = br.state == OPEN
            ok = br.allow(now)
            if ok and was_open and br.state == HALF_OPEN:
                self._emit("trial", subsystem)
            return ok

    def record_failure(
        self,
        subsystem: str | None = None,
        *,
        active: tuple = SUBSYSTEMS,
        now: float | None = None,
    ) -> str | None:
        """Charge a failure. `subsystem=None` (unattributable) charges the
        first breaker in ladder order that is in `active` and not already
        open — successive unattributed failures walk down the ladder.
        Returns the charged subsystem (None when everything is already at
        the bottom)."""
        now = self.clock() if now is None else now
        with self._lock:
            self.wave_failures += 1
            target = subsystem
            if target is None:
                for s in SUBSYSTEMS:
                    if s in active and self.breakers[s].state != OPEN:
                        target = s
                        break
            if target is None:
                return None
            stepped = self.breakers[target].record_failure(now)
        if stepped:
            self._emit("step_down", target)
        return target

    def record_success(self, now: float | None = None) -> list[str]:
        """A wave/pass completed at the CURRENT effective config: every
        half-open subsystem's trial succeeded — close them (step-up).
        Returns the subsystems stepped back up."""
        now = self.clock() if now is None else now
        closed = []
        with self._lock:
            self.wave_successes += 1
            for s, br in self.breakers.items():
                if br.record_success(now):
                    closed.append(s)
        for s in closed:
            self._emit("step_up", s)
        return closed

    def fully_closed(self) -> bool:
        with self._lock:
            return all(br.state == CLOSED for br in self.breakers.values())

    def counters(self) -> dict:
        """{subsystem: {"stepDowns": n, "stepUps": n}} snapshot (metrics)."""
        with self._lock:
            return {
                s: {"stepDowns": br.step_downs, "stepUps": br.step_ups}
                for s, br in self.breakers.items()
            }

    def stats(self) -> dict:
        """JSON-able ladder state for /statusz resilience.ladder."""
        with self._lock:
            return {
                "waveFailures": self.wave_failures,
                "waveSuccesses": self.wave_successes,
                "subsystems": {
                    s: {
                        "state": br.state,
                        "stepDowns": br.step_downs,
                        "stepUps": br.step_ups,
                        "recentFailures": len(br.failures),
                    }
                    for s, br in self.breakers.items()
                },
            }


def ladder_for(resilience) -> DegradationLadder | None:
    """Normalize a caller-supplied `resilience` argument: an existing
    ladder passes through (shared control-plane state), a ResilienceConfig
    builds a private one when enabled, None/disabled yields None."""
    if resilience is None:
        return None
    if isinstance(resilience, DegradationLadder):
        return resilience
    if isinstance(resilience, ResilienceConfig):
        return DegradationLadder(resilience) if resilience.enabled else None
    raise TypeError(
        f"resilience must be a DegradationLadder or ResilienceConfig, got "
        f"{type(resilience).__name__}"
    )
