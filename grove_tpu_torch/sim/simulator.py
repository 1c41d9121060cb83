"""Event-driven cluster simulator — the KWOK/k3d analog (SURVEY.md §4).

Plays the kubelet/runtime role against the in-memory store: bound pods start
after a configurable delay, become Ready after another, honoring the startup
ordering gate (the grove-initc analog, orchestrator/startup.py). Fault
injection mirrors the e2e suite's techniques: fail pods, cordon nodes, kill
nodes (e2e/setup/k8s_clusters.go:130-244 restarts node containers;
gang_scheduling_test.go manipulates capacity by cordoning).

The port's copy of grove_tpu/sim/simulator.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from grove_tpu_torch.api.pod import PodPhase
from grove_tpu_torch.orchestrator.controller import GroveController
from grove_tpu_torch.orchestrator.startup import may_start
from grove_tpu_torch.orchestrator.store import Cluster


@dataclass
class SimConfig:
    start_delay: float = 2.0  # bound -> containers running (image pull etc.)
    ready_delay: float = 3.0  # running -> Ready probes pass
    # Startup gate evaluation: "agent" drives the grove-initc code path (the
    # injected init container's own --podcliques args through
    # initc/agent.requirements_met, exactly what the binary runs); "predicate"
    # keeps the legacy pure-predicate gate (orchestrator/startup.may_start).
    startup_gate: str = "agent"


@dataclass(frozen=True)
class ScriptedFault:
    """One schedulable chaos action: at sim-time `at`, apply `action` to
    `target`. Actions are the simulator's own fault methods (kill_node,
    cordon, uncordon, fail_pod, crash_pod, revoke_node), so a script entry journals and
    behaves exactly like a hand-driven fault — but the schedule is DATA,
    shippable with a chaos scenario and replayable run after run."""

    at: float
    action: str
    target: str


@dataclass
class Simulator:
    cluster: Cluster
    controller: GroveController
    config: SimConfig = field(default_factory=SimConfig)
    now: float = 0.0
    # Deterministic chaos script: ScriptedFault entries (or (at, action,
    # target) tuples) executed when sim time reaches them — BEFORE the
    # reconcile pass, so a node killed at t lands between the previous
    # pass's bind and this pass's solve (the mid-wave death window the
    # stale-plan revalidation exists for). Order within one step follows
    # the schedule order.
    fault_script: list = field(default_factory=list)
    # Grace window granted with a revocation notice (revoke_node and the
    # sim.node_revocation injector site): revocation_deadline = now + grace.
    revocation_grace_s: float = 30.0
    _bound_at: dict[str, float] = field(default_factory=dict)
    _running_at: dict[str, float] = field(default_factory=dict)

    _SCRIPT_ACTIONS = (
        "kill_node",
        "cordon",
        "uncordon",
        "fail_pod",
        "crash_pod",
        "revoke_node",
    )

    def schedule_fault(self, at: float, action: str, target: str) -> None:
        """Append one scripted fault (validated; keeps the script sorted)."""
        if action not in self._SCRIPT_ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; one of "
                + "|".join(self._SCRIPT_ACTIONS)
            )
        self.fault_script.append(ScriptedFault(float(at), action, target))
        self.fault_script.sort(key=lambda f: f.at)

    def _run_script(self) -> None:
        """Execute (and consume) scripted faults due at or before `now`;
        entries scheduled in the past fire on the next step."""
        while self.fault_script:
            entry = self.fault_script[0]
            if not isinstance(entry, ScriptedFault):
                entry = ScriptedFault(*entry)
            if entry.at > self.now:
                break
            self.fault_script.pop(0)
            getattr(self, entry.action)(entry.target)
        # Injector-driven node death (site sim.node_death): kills the first
        # schedulable node in name order — deterministic under the seeded
        # schedule, no script needed.
        from grove_tpu_torch import faults as faults_mod

        inj = faults_mod.active()
        if inj.enabled and inj.should_fire("sim.node_death") is not None:
            victim = next(
                (
                    name
                    for name in sorted(self.cluster.nodes)
                    if self.cluster.nodes[name].schedulable
                ),
                None,
            )
            if victim is not None:
                self.kill_node(victim)
        # Injector-driven revocation notice (site sim.node_revocation): the
        # first revocable, schedulable node without a pending notice, in name
        # order. Candidates are checked BEFORE the dice roll so a fleet with
        # nothing left to revoke doesn't consume (and journal) no-op fires.
        if inj.enabled and "sim.node_revocation" in inj.specs:
            victim = next(
                (
                    name
                    for name in sorted(self.cluster.nodes)
                    if (n := self.cluster.nodes[name]).revocable
                    and n.schedulable
                    and n.revocation_deadline is None
                ),
                None,
            )
            if victim is not None and inj.should_fire("sim.node_revocation") is not None:
                self.revoke_node(victim)
        # Expired notices: the capacity actually disappears — node-death
        # semantics for whatever the controller did not rescue in time.
        for name in sorted(self.cluster.nodes):
            node = self.cluster.nodes[name]
            if (
                node.revocation_deadline is not None
                and node.revocation_deadline <= self.now
                and node.schedulable
            ):
                self._journal_chaos("chaos.revocation_expired", name)
                self.kill_node(name)

    def step(self, dt: float = 1.0) -> None:
        """Advance time, run scripted chaos, pod lifecycle, then one
        reconcile pass."""
        self.now += dt
        self._run_script()
        self._lifecycle()
        self.controller.reconcile(self.now)
        self._lifecycle()  # let fresh bindings from this pass register

    def run(self, seconds: float, dt: float = 1.0) -> None:
        steps = int(seconds / dt)
        for _ in range(steps):
            self.step(dt)

    def run_until(self, predicate, timeout: float = 300.0, dt: float = 1.0) -> bool:
        deadline = self.now + timeout
        while self.now < deadline:
            self.step(dt)
            if predicate():
                return True
        return False

    # --- pod lifecycle -----------------------------------------------------------

    def _lifecycle(self) -> None:
        for pod in list(self.cluster.pods.values()):
            if not pod.is_active:
                continue
            if pod.is_scheduled and pod.name not in self._bound_at:
                self._bound_at[pod.name] = self.now
            if (
                pod.is_scheduled
                and pod.phase == PodPhase.PENDING
                and self.now - self._bound_at.get(pod.name, self.now) >= self.config.start_delay
                and self._startup_gate_open(pod)  # initc gate (wait.go:240-275)
            ):
                pod.phase = PodPhase.RUNNING
                pod.started_at = self.now
                self._running_at[pod.name] = self.now
            if (
                pod.phase == PodPhase.RUNNING
                and not pod.ready
                and not pod.crashlooping
                and self.now - self._running_at.get(pod.name, self.now) >= self.config.ready_delay
            ):
                pod.ready = True

    def _startup_gate_open(self, pod) -> bool:
        """Agent path: run the injected grove-initc container's own args
        through the agent's wait logic (one poll) against the store — sim pods
        start through the agent, not a parallel predicate. Pods without the
        container have no gate, exactly like the reference (initcontainer.go
        only injects for cliques with parents)."""
        if self.config.startup_gate != "agent":
            return may_start(self.cluster, pod)
        from grove_tpu_torch.initc.agent import (
            parse_podcliques_arg,
            requirements_met,
            store_fetch,
        )
        from grove_tpu_torch.orchestrator.expansion import INITC_CONTAINER_NAME

        initc = next(
            (c for c in pod.spec.init_containers if c.name == INITC_CONTAINER_NAME),
            None,
        )
        if initc is None:
            return True
        arg = next(
            (a for a in initc.args if a.startswith("--podcliques=")), "--podcliques="
        )
        reqs = parse_podcliques_arg(arg[len("--podcliques="):])
        return requirements_met(store_fetch(self.cluster), reqs)

    # --- fault injection ----------------------------------------------------------

    def _journal_chaos(self, action: str, obj: str, **fields) -> None:
        """Chaos events land in the flight-recorder journal (when the
        controller carries one) so an incident trace shows the fault that
        displaced a gang right next to the re-admission solve that healed
        it."""
        rec = getattr(self.controller, "recorder", None)
        if rec is None:
            return
        try:
            rec.capture_action(self.now, action, obj, **fields)
        except Exception:  # noqa: BLE001 — tracing must never break the sim
            pass

    def fail_pod(self, pod_name: str) -> None:
        """Hard failure (eviction/OOM-kill of the pod): phase Failed, inactive,
        replaced by the clique controller."""
        pod = self.cluster.pods.get(pod_name)
        if pod is None:
            return
        pod.phase = PodPhase.FAILED
        pod.ready = False
        self.cluster.record_event(self.now, pod.pclq_fqn, f"pod {pod_name} failed")
        self._journal_chaos("chaos.fail_pod", pod_name, clique=pod.pclq_fqn)

    def crash_pod(self, pod_name: str) -> None:
        """Crash loop: container exits non-zero and restarts forever. The pod
        stays bound and active but never Ready — the state that drives
        MinAvailableBreached and eventually gang termination."""
        pod = self.cluster.pods.get(pod_name)
        if pod is None:
            return
        pod.crashlooping = True
        pod.ready = False
        self.cluster.record_event(self.now, pod.pclq_fqn, f"pod {pod_name} crash-looping")
        self._journal_chaos("chaos.crash_pod", pod_name, clique=pod.pclq_fqn)

    def cordon(self, node_name: str) -> None:
        self.cluster.nodes[node_name].schedulable = False
        self._journal_chaos("chaos.cordon", node_name)

    def uncordon(self, node_name: str) -> None:
        self.cluster.nodes[node_name].schedulable = True
        self._journal_chaos("chaos.uncordon", node_name)

    def kill_node(self, node_name: str) -> None:
        """Node dies: cordon + every pod on it fails."""
        self._journal_chaos("chaos.kill_node", node_name)
        self.cordon(node_name)
        for pod in self.cluster.pods.values():
            if pod.node_name == node_name and pod.is_active:
                self.fail_pod(pod.name)

    def revoke_node(self, node_name: str) -> None:
        """Revocation notice: the node's capacity disappears at
        now + revocation_grace_s. The node is marked revocable (a scripted
        notice on a permanent node models a spot conversion), the deadline is
        stamped, and the controller gets the grace window to migrate or evict
        residents; whatever remains dies with the node when the deadline
        expires (see _run_script)."""
        node = self.cluster.nodes.get(node_name)
        if node is None or node.revocation_deadline is not None:
            return
        node.revocable = True
        node.revocation_deadline = self.now + self.revocation_grace_s
        self.cluster.record_event(
            self.now, node_name, f"node {node_name} revocation notice"
        )
        self._journal_chaos(
            "chaos.revoke_node", node_name, deadline=node.revocation_deadline
        )
