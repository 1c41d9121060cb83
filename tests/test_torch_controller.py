"""The port's serving path (grove_tpu_torch/orchestrator/controller.py under
sim/simulator.py; plain PyTorch versions, device="cpu") against the JAX
package's, store to store after every simulator step.

`TwinScenario` mirrors tests/scenario_harness.py's `Scenario`: every call
runs on a JAX scenario and on a port scenario built from the same nodes,
topology and PodCliqueSets (the port's copies go through the two packages'
codecs), and after every `Simulator.step` the two stores must be equal
exactly — every node, PodCliqueSet (with its status), PodClique, scaling
group, PodGang (phase, conditions, placement score), pod (node, phase,
readiness, gates, timestamps), managed resource (token values aside) and
the events list in order — as must the controllers' counters. Observations
read the JAX side, so the reference cases below keep their own assertions.

Covered here: GS (gang scheduling, tests/test_scenarios_gs.py), SO (startup
order, test_scenarios_so.py) and TAS (topology, test_scenarios_tas.py)
cases, and a recorded run whose port journal equals the JAX journal
(seconds aside) and replays on the port with 0 divergences.
"""

from __future__ import annotations

import types

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
import scenario_harness as sh
from scenario_harness import build_pcs, clique, wl1, wl2, wl3, wl4, wl5, wl6

import grove_tpu_torch.api.pod as p_pod_mod
import grove_tpu_torch.api.podgang as p_podgang_mod
import grove_tpu_torch.api.resources as p_resources_mod
import grove_tpu_torch.api.types as p_types_mod
import grove_tpu_torch.state.cluster as p_state_mod
from grove_tpu.api.types import TopologyDomain
from grove_tpu.orchestrator.queues import parse_queue_config as r_parse_queues
from grove_tpu.orchestrator.controller import GroveController as RCtl
from grove_tpu.orchestrator.store import Cluster as RCluster
from grove_tpu.sim.simulator import SimConfig as RCfg
from grove_tpu.sim.simulator import Simulator as RSim
from grove_tpu.trace.recorder import TraceRecorder as RRec
from grove_tpu.trace.recorder import read_journal as r_read
from grove_tpu.utils import serde as r_serde
from grove_tpu_torch import bench as p_bench
from grove_tpu_torch.orchestrator.controller import GroveController as PCtl
from grove_tpu_torch.orchestrator.queues import parse_queue_config as p_parse_queues
from grove_tpu_torch.orchestrator.store import Cluster as PCluster
from grove_tpu_torch.sim.simulator import SimConfig as PCfg
from grove_tpu_torch.sim.simulator import Simulator as PSim
from grove_tpu_torch.trace.recorder import TraceRecorder as PRec
from grove_tpu_torch.trace.recorder import read_journal as p_read
from grove_tpu_torch.trace.replay import replay_journal as p_replay
from grove_tpu_torch.utils import serde as p_serde

for _m in (p_types_mod, p_pod_mod, p_podgang_mod, p_state_mod, p_resources_mod):
    p_serde.register_module(_m)

REF = types.SimpleNamespace(Cluster=RCluster, Ctl=RCtl, Sim=RSim, Cfg=RCfg, Rec=RRec,
                            read=r_read, queues=r_parse_queues, kw={})
PORT = types.SimpleNamespace(Cluster=PCluster, Ctl=PCtl, Sim=PSim, Cfg=PCfg, Rec=PRec,
                             read=p_read, queues=p_parse_queues, kw={"device": "cpu"})


def to_port(obj):
    """A JAX-package object -> the port's object of the same type, through
    the two codecs (the port's host model has every field)."""
    return p_serde.decode(r_serde.encode(obj))


# A structural, order-keeping view of a host object; a journal without its
# wall-clock seconds.
plain = p_bench.plain_view
normalize_journal = p_bench.strip_wall


class _Side:
    """One package's cluster, controller and simulator."""

    def __init__(self, P, nodes, topology, ctl: dict, sim: dict, queues: dict | None):
        self.P = P
        self.cluster = P.Cluster()
        for n in nodes:
            self.cluster.nodes[n.name] = n
        self.topology = topology
        if queues:
            ctl = dict(ctl, queues=P.queues(queues))
        self.controller = P.Ctl(cluster=self.cluster, topology=topology, **ctl, **P.kw)
        self.sim = P.Sim(cluster=self.cluster, controller=self.controller,
                         config=P.Cfg(**sim))
        self.recorder = None


class _SimProxy:
    """`s.sim`: every call runs on both simulators, each step is compared."""

    def __init__(self, twin):
        self._twin = twin

    @property
    def now(self):
        return self._twin.ref.sim.now

    @property
    def revocation_grace_s(self):
        return self._twin.ref.sim.revocation_grace_s

    @property
    def fault_script(self):
        return self._twin.ref.sim.fault_script

    def step(self, dt: float = 1.0) -> None:
        self._twin.ref.sim.step(dt)
        self._twin.port.sim.step(dt)
        self._twin.check()

    def run(self, seconds: float, dt: float = 1.0) -> None:
        for _ in range(int(seconds / dt)):
            self.step(dt)

    def run_until(self, predicate, timeout: float = 300.0, dt: float = 1.0) -> bool:
        deadline = self.now + timeout
        while self.now < deadline:
            self.step(dt)
            if predicate():
                return True
        return False

    def __getattr__(self, name):
        # Fault actions (cordon, uncordon, kill_node, fail_pod, crash_pod,
        # revoke_node, schedule_fault): names and times only, so the same
        # arguments serve both.
        def call(*args, **kwargs):
            out = getattr(self._twin.ref.sim, name)(*args, **kwargs)
            getattr(self._twin.port.sim, name)(*args, **kwargs)
            self._twin.check()
            return out

        return call


class _ControllerProxy:
    """`s.controller`: settings go to both controllers; reads come from the
    JAX one; method calls run on both and are compared."""

    def __init__(self, twin):
        object.__setattr__(self, "_twin", twin)

    def __setattr__(self, name, value):
        setattr(self._twin.ref.controller, name, value)
        setattr(self._twin.port.controller, name, value)

    def __getattr__(self, name):
        ref = getattr(self._twin.ref.controller, name)
        if not callable(ref) or isinstance(ref, type):
            return ref

        def call(*args, **kwargs):
            out = ref(*args, **kwargs)
            getattr(self._twin.port.controller, name)(*args, **kwargs)
            self._twin.check()
            return out

        return call


class TwinScenario(sh.Scenario):
    """scenario_harness.Scenario on both packages in lockstep."""

    def __init__(self, n_nodes: int, *, topology=None, nodes=None, priority_classes=None,
                 ctl: dict | None = None, sim: dict | None = None, queues: dict | None = None):
        nodes = nodes if nodes is not None else sh.e2e_nodes(n_nodes)
        topology = topology or sh.e2e_topology()
        ctl = dict(ctl or {})
        ctl["priority_classes"] = dict(priority_classes or {})
        sim = dict(sim if sim is not None else {"start_delay": 1.0, "ready_delay": 1.0})
        self.port = _Side(PORT, [to_port(n) for n in nodes], to_port(topology), ctl, sim, queues)
        self.ref = _Side(REF, nodes, topology, ctl, sim, queues)
        self.cluster = self.ref.cluster
        self.topology = self.ref.topology
        self.controller = _ControllerProxy(self)
        self.sim = _SimProxy(self)
        self._pcs = {}  # id(JAX pcs) -> port pcs
        self.checks = 0

    # -- the comparison -----------------------------------------------------------

    def check(self) -> None:
        """The two whole stores and controllers' counters, equal."""
        p_bench.same_views([p_bench.store_view(side.cluster, side.controller)
                            for side in (self.ref, self.port)], f"at t={self.ref.sim.now}")
        self.checks += 1

    # -- recording ----------------------------------------------------------------

    def record(self, tmp_path) -> None:
        for name, side in (("jax", self.ref), ("port", self.port)):
            side.recorder = side.P.Rec(str(tmp_path / name))
            side.recorder.start()
            side.controller.recorder = side.recorder

    def journals(self) -> tuple[list[dict], list[dict]]:
        out = []
        for side in (self.ref, self.port):
            side.recorder.stop()
            out.append(side.P.read(side.recorder.path))
        return out[0], out[1]

    # -- setup and mutations on both sides -------------------------------------------

    def port_pcs(self, pcs):
        return self._pcs[id(pcs)]

    def deploy(self, pcs):
        port = self._pcs[id(pcs)] = to_port(pcs)
        self.ref.cluster.podcliquesets[pcs.metadata.name] = pcs
        self.ref.controller.sync_workload(pcs, self.ref.sim.now)
        self.port.cluster.podcliquesets[port.metadata.name] = port
        self.port.controller.sync_workload(port, self.port.sim.now)
        self.check()
        return pcs

    def scale_pcsg(self, pcs_name, sg, replicas, pcs_replica=0):
        for side in (self.ref, self.port):
            fqn = f"{pcs_name}-{pcs_replica}-{sg}"
            side.cluster.scale_overrides[fqn] = replicas

    def scale_pclq(self, pcs_name, clique_tmpl, replicas, pcs_replica=0):
        for side in (self.ref, self.port):
            side.cluster.scale_overrides[f"{pcs_name}-{pcs_replica}-{clique_tmpl}"] = replicas

    def scale_pcs(self, pcs, replicas):
        pcs.spec.replicas = replicas
        self._pcs[id(pcs)].spec.replicas = replicas

    def change_clique_spec(self, pcs, *clique_names):
        super().change_clique_spec(pcs, *clique_names)
        sh.Scenario.change_clique_spec(self, self._pcs[id(pcs)], *clique_names)

    def set_schedulable(self, name: str, value: bool) -> None:
        for side in (self.ref, self.port):
            side.cluster.nodes[name].schedulable = value


# ---- GS: gang scheduling (tests/test_scenarios_gs.py) ------------------------------


def gs1(s):
    s.cordon_n(1)
    s.deploy(wl1())
    s.settle(10)
    assert len(s.pods()) == 10 and not s.scheduled()
    s.uncordon_n(1)
    assert s.until_scheduled(10)
    assert len({p.node_name for p in s.scheduled()}) == 10


def gs2(s):
    s.cordon_n(5)
    s.deploy(wl1())
    s.settle(10)
    s.uncordon_n(1)
    assert s.until_scheduled(10) and s.until_ready(10)
    s.scale_pcsg("pcs", "sg-x", 3)
    s.settle(5)
    assert len(s.pending_unscheduled()) == 4
    s.uncordon_n(4)
    assert s.until_scheduled(14)


def gs3(s):
    s.cordon_n(11)
    pcs = s.deploy(wl1())
    s.settle(10)
    s.uncordon_n(1)
    assert s.until_scheduled(10) and s.until_ready(10)
    s.scale_pcs(pcs, 2)
    s.settle(5)
    assert len(s.pods()) == 20 and len(s.pending_unscheduled()) == 10
    s.uncordon_n(10)
    assert s.until_scheduled(20)


def gs5(s):
    s.cordon_n(8)
    s.deploy(wl2())
    s.settle(10)
    assert not s.scheduled()
    s.uncordon_n(1)
    assert s.until_scheduled(3) and len(s.scheduled()) == 3
    assert s.until_ready(3)
    s.uncordon_n(7)
    assert s.until_scheduled(10)


def gs6(s):
    s.cordon_n(12)
    s.deploy(wl2())
    s.settle(10)
    s.uncordon_n(1)
    assert s.until_scheduled(3) and s.until_ready(3)
    s.uncordon_n(7)
    assert s.until_scheduled(10) and s.until_ready(10)
    s.scale_pcsg("pcs", "sg-x", 3)
    s.settle(5)
    assert len(s.pending_unscheduled()) == 4
    s.uncordon_n(2)
    assert s.until_scheduled(12)
    s.uncordon_n(2)
    assert s.until_scheduled(14)


def gs8(s):
    s.cordon_n(12)
    s.deploy(wl2())
    s.settle(5)
    s.scale_pcsg("pcs", "sg-x", 3)
    s.settle(5)
    assert len(s.pods()) == 14 and not s.scheduled()
    s.uncordon_n(1)
    assert s.until_scheduled(3) and s.until_ready(3)
    s.uncordon_n(4)
    assert s.until(lambda: all(len(s.scheduled(f"pcs-0-sg-x-{j}-pc-b")) >= 1
                               and len(s.scheduled(f"pcs-0-sg-x-{j}-pc-c")) >= 1
                               for j in (1, 2)))
    s.uncordon_n(7)
    assert s.until_scheduled(14)


def gs11(s):
    s.cordon_n(28)
    pcs = s.deploy(wl2())
    s.scale_pcs(pcs, 2)
    s.scale_pcsg("pcs", "sg-x", 3, pcs_replica=0)
    s.scale_pcsg("pcs", "sg-x", 3, pcs_replica=1)
    s.settle(5)
    assert len(s.pods()) == 28 and not s.scheduled()
    s.uncordon_n(6)
    assert s.until(lambda: len(s.scheduled("pcs-0-")) >= 3
                   and len(s.scheduled("pcs-1-")) >= 3)
    s.uncordon_n(22)
    assert s.until_scheduled(28)


def gs12(s):
    s.deploy(wl2())
    assert s.until_scheduled(10) and s.until_ready(10)
    s.scale_pcsg("pcs", "sg-x", 4)
    s.settle(5)
    assert s.until_scheduled(18)
    s.scale_pcsg("pcs", "sg-x", 2)
    assert s.until(lambda: len(s.pods()) == 10)
    s.scale_pcsg("pcs", "sg-x", 3)
    assert s.until_scheduled(14)


GS = {"gs1": (10, gs1), "gs2": (14, gs2), "gs3": (20, gs3), "gs5": (10, gs5),
      "gs6": (14, gs6), "gs8": (14, gs8), "gs11": (28, gs11), "gs12": (18, gs12)}


@pytest.mark.parametrize("case", sorted(GS))
def test_gang_scheduling_cases_equal_the_jax_controller(case):
    n_nodes, body = GS[case]
    s = TwinScenario(n_nodes)
    body(s)
    assert s.checks >= 10


# ---- SO: startup order (tests/test_scenarios_so.py) --------------------------------


@pytest.mark.parametrize("gate", ["agent", "predicate"])
@pytest.mark.parametrize("wl", [wl3, wl4, wl5, wl6], ids=["so1", "so2", "so3", "so4"])
def test_startup_order_cases_equal_the_jax_controller(wl, gate):
    """Each startup order under the simulator's initc agent gate (the
    default) and under the plain predicate gate: pods come Running and
    Ready in the same order on both, tick by tick."""
    s = TwinScenario(10, sim={"start_delay": 1.0, "ready_delay": 1.0, "startup_gate": gate})
    s.deploy(wl())
    assert s.until_ready(len(s.pods()), timeout=60)
    s.settle(3)
    started = sorted((p.started_at, p.name) for p in s.port.cluster.pods.values())
    assert len({t for t, _ in started}) >= 2 or wl in (wl4, wl6)


# ---- TAS: topology (tests/test_scenarios_tas.py) -----------------------------------


def _pcs_sg(name, *, pcs_pack=None, sg_pack=None, sg_replicas=1, b_repl=2, c_repl=2):
    return build_pcs(
        name,
        cliques=[clique("pc-b", b_repl, b_repl), clique("pc-c", c_repl, c_repl)],
        scaling_groups=[{"name": "sg-x", "cliqueNames": ["pc-b", "pc-c"],
                         "replicas": sg_replicas, "minAvailable": sg_replicas,
                         **({"topologyConstraint": {"packDomain": sg_pack}} if sg_pack else {})}],
        pack=pcs_pack,
    )


def tas2(s):
    s.deploy(build_pcs("tas2", cliques=[clique("rackers", 3, 3, pack="rack"),
                                        clique("blockers", 4, 4, pack="block")]))
    assert s.until_scheduled(7)
    assert len(s.domain_of_pods("tas2-0-rackers", TopologyDomain.RACK)) == 1


def tas5(s):
    s.deploy(build_pcs("tas5", cliques=[clique("co", 3, 3, pack="host")]))
    assert s.until_scheduled(3) and len(s.nodes_of("tas5-0-co")) == 1


def tas12(s):
    s.deploy(_pcs_sg("tas12", sg_pack="rack", sg_replicas=4))
    assert s.until_scheduled(16)


def tas13(s):
    s.deploy(build_pcs("tas13", cliques=[clique("worker", 10, 10)], pack="rack"))
    s.settle(15)
    assert not s.scheduled()


def tas15(s):
    s.deploy(build_pcs(
        "tas15",
        cliques=[clique("router", 1, 1), clique("p-ldr", 1, 1), clique("p-wrk", 2, 2),
                 clique("d-ldr", 1, 1), clique("d-wrk", 2, 2)],
        scaling_groups=[
            {"name": "prefill", "cliqueNames": ["p-ldr", "p-wrk"], "replicas": 1,
             "minAvailable": 1, "topologyConstraint": {"packDomain": "rack"}},
            {"name": "decode", "cliqueNames": ["d-ldr", "d-wrk"], "replicas": 1,
             "minAvailable": 1, "topologyConstraint": {"packDomain": "rack"}},
        ],
        pack="block"))
    assert s.until_scheduled(7)


def tas16(s):
    s.deploy(build_pcs(
        "tas16", cliques=[clique("pc-b", 2, 2), clique("pc-c", 2, 2)],
        scaling_groups=[{"name": "sg-x", "cliqueNames": ["pc-b", "pc-c"], "replicas": 2,
                         "minAvailable": 2, "topologyConstraint": {"packDomain": "rack"}}],
        pack="block", replicas=2))
    assert s.until_scheduled(16)
    for i in (0, 1):
        assert len(s.domain_of_pods(f"tas16-{i}-", TopologyDomain.BLOCK)) == 1


TAS = {"tas2": (28, tas2), "tas5": (8, tas5), "tas12": (28, tas12), "tas13": (28, tas13),
       "tas15": (28, tas15), "tas16": (56, tas16)}


@pytest.mark.parametrize("case", sorted(TAS))
def test_topology_cases_equal_the_jax_controller(case):
    n_nodes, body = TAS[case]
    nodes = sh.e2e_nodes(n_nodes, mem=4 * 100 * sh.MI) if case == "tas5" else None
    s = TwinScenario(n_nodes, nodes=nodes)
    body(s)
    # Run on until the placed pods are Ready, then a little past it.
    assert s.until_ready(len(s.scheduled()))
    s.settle(2)
    assert s.checks >= 5


# ---- the journal -------------------------------------------------------------------


def test_recorded_run_journal_equals_jax_and_replays_on_the_port(tmp_path):
    """A churned GS run with the recorder on: the port's journal equals the
    JAX one record for record (wall-clock seconds aside), and the port
    replays both journals on the plain versions with 0 divergences."""
    s = TwinScenario(14)
    s.record(tmp_path)
    s.cordon_n(12)
    s.deploy(wl2())
    s.settle(4)
    s.uncordon_n(3)
    assert s.until_scheduled(5)
    s.sim.kill_node(s.scheduled()[0].node_name)
    s.uncordon_n(7)
    assert s.until_ready(10)
    r_records, p_records = s.journals()
    waves = [r for r in p_records if r.get("kind") == "wave"]
    assert len(waves) >= 3
    assert {r.get("wave") for r in waves} == {"floors", "extras"}
    assert any(r.get("kind") == "action" for r in p_records)
    assert normalize_journal(p_records) == normalize_journal(r_records)
    for records in (p_records, r_records):
        assert p_replay(records, device="cpu").divergence_count == 0


def test_controller_without_a_card_raises_unless_asked_for_the_cpu():
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCtl(cluster=PCluster(), topology=to_port(sh.e2e_topology()))
    ctl = PCtl(cluster=PCluster(), topology=to_port(sh.e2e_topology()), device="cpu")
    assert ctl.device == torch.device("cpu")
