"""The port's Simulator (grove_tpu_torch/sim/simulator.py) against the JAX
package's, with each package's controller on the plain versions
(device="cpu"), store to store after every step (`TwinScenario`,
tests/test_torch_controller.py):

  - a scripted chaos schedule (kill_node, cordon, uncordon, fail_pod,
    crash_pod, revoke_node) fires at the same ticks and journals alike;
  - the `bind.commit`, `sim.node_death` and `sim.node_revocation` fault
    sites, each package's injector installed with the same specs and seed
    and one step clock (the simulator's time): the same fires, the same
    all-or-nothing rollbacks (`resilience_counts`), the same
    `fault.injected` records in the journals;
  - the initc agent gate: the port's `parse_podcliques_arg`,
    `requirements_met` and `store_fetch` equal the JAX agent's, and the
    simulator's agent gate opens on the same pods at the same ticks.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
from scenario_harness import wl1, wl2, wl5
from test_torch_controller import TwinScenario, normalize_journal

from grove_tpu import faults as r_faults
from grove_tpu.initc import agent as r_agent
from grove_tpu.orchestrator.expansion import INITC_CONTAINER_NAME
from grove_tpu_torch import faults as p_faults
from grove_tpu_torch.initc import agent as p_agent
from grove_tpu_torch.trace.replay import replay_journal as p_replay


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    r_faults.install(None)
    p_faults.install(None)


def install_injectors(s, specs: dict, seed: int):
    """The same fault schedule in both packages, stamped on the step clock
    and journaled by each side's recorder."""
    out = []
    for mod, side in ((r_faults, s.ref), (p_faults, s.port)):
        sim = side.sim
        inj = mod.FaultInjector({k: mod.SiteSpec(**v) for k, v in specs.items()}, seed=seed,
                                recorder=side.recorder, clock=lambda sim=sim: sim.now)
        mod.install(inj)
        out.append(inj)
    return out


def journals_agree(s) -> list[dict]:
    r_records, p_records = s.journals()
    assert normalize_journal(p_records) == normalize_journal(r_records)
    assert p_replay(p_records, device="cpu").divergence_count == 0
    return p_records


def chaos_actions(records) -> list[tuple]:
    return [(r["now"], r["action"], r["object"]) for r in records
            if r.get("kind") == "action" and r["action"].startswith(("chaos.", "fault."))]


def test_scripted_chaos_equals_jax(tmp_path):
    s = TwinScenario(24)
    s.record(tmp_path)
    s.deploy(wl1())
    s.deploy(wl2("other"))
    assert s.until_ready(20)
    pods = sorted(p.name for p in s.scheduled())
    nodes = sorted({p.node_name for p in s.scheduled()})
    for at, action, target in [(3, "kill_node", nodes[0]), (4, "cordon", nodes[1]),
                               (6, "fail_pod", pods[5]), (7, "crash_pod", pods[9]),
                               (9, "revoke_node", nodes[2]), (12, "uncordon", nodes[1])]:
        s.sim.schedule_fault(s.sim.now + at, action, target)
    s.settle(60)
    assert not s.sim.fault_script
    records = journals_agree(s)
    fired = [a for _, a, _ in chaos_actions(records)]
    for action in ("chaos.kill_node", "chaos.cordon", "chaos.fail_pod", "chaos.crash_pod",
                   "chaos.revoke_node", "chaos.uncordon", "chaos.revocation_expired"):
        assert action in fired, action


def test_fault_sites_fire_alike_under_one_step_clock(tmp_path):
    """bind.commit at rate 0.4, one sim.node_death after 6 evaluations and
    two sim.node_revocation notices: both packages fire the same faults at
    the same ticks, roll back the same gangs whole and recover to the same
    store."""
    s = TwinScenario(30)
    for name in ("w3", "w5", "w7"):
        for side in (s.ref, s.port):
            side.cluster.nodes[name].revocable = True
    s.record(tmp_path)
    injectors = install_injectors(s, {
        "bind.commit": {"rate": 0.4},
        "sim.node_death": {"count": 1, "after": 6},
        "sim.node_revocation": {"count": 2, "after": 2},
    }, seed=11)
    s.deploy(wl1())
    s.deploy(wl2("b"))
    s.settle(50)
    r_inj, p_inj = injectors
    assert p_inj.stats() == r_inj.stats()
    assert p_inj.fired["bind.commit"] >= 1
    assert p_inj.fired["sim.node_death"] == 1 and p_inj.fired["sim.node_revocation"] == 2
    assert s.controller.resilience_counts["bind_rollbacks"] == p_inj.fired["bind.commit"]
    assert s.port.controller.resilience_counts == s.ref.controller.resilience_counts
    records = journals_agree(s)
    sites = [o for _, a, o in chaos_actions(records) if a == "fault.injected"]
    assert {"bind.commit", "sim.node_death", "sim.node_revocation"} <= set(sites)


def test_node_death_site_kills_first_schedulable_node_alike():
    s = TwinScenario(4)
    install_injectors(s, {"sim.node_death": {"count": 1}}, seed=0)
    s.settle(2)
    assert [n.schedulable for n in s.port.cluster.nodes.values()] == [False, True, True, True]


# ---- the initc agent ------------------------------------------------------------------


@pytest.mark.parametrize("arg", ["a-0-prefill:2,a-0-router:1", "", " x:0 , ",
                                 "pcs-0-sg-x-0-pc-c:3", "bad", "a:b", "a:-1", ":1"])
def test_parse_podcliques_arg_equals_jax(arg):
    try:
        want = [(r.fqn, r.min_available) for r in r_agent.parse_podcliques_arg(arg)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            p_agent.parse_podcliques_arg(arg)
        assert str(got.value) == str(e)
        return
    assert [(r.fqn, r.min_available) for r in p_agent.parse_podcliques_arg(arg)] == want


def test_agent_gate_opens_on_the_same_pods_at_the_same_ticks():
    """Explicit startup order (wl5: pc-c after pc-a, pc-b after pc-c): at
    every step each injected init container's requirements evaluate alike
    against the two stores, and pods start at the same ticks."""
    s = TwinScenario(10)
    s.deploy(wl5())
    opened = []
    for _ in range(20):
        s.sim.step()
        verdicts = []
        for side, agent in ((s.ref, r_agent), (s.port, p_agent)):
            fetch = agent.store_fetch(side.cluster)
            row = []
            for pod in sorted(side.cluster.pods.values(), key=lambda p: p.name):
                initc = [c for c in pod.spec.init_containers
                         if c.name == INITC_CONTAINER_NAME]
                if not initc:
                    continue
                arg = next(a for a in initc[0].args if a.startswith("--podcliques="))
                reqs = agent.parse_podcliques_arg(arg[len("--podcliques="):])
                row.append((pod.name, agent.requirements_met(fetch, reqs)))
            verdicts.append(row)
        assert verdicts[0] == verdicts[1]
        opened.append(sum(v for _, v in verdicts[1]))
    assert opened[0] < opened[-1]
    starts = sorted({p.started_at for p in s.port.cluster.pods.values()})
    assert len(starts) >= 3  # three start waves: pc-a, then pc-c, then pc-b
