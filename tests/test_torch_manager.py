"""The port's operator Manager (grove_tpu_torch/runtime/manager.py) and what
it brings — admission and webhooks, the KWOK fleet and the watch driver,
persistence, the certs, the initc agent's binary and the operator binary —
against the JAX package's:

  - `Manager.reconcile_once` over a scripted KWOK world (a workload applied,
    a node killed, the workload deleted): the stores equal after every step,
    the journals equal seconds aside, `statusz()` equal but for the named
    keys the port reports differently;
  - the KWOK fleet fabricated from a config and the watch driver's events;
  - dump/load and StatePersistence round trips, across the packages;
  - AdmissionReview bodies answered equally by handle_mutate,
    handle_validate, handle_authorize, and over HTTPS by the port's manager;
  - the operator binary with `--device cpu` boots, answers its probes,
    admits a PodCliqueSet over TLS, schedules it, stops on SIGTERM, and has
    no JAX module loaded; without a card and without `--device cpu` it
    refuses to run.
"""

from __future__ import annotations

import base64
import copy
import json
import pathlib
import subprocess
import sys
import urllib.request

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
import yaml

from grove_tpu.api import admission as r_adm
from grove_tpu.api import webhook as r_hook
from grove_tpu.api.types import PodCliqueSet as RPCS
from grove_tpu.cluster import kwok as r_kwok
from grove_tpu.runtime import persistence as r_pers
from grove_tpu.runtime.config import parse_operator_config as r_parse
from grove_tpu.runtime.manager import Manager as RManager
from grove_tpu.sim import workloads as r_wl
from grove_tpu.trace.recorder import read_journal as r_read
from grove_tpu_torch import bench as p_bench
from grove_tpu_torch.api import admission as p_adm
from grove_tpu_torch.api import webhook as p_hook
from grove_tpu_torch.api.types import PodCliqueSet as PPCS
from grove_tpu_torch.cluster import kwok as p_kwok
from grove_tpu_torch.runtime import persistence as p_pers
from grove_tpu_torch.runtime.config import parse_operator_config as p_parse
from grove_tpu_torch.runtime.manager import Manager as PManager
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.trace.recorder import read_journal as p_read
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
# statusz keys the port reports differently, by design: the build names
# torch and CUDA where the JAX package names jax; the port's WarmPath counts
# its device-resident domain tables; the port's solver section names the
# device and the kernel launches; the host stages are seconds; the trace
# section's journal path and its flush-timed counters (bench.py's
# RECORDER_WALL_KEYS) depend on where and when the writer ran.
STATUSZ_ASIDE = {
    ("build", "jax"), ("build", "torch"), ("build", "cuda"),
    ("warmPath", "deviceDomainHits"), ("warmPath", "deviceDomainMisses"),
    ("solver", "device"), ("solver", "hostStages"),
    *(("trace", k) for k in p_bench.RECORDER_WALL_KEYS),
}


@pytest.fixture(autouse=True, scope="module")
def _no_shared_xla_cache():
    """This module's JAX compiles stay out of the suite's persistent XLA
    cache (tests/conftest.py): a worker reading an entry another worker is
    writing in place can crash."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    cc.reset_cache()


def local_paths(doc: dict, root: pathlib.Path) -> dict:
    """`doc` with every path a started Manager writes (the shape history its
    prewarm reads, the certs, the lease, the snapshot, the journal) under
    `root`, so that no run shares the defaults' files under /tmp."""
    doc.setdefault("solver", {})["shapeHistoryPath"] = str(root / "solve-shapes.json")
    doc.setdefault("servers", {})["tlsCertDir"] = str(root / "certs")
    doc.setdefault("leaderElection", {})["leaseFile"] = str(root / "leader.lease")
    doc.setdefault("persistence", {})["path"] = str(root / "state.json")
    doc.setdefault("trace", {}).setdefault("path", str(root / "trace"))
    return doc


def simple1_doc() -> dict:
    return yaml.safe_load((REPO / "examples" / "simple1.yaml").read_text())


def twin_managers(doc: dict):
    """(JAX manager, port manager on the CPU) from one config document, on
    bench_topology, each with its KWOK fleet of 12 nodes attached."""
    r_cfg, r_err = r_parse(copy.deepcopy(doc))
    p_cfg, p_err = p_parse(copy.deepcopy(doc))
    assert r_err == p_err == []
    out = []
    for cfg, mgr, wl, kw, kwargs in ((r_cfg, RManager, r_wl, r_kwok, {}),
                                     (p_cfg, PManager, p_wl, p_kwok, {"device": "cpu"})):
        m = mgr(cfg, **kwargs)
        m.controller.topology = wl.bench_topology()
        m.topology = m.controller.topology
        nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2,
                                     hosts_per_rack=6)[:12]
        fleet = kw.kwok_fleet(nodes, now=0.0)
        m.attach_watch(fleet)
        out.append((m, fleet))
    return out


def statusz_core(doc: dict) -> dict:
    out = {}
    for k, v in doc.items():
        if isinstance(v, dict):
            v = {kk: vv for kk, vv in v.items() if (k, kk) not in STATUSZ_ASIDE}
        out[k] = v
    return out


def fresh_process_state() -> None:
    """Reset, in both packages, the process-wide state that statusz reads or
    that steers a solve, which an earlier test in the same worker may have
    moved: the mesh shard-fallback ledger (statusz warmPath and solver.mesh
    shardFallbacks), the process-shared WarmPath, and the installed fault
    injector."""
    import grove_tpu.parallel.mesh as r_mesh
    import grove_tpu.solver.warm as r_warm
    import grove_tpu_torch.parallel.mesh as p_mesh
    import grove_tpu_torch.solver.warm as p_warm
    from grove_tpu import faults as r_faults
    from grove_tpu_torch import faults as p_faults

    for mesh in (r_mesh, p_mesh):
        with mesh._FALLBACK_LOCK:
            mesh._FALLBACKS = 0
    for warm in (r_warm, p_warm):
        with warm._DEFAULT_LOCK:
            warm._DEFAULT_WARM_PATH = None
    r_faults.install(None)
    p_faults.install(None)


def run_twin(root: pathlib.Path) -> dict:
    """The scripted KWOK world run by both managers step for step, from a
    fresh process state: simple1 applied at 0.5 s, the node under its first
    pod killed at 6 s, simple1 deleted at 12 s; the store views after every
    step, the journals and statusz at the end."""
    fresh_process_state()
    doc = {"servers": {"healthPort": -1, "metricsPort": -1}, "backend": {"enabled": False}}
    runs = {}
    for side in ("jax", "port"):
        d = copy.deepcopy(doc)
        d["trace"] = {"enabled": True, "path": str(root / side / "trace")}
        runs[side] = d
    (rm, rk), _ = twin_managers(runs["jax"])
    _, (pm, pk) = twin_managers(runs["port"])
    rm.trace_recorder.start()
    pm.trace_recorder.start()
    views, t = [], 0.0
    killed = None
    try:
        for step in range(30):
            t = round(t + 0.5, 1)
            if step == 0:
                rm.apply_podcliqueset(RPCS.from_dict(simple1_doc()))
                pm.apply_podcliqueset(PPCS.from_dict(simple1_doc()))
            if t == 6.0:
                killed = sorted(p.node_name for p in pm.cluster.pods.values() if p.node_name)[0]
                rk.remove_node(killed, now=t)
                pk.remove_node(killed, now=t)
            if t == 12.0:
                rm.delete_podcliqueset("simple1")
                pm.delete_podcliqueset("simple1")
            a = rm.reconcile_once(now=t)
            b = pm.reconcile_once(now=t)
            views.append((t, p_bench.store_view(rm.cluster, rm.controller),
                          p_bench.store_view(pm.cluster, pm.controller),
                          a.has_errors, b.has_errors))
        rm.trace_recorder.flush()
        pm.trace_recorder.flush()
        journals = (r_read(rm.trace_recorder.path), p_read(pm.trace_recorder.path))
        statusz = (rm.statusz(), pm.statusz())
    finally:
        rm.trace_recorder.stop()
        pm.trace_recorder.stop()
    return {"views": views, "journals": journals, "statusz": statusz, "killed": killed,
            "managers": (rm, pm)}


@pytest.fixture(scope="module")
def twin_run(tmp_path_factory):
    return run_twin(tmp_path_factory.mktemp("twin"))


def test_reconcile_once_stores_equal_after_every_step(twin_run):
    views = twin_run["views"]
    assert twin_run["killed"] is not None
    for t, want, got, r_err, p_err in views:
        assert r_err == p_err, t
        if got != want:
            first = next(k for k in want if want[k] != got.get(k))
            raise AssertionError(f"t={t}: the stores differ first at {first}")
    # The world did something: pods ran, the killed node's pod came back,
    # the delete emptied the store.
    peak = max(len(dict(v[2]["pods"])) for v in views)
    assert peak >= 13
    assert dict(views[-1][2]["podcliquesets"]) == {}


def test_reconcile_once_journals_equal_seconds_aside(twin_run):
    want, got = twin_run["journals"]
    assert sum(1 for r in got if r.get("kind") == "wave") >= 2
    assert p_bench.strip_wall(got) == p_bench.strip_wall(want)


def test_statusz_equal_but_named_keys(twin_run):
    want, got = twin_run["statusz"]
    for section, key in STATUSZ_ASIDE:
        if section in ("warmPath", "solver", "trace"):
            assert key in got[section], (section, key)
    assert got["build"]["torch"] and "jax" in want["build"] and "jax" not in got["build"]
    assert got["solver"]["device"]["type"] == "cpu"
    assert got["solver"]["streaming"]["pollS"] == want["solver"]["streaming"]["pollS"]
    assert statusz_core(got) == statusz_core(want)


def test_statusz_equal_after_a_worker_moved_the_process_state(tmp_path):
    """What an earlier test in the same worker leaves behind (a drain that
    asked for a mesh it could not engage, through each package's shared
    WarmPath: the JAX package's process-wide shard-fallback count moves)
    does not reach the twin run's statusz."""
    import grove_tpu.parallel.mesh as r_mesh
    import grove_tpu.solver.warm as r_warm
    import grove_tpu_torch.parallel.mesh as p_mesh
    import grove_tpu_torch.solver.warm as p_warm
    from grove_tpu.api import DEFAULT_CLUSTER_TOPOLOGY as R_TOPO
    from grove_tpu.orchestrator import expand_podcliqueset as r_expand
    from grove_tpu.solver.drain import drain_backlog as r_drain
    from grove_tpu.state import build_snapshot as r_snapshot
    from grove_tpu_torch.api import DEFAULT_CLUSTER_TOPOLOGY as P_TOPO
    from grove_tpu_torch.orchestrator import expand_podcliqueset as p_expand
    from grove_tpu_torch.solver.drain import drain_backlog as p_drain
    from grove_tpu_torch.state import build_snapshot as p_snapshot
    from torch_jax_programs import release_jax_programs

    # The port negotiates on 2 virtual devices of the CPU: one device never
    # counts a fallback, in either package.
    p_mesh.force_virtual_devices(2, "cpu")
    try:
        for pcs_cls, topo, expand, snapshot, wl, drain, mesh, kw in (
                (RPCS, R_TOPO, r_expand, r_snapshot, r_wl, r_drain, r_mesh, {}),
                (PPCS, P_TOPO, p_expand, p_snapshot, p_wl, p_drain, p_mesh, {"device": "cpu"})):
            ds = expand(pcs_cls.from_dict(simple1_doc()), topo)
            nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2,
                                         hosts_per_rack=4)
            drain(ds.podgangs, {p.name: p for p in ds.pods}, snapshot(nodes, topo),
                  wave_size=16, mesh=mesh.MeshConfig(enabled=True, min_nodes=1 << 20), **kw)
    finally:
        p_mesh.force_virtual_devices(0)
    assert r_mesh.shard_fallbacks() >= 1 and p_mesh.shard_fallbacks() >= 1
    assert r_warm.default_warm_path().stats()["execMisses"] >= 1
    assert p_warm.default_warm_path().stats()["execMisses"] >= 1
    try:
        run = run_twin(tmp_path)
    finally:
        release_jax_programs()
    want, got = run["statusz"]
    assert want["solver"]["mesh"]["shardFallbacks"] == 0
    assert statusz_core(got) == statusz_core(want)


def test_persistence_round_trips_across_packages(twin_run, tmp_path):
    rm, pm = twin_run["managers"]
    r_doc = r_pers.dump_cluster(rm.cluster)
    p_doc = p_pers.dump_cluster(pm.cluster)
    assert json.loads(json.dumps(p_doc)) == json.loads(json.dumps(r_doc))
    want = p_bench.store_view(pm.cluster, pm.controller)
    loaded = p_pers.load_cluster(json.loads(json.dumps(r_doc)))
    got = p_bench.store_view(loaded, pm.controller)
    for key in ("nodes", "podcliquesets", "podcliques", "podgangs", "pods"):
        assert got[key] == want[key], key
    # A file written by the JAX package's StatePersistence restores into the
    # port's, and the port's file back into the JAX package's.
    r_path, p_path = tmp_path / "r.json", tmp_path / "p.json"
    r_pers.StatePersistence(str(r_path)).snapshot(rm.cluster)
    p_pers.StatePersistence(str(p_path)).snapshot(pm.cluster)
    assert json.loads(r_path.read_text()) == json.loads(p_path.read_text())
    from grove_tpu.orchestrator.store import Cluster as RCluster
    from grove_tpu_torch.orchestrator.store import Cluster as PCluster

    into_p, into_r = PCluster(), RCluster()
    assert p_pers.StatePersistence(str(r_path)).restore(into_p)
    assert r_pers.StatePersistence(str(p_path)).restore(into_r)
    for key in ("nodes", "podgangs", "pods"):
        assert p_bench.plain_view(getattr(into_p, key)) == p_bench.plain_view(
            getattr(into_r, key)) == want[key], key


@pytest.mark.parametrize("nodes,per_rack,revocable", [(8, 4, 0), (20, 6, 3)])
def test_kwok_fleet_from_config_and_watch_events_equal(nodes, per_rack, revocable):
    doc = {"cluster": {"source": "kwok", "kwokNodes": nodes, "kwokHostsPerRack": per_rack,
                       "kwokTpuPerNode": 4, "revocableNodes": revocable,
                       "runningDelaySeconds": 0.5, "readyDelaySeconds": 1.0}}
    r_cfg, _ = r_parse(copy.deepcopy(doc))
    p_cfg, _ = p_parse(copy.deepcopy(doc))
    rf = r_kwok.kwok_fleet_from_config(r_cfg.cluster, r_cfg.cluster_topology(), now=0.0)
    pf = p_kwok.kwok_fleet_from_config(p_cfg.cluster, p_cfg.cluster_topology(), now=0.0)
    view = p_bench.plain_view
    assert view(pf.poll(0.0)) == view(rf.poll(0.0))
    first = sorted(rf.nodes)[0]
    for f in (rf, pf):
        f.observe_binding("pod-a", first, now=0.1)
        f.observe_binding("pod-b", first, now=0.2)
        f.set_schedulable(first, False, now=0.3)
        f.fail_pod("pod-b", now=0.4)
    for t in (0.5, 0.9, 1.4, 2.0):
        rf.tick(t)
        pf.tick(t)
        assert view(pf.poll(t)) == view(rf.poll(t)), t
    for f in (rf, pf):
        f.observe_deletion("pod-a", now=2.5)
        f.remove_node(first, now=2.6)
    assert view(pf.poll(3.0)) == view(rf.poll(3.0))


def test_watch_driver_pumps_equal_stores():
    (rm, rk), (pm, pk) = twin_managers(
        {"servers": {"healthPort": -1, "metricsPort": -1}, "backend": {"enabled": False}})
    for k in (rk, pk):
        k.set_schedulable(sorted(k.nodes)[0], False, now=0.2)
        k.remove_node(sorted(k.nodes)[1], now=0.2)
    got = pm.watch.pump(now=0.3), pm.watch.pump(now=0.5)
    want = rm.watch.pump(now=0.3), rm.watch.pump(now=0.5)
    assert got == want
    assert p_bench.plain_view(pm.cluster.nodes) == p_bench.plain_view(rm.cluster.nodes)
    assert len(pm.cluster.nodes) == 11


# ---- admission ------------------------------------------------------------------------


def review(obj, operation="CREATE", old=None, uid="uid-1"):
    req = {"uid": uid, "operation": operation, "object": obj}
    if old is not None:
        req["oldObject"] = old
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview", "request": req}


def _bad_starts_after():
    d = simple1_doc()
    d["spec"]["template"]["cliques"][0]["spec"]["startsAfter"] = ["frontend"]
    return d


def _renamed():
    d = simple1_doc()
    d["spec"]["template"]["cliques"][0]["name"] = "renamed"
    return d


def _long_name():
    d = simple1_doc()
    d["metadata"]["name"] = "x" * 60
    return d


def _slice():
    d = simple1_doc()
    d["metadata"].setdefault("annotations", {})["grove.io/auto-slice"] = "enabled"
    return d


REVIEWS = {
    "create": lambda: review(simple1_doc()),
    "cyclic": lambda: review(_bad_starts_after()),
    "long-name": lambda: review(_long_name()),
    "update-immutable": lambda: review(_renamed(), "UPDATE", simple1_doc()),
    "update-same": lambda: review(simple1_doc(), "UPDATE", simple1_doc()),
    "delete": lambda: review(None, "DELETE"),
    "malformed": lambda: review({"spec": "not-a-map"}),
    "auto-slice": lambda: review(_slice()),
}


def chains():
    """(JAX chain, port chain) pairs: the default, and auto-slice on."""
    return [
        (r_adm.AdmissionChain(), p_adm.AdmissionChain()),
        (r_adm.AdmissionChain(auto_slice_enabled=True),
         p_adm.AdmissionChain(auto_slice_enabled=True)),
    ]


@pytest.mark.parametrize("name", sorted(REVIEWS))
@pytest.mark.parametrize("hook", ["handle_mutate", "handle_validate"])
def test_admission_reviews_answer_equal(name, hook):
    for r_chain, p_chain in chains():
        want = getattr(r_hook, hook)(REVIEWS[name](), r_chain)
        got = getattr(p_hook, hook)(REVIEWS[name](), p_chain)
        assert got == want, (name, hook)


def authz(kind, name, username, operation="UPDATE", managed=True, annotations=None):
    labels = {"app.kubernetes.io/managed-by": "grove-operator"} if managed else {}
    obj = {"kind": kind, "metadata": {"name": name, "labels": labels,
                                      "annotations": annotations or {}}}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": "u1", "operation": operation, "kind": {"kind": kind},
                        "name": name, "object": obj, "oldObject": obj,
                        "userInfo": {"username": username}}}


@pytest.mark.parametrize("body", [
    authz("PodClique", "a-0-b", "alice"),
    authz("PodClique", "a-0-b", "system:serviceaccount:grove:grove-tpu-operator"),
    authz("PodGang", "a-0", "bob", operation="DELETE"),
    authz("Pod", "a-0-b-xyz", "bob", operation="DELETE"),
    authz("PodClique", "free", "alice", managed=False),
    authz("PodClique", "a-0-b", "alice",
          annotations={"grove.io/disable-managed-resource-protection": "true"}),
], ids=["user", "operator", "gang-delete", "pod-delete", "unmanaged", "protection-off"])
def test_authorize_reviews_answer_equal(body):
    ops = {"grove-operator", "system:serviceaccount:grove:grove-tpu-operator"}
    for r_chain, p_chain in chains():
        want = r_hook.handle_authorize(copy.deepcopy(body), r_chain, operator_users=ops)
        got = p_hook.handle_authorize(copy.deepcopy(body), p_chain, operator_users=ops)
        assert got == want


def test_admit_podcliqueset_equal_errors():
    for d in (simple1_doc(), _bad_starts_after(), _long_name()):
        outcomes = []
        for adm, pcs_cls in ((r_adm, RPCS), (p_adm, PPCS)):
            try:
                pcs = adm.AdmissionChain().admit_podcliqueset(pcs_cls.from_dict(copy.deepcopy(d)))
                outcomes.append(("ok", p_bench.plain_view(pcs)))
            except adm.AdmissionError as e:
                outcomes.append(("denied", [str(x) for x in e.errors]))
        assert outcomes[1] == outcomes[0]


def test_manager_webhook_over_tls_answers_as_the_jax_chain(tmp_path):
    from grove_tpu_torch.runtime.certs import pinned_client_context

    doc = local_paths({"servers": {"healthPort": 0, "metricsPort": -1, "webhookPort": 0},
                       "backend": {"enabled": False},
                       "leaderElection": {"enabled": False}}, tmp_path)
    cfg, errors = p_parse(copy.deepcopy(doc))
    assert not errors
    m = PManager(cfg, device="cpu")
    m.start()
    try:
        ctx = pinned_client_context(m._webhook_tls_paths[0])
        r_chain = RManager(r_parse(copy.deepcopy(doc))[0]).admission
        for path, hook in (("/webhook/v1/default", r_hook.handle_mutate),
                           ("/webhook/v1/validate", r_hook.handle_validate)):
            for name in ("create", "cyclic", "update-immutable"):
                body = REVIEWS[name]()
                req = urllib.request.Request(
                    f"https://127.0.0.1:{m.webhook_port}{path}", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                got = json.loads(urllib.request.urlopen(req, context=ctx, timeout=10).read())
                assert got == hook(REVIEWS[name](), r_chain), (path, name)
        mutated = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"https://127.0.0.1:{m.webhook_port}/webhook/v1/default",
            data=json.dumps(REVIEWS["create"]()).encode(), method="POST"),
            context=ctx, timeout=10).read())["response"]
        patched = p_bench.json_patch(simple1_doc(), json.loads(base64.b64decode(
            mutated["patch"])))
        again = p_hook.handle_mutate(review(patched), m.admission)["response"]
        assert again["allowed"] and "patch" not in again  # fully defaulted
    finally:
        m.stop()


# ---- the binaries -----------------------------------------------------------------------


def test_operator_binary_on_the_cpu_admits_and_schedules():
    out = p_bench.run_operator_binary(device="cpu", kwok_nodes=8, timeout_s=60.0)
    assert out["probe"] == {"/healthz": 200, "/readyz": 200}
    assert out["admission"]["allowed"] and out["admission"]["patch_ops"] > 0
    assert out["pods"] == 13 and out["podgangs"] >= 1
    assert out["statusz_solver"]["device"]["type"] == "cpu"
    assert out["statusz_solver"]["streaming"]["pollS"] == 0.005
    assert sum(out["launches"].values()) == 0  # the plain versions launch nothing
    assert out["exit_code"] == 0 and out["stopped_cleanly"]


_NO_JAX_PROBE = """
import atexit, json, runpy, sys
def report():
    print("MODULES " + json.dumps(sorted(m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "grove_tpu"))), flush=True)
atexit.register(report)
sys.argv = ["grove_tpu_torch.runtime"] + sys.argv[1:]
runpy.run_module("grove_tpu_torch.runtime", run_name="__main__")
"""


def test_operator_binary_runs_without_jax(tmp_path):
    """`python -m grove_tpu_torch.runtime --device cpu --run-for 4`: its
    probe answers while it runs, it exits 0, and no module of JAX or of the
    JAX package was loaded."""
    import threading

    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(local_paths({
        "log": {"format": "json"}, "servers": {"healthPort": 0, "metricsPort": -1},
        "backend": {"enabled": False}, "cluster": {"source": "kwok", "kwokNodes": 4}},
        tmp_path)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _NO_JAX_PROBE, "--config", str(cfg), "--device", "cpu",
         "--run-for", "4"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port, answered = [], []

    def watch():
        for line in proc.stderr:
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if doc.get("msg") == "manager started":
                port.append(doc["health_port"])
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{doc['health_port']}/healthz", timeout=5) as r:
                    answered.append(r.status)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    # The thread reads stderr; the only stdout line is the probe's (small).
    proc.wait(timeout=120)
    t.join(timeout=10)
    out = proc.stdout.read()
    assert proc.returncode == 0
    assert answered == [200], (port, answered)
    line = next(x for x in out.splitlines() if x.startswith("MODULES "))
    assert json.loads(line[len("MODULES "):]) == []


def test_operator_binary_refuses_to_run_without_a_card(tmp_path):
    import torch

    assert not torch.cuda.is_available()
    cfg = tmp_path / "config.yaml"
    cfg.write_text("servers:\n  healthPort: -1\n  metricsPort: -1\nbackend:\n  enabled: false\n")
    proc = subprocess.run([sys.executable, "-m", "grove_tpu_torch.runtime", "--config",
                           str(cfg), "--run-for", "1"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    cfg_doc, _ = p_parse({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PManager(cfg_doc)


def test_initc_binary_gates_on_the_port_manager(tmp_path):
    """`python -m grove_tpu_torch.initc` against the port's manager API: it
    waits while the parent clique is not Ready and exits 0 once it is."""
    import time

    cfg, errors = p_parse(local_paths({"servers": {"healthPort": 0, "metricsPort": -1},
                                       "backend": {"enabled": False}}, tmp_path))
    assert not errors
    m = PManager(cfg, device="cpu")
    m.start()
    try:
        m.apply_podcliqueset(PPCS.from_dict(simple1_doc()))
        m.reconcile_once(now=1.0)
        fqn = sorted({p.pclq_fqn for p in m.cluster.pods.values()})[0]
        proc = subprocess.Popen(
            [sys.executable, "-m", "grove_tpu_torch.initc", f"--podcliques={fqn}:1",
             "--server", f"http://127.0.0.1:{m.health_port}", "--poll-interval", "0.2",
             "--timeout", "30"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        time.sleep(1.0)
        assert proc.poll() is None, "the agent must still be gating"
        for pod in m.cluster.pods.values():
            if pod.pclq_fqn == fqn:
                pod.ready = True
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "all parent cliques ready" in out
    finally:
        m.stop()
    bad = subprocess.run([sys.executable, "-m", "grove_tpu_torch.initc", "--podcliques=bad"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_manager.py` on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_manager_equals_cpu_manager_step_by_step(cuda):
    """The scripted KWOK world under a Manager on the card and one on the
    CPU: the stores equal after every step, and the card's solves launched
    the kernel."""
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    doc = {"servers": {"healthPort": -1, "metricsPort": -1}, "backend": {"enabled": False}}
    sides = []
    for device in (cuda, "cpu"):
        cfg, _ = p_parse(copy.deepcopy(doc))
        m = PManager(cfg, device=device)
        m.controller.topology = p_wl.bench_topology()
        m.topology = m.controller.topology
        fleet = p_kwok.kwok_fleet(p_wl.synthetic_cluster(
            zones=1, blocks_per_zone=1, racks_per_block=2, hosts_per_rack=6)[:12], now=0.0)
        m.attach_watch(fleet)
        m.apply_podcliqueset(PPCS.from_dict(simple1_doc()))
        sides.append(m)
    reset_launches()
    for step in range(16):
        t = 0.5 * (step + 1)
        for m in sides:
            m.reconcile_once(now=t)
        views = [p_bench.store_view(m.cluster, m.controller) for m in sides]
        assert views[0] == views[1], t
    assert place_wave.variant_launches["dense"] >= 1
    assert sides[0].statusz()["solver"]["device"]["type"] == "cuda"
