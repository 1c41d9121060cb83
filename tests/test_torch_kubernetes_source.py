"""The port's kube-apiserver source (grove_tpu_torch/cluster/kubernetes.py),
its KubeLease and the Manager's kubernetes branches against the JAX
package's. Each package's object runs against its own FixtureApiServer
(tests/fixture_apiserver.py) through the same script; what it polled and
answered, and the fixture's state afterwards (bindings, created pods,
leases, events, services, secrets, child CRs, webhook configurations, RBAC
objects, the workload CRs and their status), are compared with timestamps,
uids, the lease holder's random identity and the per-process serving cert
aside. Where a Manager runs, the store views after every reconcile are
compared too: before each reconcile the script waits until the source has
queued every event the fixture emitted that its watches select (by
resourceVersion, not by the clock).

Scenarios, one case each for code that runs differently: the payload
translations and the manifest render, kubeconfig loading, list then watch, a
410 relist, bind and create (with the driver's retry set), the KubeLease's
acquire, renew, steal, release, stand-down and the guarded release, the
caBundle sync, the `kube.request` and `watch.disconnect` faults, and the
Manager over the wire: the workload CR watched in through the apiserver's
admission webhooks (served by the Manager, TLS pinned to the caBundle it
patched at boot), solved, bound, its status written back, a CR denied at
write, the CR deleted (services, child CRs and events mirrored); the initc
`kubernetes` mode (RBAC and service-account-token secrets); and the lease
handed over between two Managers.
"""

from __future__ import annotations

import base64
import copy
import pathlib
import threading
import time
import types

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
import yaml

from fixture_apiserver import FixtureApiServer, k8s_node
from grove_tpu_torch import bench as p_bench
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
# Keys whose values come from the wall clock, a random source or the
# process's own serving cert; everything else in the fixture is compared.
ASIDE_KEYS = frozenset({
    "uid", "creationTimestamp", "firstTimestamp", "lastTimestamp", "acquireTime",
    "renewTime", "holderIdentity", "caBundle",
})
READ_TIMEOUT_S = 1.0


def package(side: str) -> types.SimpleNamespace:
    """The modules a script needs, from the JAX package or the port."""
    import importlib

    root = {"jax": "grove_tpu", "port": "grove_tpu_torch"}[side]
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        side=side, kube=mod("cluster.kubernetes"), watch=mod("cluster.watch"),
        pod=mod("api.pod"), types=mod("api.types"), store=mod("orchestrator.store"),
        config=mod("runtime.config"), manager=mod("runtime.manager"), faults=mod("faults"),
        deploy=mod("deploy"),
        manager_kw={} if side == "jax" else {"device": "cpu"})


SIDES = ("jax", "port")


def aside(x):
    """`x` without the ASIDE_KEYS, at any depth."""
    if isinstance(x, dict):
        return {k: aside(v) for k, v in x.items() if k not in ASIDE_KEYS}
    if isinstance(x, list):
        return [aside(v) for v in x]
    if isinstance(x, tuple):
        return tuple(aside(v) for v in x)
    return x


def fixture_state(api: FixtureApiServer) -> dict:
    return aside(copy.deepcopy({
        "binding_log": api.binding_log, "created_pods": api.created_pods,
        "pods": api.pods, "leases": api.leases, "events": api.events,
        "services": api.services, "secrets": api.secrets, "child_crs": api.child_crs,
        "webhookconfigs": api.webhookconfigs, "rbac_objects": api.rbac_objects,
        "podcliquesets": api.podcliquesets, "clustertopologies": api.clustertopologies,
        "admission_denials": api.admission_denials,
    }))


def event_view(events) -> list:
    return [(str(e.type), e.kind, e.name, aside(e.obj)) for e in events]


class WatchLedger:
    """What each source's reader threads have queued, per watched kind: the
    highest resourceVersion among the objects its lists and watch streams
    handed to `_emit` (noted after the event is queued) and the
    resourceVersion of its last list. Installed on both packages' source
    classes for a script's run."""

    def __init__(self):
        self.seen: dict = {}
        self.lock = threading.Lock()

    def note(self, src, kind: str, rv) -> None:
        try:
            rv = int(rv)
        except (TypeError, ValueError):
            return
        with self.lock:
            key = (id(src), kind)
            self.seen[key] = max(self.seen.get(key, 0), rv)

    def install(self, monkeypatch, kube) -> None:
        cls = kube.KubernetesWatchSource
        real_list, real_emit = cls._list, cls._emit
        ledger = self

        def _list(src, rw, known):
            rv, names = real_list(src, rw, known)
            ledger.note(src, rw.kind, rv)
            return rv, names

        def _emit(src, etype, kind, name, obj):
            real_emit(src, etype, kind, name, obj)
            ledger.note(src, kind, ((obj or {}).get("metadata") or {}).get("resourceVersion"))

        monkeypatch.setattr(cls, "_list", _list)
        monkeypatch.setattr(cls, "_emit", _emit)


def settle(api: FixtureApiServer, src, limit_s: float = 30.0) -> None:
    """Wait until `src` has queued every event the fixture emitted that its
    watches select: for each watched kind, the ledger's resourceVersion
    reaches the fixture's last matching event (a list covers what came
    before it)."""
    ledger = api.ledger
    deadline = time.monotonic() + limit_s
    while True:
        with api._lock:
            want = {rw.kind: max((tag for tag, ev in api._event_log.get(
                rw.list_path.rsplit("/", 1)[-1], []) if api._matches(ev["object"], rw.selector)),
                default=0) for rw in src._watches}
        with ledger.lock:
            seen = {kind: ledger.seen.get((id(src), kind)) for kind in want}
        if all(seen[k] is not None and seen[k] >= want[k] for k in want):
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"the watch did not settle: want {want}, queued {seen}; "
                                 f"source errors {src.errors}")
        time.sleep(0.005)


def watches_live(api, resources=("nodes", "pods"), limit_s: float = 20.0) -> None:
    """Wait until every one of `resources` has a watch stream registered at
    the fixture (after a dropped stream: the informer has relisted and
    resumed)."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        with api._lock:
            if all(api._watchers[r] for r in resources):
                return
        time.sleep(0.01)
    raise AssertionError("the watch streams did not come back")


def source(pkg, api, **kw):
    return pkg.kube.KubernetesWatchSource(
        pkg.kube.KubeContext(server=api.url, namespace="default"),
        watch_read_timeout_s=READ_TIMEOUT_S, **kw)


def run_both(script, *args) -> dict:
    """`script(pkg, api, *args)` for each package against a fresh fixture;
    {side: (its result, the fixture's state after it)}."""
    out = {}
    for side in SIDES:
        pkg = package(side)
        api = FixtureApiServer()
        api.ledger = WatchLedger()
        try:
            with pytest.MonkeyPatch.context() as mp:
                api.ledger.install(mp, pkg.kube)
                got = script(pkg, api, *args)
            out[side] = (got, fixture_state(api))
        finally:
            api.close()
    return out


def assert_equal_sides(out: dict) -> None:
    (r_got, r_state), (p_got, p_state) = out["jax"], out["port"]
    assert p_got == r_got
    for key in r_state:
        assert p_state[key] == r_state[key], key


# ---- the source, scripted ----------------------------------------------------------


def _payloads(pkg, api):
    obj = k8s_node("n0", cpu="7500m", memory="64Gi", labels={"topology.kubernetes.io/rack": "r1"},
                   unschedulable=True, taints=[{"key": "k", "effect": "NoSchedule"}], tpu="4")
    pods = [
        {"metadata": {"name": "p0"}, "spec": {"nodeName": "n3"},
         "status": {"phase": "Running", "conditions": [{"type": "Ready", "status": "True"}]}},
        {"metadata": {"name": "p"}},
    ]
    pod = pkg.pod.Pod(
        name="w0", namespace="elsewhere",
        labels={"app.kubernetes.io/managed-by": "grove-tpu-operator"},
        spec=pkg.types.PodSpec.from_dict({
            "containers": [{"name": "main", "image": "img",
                            "resources": {"requests": {"cpu": "500m", "memory": "1Gi"}},
                            "volumeMounts": [{"name": "data", "mountPath": "/data"}]}],
            "initContainers": [{"name": "grove-initc", "image": "initc:latest"}],
            "volumes": [{"name": "data", "emptyDir": {}}],
        }),
        pclq_fqn="w-0-main", pod_index=3)
    pod.node_name = "n1"
    return [pkg.kube.node_payload(obj), [pkg.kube.pod_payload(p) for p in pods],
            pkg.kube.render_pod_manifest(pod)]


def _kubeconfig(pkg, api, tmp):
    ca_pem = "-----BEGIN CERTIFICATE-----\nZZZZ\n-----END CERTIFICATE-----\n"
    doc = {
        "apiVersion": "v1", "kind": "Config", "current-context": "dev",
        "clusters": [{"name": "c1", "cluster": {
            "server": "https://10.1.2.3:6443/",
            "certificate-authority-data": base64.b64encode(ca_pem.encode()).decode()}}],
        "users": [{"name": "u1", "user": {"token": "sekret"}}],
        "contexts": [{"name": "dev", "context": {"cluster": "c1", "user": "u1",
                                                  "namespace": "infer"}}],
    }
    path = tmp / "kubeconfig"
    path.write_text(yaml.safe_dump(doc))
    ctx = pkg.kube.load_kube_context(str(path))
    try:
        pkg.kube.load_kube_context(str(path), context_name="nope")
        missing = None
    except ValueError as e:
        missing = str(e)
    return [ctx.server, ctx.token, ctx.ca_pem, ctx.namespace, missing]


def _list_then_watch(pkg, api):
    api.add_node(k8s_node("n0"))
    api.add_node(k8s_node("n1", unschedulable=True))
    src = source(pkg, api, watch_workloads=False)
    src.start()
    try:
        settle(api, src)
        listed = sorted(event_view(src.poll(0.0)))
        api.update_node("n0", lambda n: n["spec"].update(unschedulable=True))
        api.add_node(k8s_node("n2"))
        api.delete_node("n1")
        settle(api, src)
        watched = event_view(src.poll(0.0))
        return [listed, watched, src.watch_stats(), src.errors]
    finally:
        src.stop()


def _relist_410(pkg, api):
    api.add_node(k8s_node("n0"))
    api.fail_watch_once(410)
    src = source(pkg, api, watch_workloads=False)
    src.start()
    try:
        deadline = time.monotonic() + 20.0
        while src.watch_stats()["resyncs"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        watches_live(api)
        settle(api, src)
        # Which stream took the 410 is up to the threads: what was listed,
        # not how often, is compared.
        first = sorted({e[:3] for e in event_view(src.poll(0.0))})
        api.add_node(k8s_node("n9"))
        settle(api, src)
        return [first, event_view(src.poll(0.0)), src.watch_stats()]
    finally:
        src.stop()


def _bind_and_create(pkg, api):
    store_pod = pkg.pod.Pod(
        name="simple1-0-frontend-abc12",
        labels={"app.kubernetes.io/managed-by": "grove-tpu-operator"},
        spec=pkg.types.PodSpec.from_dict({"containers": [{
            "name": "frontend", "image": "registry.local/frontend:latest",
            "resources": {"requests": {"cpu": "500m"}}}]}),
        pclq_fqn="simple1-0-frontend", pod_index=0)
    src = source(pkg, api, pod_manifest_for=lambda name: pkg.kube.render_pod_manifest(
        store_pod) if name == store_pod.name else None)
    out = [src.observe_binding(store_pod.name, "n7", now=0.0),
           src.observe_binding(store_pod.name, "n7", now=1.0)]
    src.observe_deletion(store_pod.name, now=2.0)
    src.observe_deletion(store_pod.name, now=3.0)  # already gone: no error
    out.append(list(src.errors))
    # The driver's retry set: no manifest and no pod at the fixture, the
    # binding POST 404s and the placement stays pending; once the pod exists
    # the retry lands.
    c = pkg.store.Cluster()
    pod = pkg.pod.Pod(name="p0", spec=pkg.types.PodSpec.from_dict(
        {"containers": [{"name": "x", "image": "img"}]}))
    pod.node_name = "n1"
    c.pods[pod.name] = pod
    bare = source(pkg, api, pod_manifest_for=lambda name: None)
    driver = pkg.watch.WatchDriver(cluster=c, source=bare)
    out.append([driver.push(now=0.0), pod.name in driver._pushed_bindings, len(bare.errors)])
    api.pods["p0"] = {"apiVersion": "v1", "kind": "Pod",
                      "metadata": {"name": "p0", "labels": {}}, "spec": {}, "status": {}}
    out.append([driver.push(now=1.0), pod.name in driver._pushed_bindings])
    return out


def _lease(pkg, api):
    kube = pkg.kube
    ctx = kube.KubeContext(server=api.url, namespace="default")
    a = kube.KubeLease(ctx, lease_duration_seconds=10.0, identity="a")
    b = kube.KubeLease(ctx, lease_duration_seconds=10.0, identity="b")
    out = [a.try_acquire(now=100.0), b.try_acquire(now=101.0), a.try_acquire(now=105.0),
           b.try_acquire(now=115.1), a.try_acquire(now=116.0)]
    holders = [api.leases["grove-tpu-operator-leader"]["spec"]["holderIdentity"]]
    b.release()
    c = kube.KubeLease(ctx, name="handover", lease_duration_seconds=60.0, identity="c")
    d = kube.KubeLease(ctx, name="handover", lease_duration_seconds=60.0, identity="d")
    out += [c.try_acquire(now=0.0), d.try_acquire(now=1.0)]
    c.release()
    out.append(d.try_acquire(now=2.0))
    e = kube.KubeLease(ctx, name="deadline", lease_duration_seconds=30.0,
                       renew_deadline_seconds=5.0, identity="e")
    f = kube.KubeLease(ctx, name="deadline", lease_duration_seconds=30.0, identity="f")
    out += [e.try_acquire(now=0.0), e.try_acquire(now=6.0), f.try_acquire(now=7.0)]
    # The guarded release: a stale holder's release leaves its successor's
    # lease, and a delete under a stale resourceVersion is refused.
    g = kube.KubeLease(ctx, name="race", lease_duration_seconds=5.0, identity="g")
    h = kube.KubeLease(ctx, name="race", lease_duration_seconds=5.0, identity="h")
    out += [g.try_acquire(now=0.0), h.try_acquire(now=6.0)]
    g.release()
    holders += [api.leases[n]["spec"].get("holderIdentity")
                for n in ("handover", "deadline", "race")]
    try:
        h._req("DELETE", f"{h._path}/{h.name}", {"preconditions": {"resourceVersion": "stale"}})
        refused = None
    except kube.KubeApiError as err:
        refused = err.status
    return [out, holders, refused, sorted(api.leases)]


def _webhook_ca(pkg, api):
    for doc in pkg.deploy._render_webhook_objects("grove-system", authorizer=True):
        plural = doc["kind"].lower() + "s"
        if plural in api.webhookconfigs:
            api.webhookconfigs[plural][doc["metadata"]["name"]] = doc
    src = source(pkg, api)
    ca = b"-----BEGIN CERTIFICATE-----\nabc\n-----END CERTIFICATE-----\n"
    out = [src.sync_webhook_ca(ca), src.sync_webhook_ca(ca)]
    bundles = [wh["clientConfig"]["caBundle"] for plural in sorted(api.webhookconfigs)
               for obj in api.webhookconfigs[plural].values() for wh in obj["webhooks"]]
    for plural in api.webhookconfigs:
        api.webhookconfigs[plural].clear()
    out += [src.sync_webhook_ca(ca), bundles, len(src.errors)]
    return out


def _kube_request_fault(pkg, api):
    """`kube.request` answering 500 on the first call: the bind's in-call
    retry lands it on the second attempt."""
    faults = pkg.faults
    injector = faults.FaultInjector(
        {"kube.request": faults.SiteSpec(kind="http500", count=1)}, seed=7)
    store_pod = pkg.pod.Pod(
        name="f0", labels={"app.kubernetes.io/managed-by": "grove-tpu-operator"},
        spec=pkg.types.PodSpec.from_dict({"containers": [{"name": "x", "image": "img"}]}))
    src = source(pkg, api, bind_retry_attempts=3, backoff_base_s=0.001, backoff_cap_s=0.002,
                 pod_manifest_for=lambda name: pkg.kube.render_pod_manifest(store_pod))
    faults.install(injector)
    try:
        ok = src.observe_binding("f0", "n2", now=0.0)
    finally:
        faults.install(None)
    return [ok, src.bind_retries, len(src.errors), injector.stats()]


def _watch_disconnect_fault(pkg, api):
    """`watch.disconnect` dropping the first watch stream: the informer
    resubscribes (counted) and every node still streams in."""
    faults = pkg.faults
    injector = faults.FaultInjector(
        {"watch.disconnect": faults.SiteSpec(kind="disconnect", count=1)}, seed=7)
    api.add_node(k8s_node("n0"))
    src = source(pkg, api, watch_workloads=False)
    faults.install(injector)
    try:
        src.start()
        deadline = time.monotonic() + 20.0
        while src.watch_stats()["reconnects"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        watches_live(api)
        settle(api, src)
        first = sorted({e[:3] for e in event_view(src.poll(0.0))})
        api.add_node(k8s_node("n1"))
        settle(api, src)
        return [first, event_view(src.poll(0.0)), src.watch_stats(),
                injector.stats()["sites"]["watch.disconnect"]["fired"]]
    finally:
        src.stop()
        faults.install(None)


SOURCE_SCRIPTS = {
    "payloads": _payloads,
    "list-then-watch": _list_then_watch,
    "relist-410": _relist_410,
    "bind-and-create": _bind_and_create,
    "lease": _lease,
    "webhook-ca": _webhook_ca,
    "fault-kube-request": _kube_request_fault,
    "fault-watch-disconnect": _watch_disconnect_fault,
}


@pytest.mark.parametrize("name", sorted(SOURCE_SCRIPTS))
def test_source_scripts_equal(name):
    out = run_both(SOURCE_SCRIPTS[name])
    assert_equal_sides(out)
    got, state = out["port"]
    if name == "list-then-watch":
        assert [e[2] for e in got[0]] == ["n0", "n1"] and len(got[1]) == 3
    elif name == "relist-410":
        assert got[2]["resyncs"] == 1 and [e[2] for e in got[1]] == ["n9"]
    elif name == "bind-and-create":
        assert got[:3] == [True, True, []] and got[3][0] == 0 and got[4] == [1, True]
        assert state["binding_log"] == [("simple1-0-frontend-abc12", "n7"), ("p0", "n1")]
    elif name == "lease":
        assert got[0] == [True, False, True, True, False, True, False, True, True, False, True,
                          True, True]
        assert got[2] == 409
    elif name == "fault-kube-request":
        assert got[0] is True and got[1] == 1 and got[3]["sites"]["kube.request"]["fired"] == 1
    elif name == "fault-watch-disconnect":
        assert got[2]["reconnects"] >= 1 and got[3] == 1 and [e[2] for e in got[1]] == ["n1"]


def test_kubeconfig_loading_equal(tmp_path):
    out = run_both(_kubeconfig, tmp_path)
    assert_equal_sides(out)
    got = out["port"][0]
    assert got[:2] == ["https://10.1.2.3:6443", "sekret"] and got[3] == "infer"
    assert "context 'nope' not found" in got[4]


# ---- the Manager over the wire -----------------------------------------------------------


def kubeconfig_for(api, root: pathlib.Path) -> str:
    path = root / "kubeconfig"
    path.write_text(yaml.safe_dump({
        "current-context": "fixture",
        "clusters": [{"name": "c", "cluster": {"server": api.url}}],
        "users": [{"name": "u", "user": {"token": "fixture-token"}}],
        "contexts": [{"name": "fixture", "context": {"cluster": "c", "user": "u"}}],
    }))
    return str(path)


def manager_for(pkg, api, root: pathlib.Path, *, webhook=False, initc_kube=False,
                leader=False):
    """A started Manager of `pkg` on `cluster.source: kubernetes` against
    `api`, every path it writes under `root`."""
    root.mkdir(parents=True, exist_ok=True)
    doc = {
        "servers": {"healthPort": -1, "metricsPort": -1, "webhookPort": 0 if webhook else -1,
                    "tlsCertDir": str(root / "certs")},
        "backend": {"enabled": False},
        "solver": {"shapeHistoryPath": str(root / "solve-shapes.json")},
        "persistence": {"path": str(root / "state.json")},
        "leaderElection": {"enabled": leader, "leaseDurationSeconds": 2.0,
                           "renewDeadlineSeconds": 1.5, "leaseFile": str(root / "lease")},
        "cluster": {"source": "kubernetes", "kubeconfig": kubeconfig_for(api, root),
                    **({"initcMode": "kubernetes"} if initc_kube else {})},
    }
    cfg, errors = pkg.config.parse_operator_config(doc)
    assert not errors, errors
    m = pkg.manager.Manager(cfg, **pkg.manager_kw)
    m.start()
    return m


def fleet(api, n=10, **kw):
    for i in range(n):
        api.add_node(k8s_node(f"n{i}", labels={
            "topology.kubernetes.io/zone": "z0", "topology.kubernetes.io/block": "b0",
            "topology.kubernetes.io/rack": f"r{i % 2}"}, **kw))


def example(name: str) -> dict:
    return yaml.safe_load((REPO / "examples" / name).read_text())


def kubelet(api) -> None:
    """Advance every bound pod that is not Ready one hop."""
    for name, pod in sorted(api.pods.items()):
        if pod.get("spec", {}).get("nodeName"):
            conds = pod.get("status", {}).get("conditions", [])
            if not any(c["type"] == "Ready" and c["status"] == "True" for c in conds):
                api.advance_pod(name)


def step(m, api, t: float, views: list) -> None:
    settle(api, m._kube_source)
    outcome = m.reconcile_once(now=t)
    views.append((t, p_bench.store_view(m.cluster, m.controller), outcome.has_errors))
    settle(api, m._kube_source)


def _cr_loop(pkg, api, root):
    """simple1 as a CR through the apiserver's admission webhooks (served
    by the Manager, TLS pinned to the caBundle it patched at boot), watched
    in, solved, bound, made Ready, its status written back; a CR denied at
    write; the CR deleted."""
    fleet(api, cpu="4", memory="16Gi")
    for doc in pkg.deploy._render_webhook_objects("grove-system"):
        plural = doc["kind"].lower() + "s"
        if plural in api.webhookconfigs:
            api.webhookconfigs[plural][doc["metadata"]["name"]] = doc
    m = manager_for(pkg, api, root / pkg.side, webhook=True)
    views, t = [], 0.0
    try:
        ca = base64.b64encode(m.webhook_ca_bundle()).decode()
        patched = sorted({wh["clientConfig"]["caBundle"] == ca
                          for objs in api.webhookconfigs.values() for obj in objs.values()
                          for wh in obj["webhooks"]})
        api.webhook_service_urls["grove-tpu-operator-webhook"] = (
            f"https://127.0.0.1:{m.webhook_port}")
        api.apply_pcs(example("simple1.yaml"))
        bad = example("simple1.yaml")
        bad["metadata"]["name"] = "bad1"
        bad["spec"]["template"]["cliques"][0]["spec"]["startsAfter"] = ["frontend"]
        api.apply_pcs(bad)
        for _ in range(7):
            t += 1.0
            step(m, api, t, views)
            kubelet(api)
        status = copy.deepcopy(api.podcliquesets["simple1"].get("status", {}))
        mirrored = {"services": sorted(api.services), "secrets": sorted(api.secrets),
                    **{k: sorted(v) for k, v in api.child_crs.items()}}
        api.delete_pcs("simple1")
        for _ in range(3):
            t += 1.0
            step(m, api, t, views)
        events = list(m.cluster.events)
    finally:
        m.stop()
    return {"views": views, "seen": [patched, aside(status), mirrored, len(events)]}


def _initc_kubernetes(pkg, api, root):
    """cluster.initcMode kubernetes: the per-PCS ServiceAccount, Role and
    RoleBinding mirrored, the token Secret a service-account-token, the
    gated pods' init container on --kube."""
    fleet(api, n=8, cpu="16", memory="64Gi", tpu="8")
    m = manager_for(pkg, api, root / pkg.side, initc_kube=True)
    views = []
    try:
        api.apply_pcs(example("explicit-startup-order.yaml"))
        for t in (1.0, 2.0, 3.0):
            step(m, api, t, views)
            kubelet(api)
    finally:
        m.stop()
    return {"views": views, "seen": []}


def _lease_handover(pkg, api, root):
    """Two Managers under one KubeLease: the second stands by, and the
    first's stop hands the lease over."""
    fleet(api, n=2, cpu="8", memory="32Gi")
    m1 = manager_for(pkg, api, root / pkg.side / "m1", leader=True)
    m2 = manager_for(pkg, api, root / pkg.side / "m2", leader=True)
    try:
        seen = [m1._is_leader, m2._is_leader,
                api.leases["grove-tpu-operator-leader"]["spec"]["holderIdentity"]
                == m1._lease.identity]
        m1.stop()
        seen.append(api.leases.get("grove-tpu-operator-leader", {}).get("spec", {}).get(
            "holderIdentity"))
        seen.append(m2._lease.try_acquire())
        seen.append(api.leases["grove-tpu-operator-leader"]["spec"]["holderIdentity"]
                    == m2._lease.identity)
    finally:
        m1.stop()
        m2.stop()
    return {"views": [], "seen": seen}


MANAGER_SCRIPTS = {
    "cr-loop": _cr_loop,
    "initc-kubernetes": _initc_kubernetes,
    "lease-handover": _lease_handover,
}


@pytest.mark.parametrize("name", sorted(MANAGER_SCRIPTS))
def test_manager_over_the_wire_equal(name, tmp_path):
    out = run_both(MANAGER_SCRIPTS[name], tmp_path)
    want, got = out["jax"][0], out["port"][0]
    assert len(got["views"]) == len(want["views"])
    for (t, r_view, r_err), (_, p_view, p_err) in zip(want["views"], got["views"]):
        assert p_err == r_err, t
        if p_view != r_view:
            first = next(k for k in r_view if r_view[k] != p_view.get(k))
            raise AssertionError(f"t={t}: the stores differ first at {first}")
    assert_equal_sides(out)
    state = out["port"][1]
    if name == "cr-loop":
        patched, status, mirrored, events = got["seen"]
        assert patched == [True]
        assert len(state["binding_log"]) == 13 == max(len(dict(v[1]["pods"]))
                                                     for v in got["views"])
        assert status["availableReplicas"] == 1
        assert {s["name"] for s in status["podGangStatuses"]} == {
            "simple1-0", "simple1-0-workers-0"}
        assert "bad1" not in state["podcliquesets"] and state["admission_denials"]
        assert mirrored["services"] and mirrored["podcliques"] and events
        assert dict(got["views"][-1][1]["pods"]) == {} and state["child_crs"]["podcliques"] == {}
        assert state["clustertopologies"]["grove-topology"]["spec"]["levels"]
    elif name == "initc-kubernetes":
        assert state["pods"] and all(state["rbac_objects"].values())
        assert {s["type"] for s in state["secrets"].values()} == {
            "kubernetes.io/service-account-token"}
        gated = [p for p in state["pods"].values() if p["spec"].get("initContainers")]
        assert gated and all("--kube" in p["spec"]["initContainers"][0]["args"] for p in gated)
    else:
        assert got["seen"] == [True, False, True, None, True, True]
