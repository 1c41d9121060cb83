"""The port's GREP-375 sidecar (grove_tpu_torch/backend/service.py) against
the JAX package's, in-process on the CPU's plain versions.

Every RPC of a sequence goes to a JAX `TPUSchedulerBackend` and to the
port's (`device="cpu"`) with the same request messages (the two packages'
byte-identical descriptors share one pool, so one message class serves
both), and every response must be equal: a `SolveResponse` field for field
(admitted, bindings in order, `placement_score` as the f32 the wire
carries), `solve_micros` aside. The sequences are those of
tests/test_backend.py and tests/test_backend_hardening.py: the full cycle,
node selectors, taints and tolerations, sibling spread, bucketed shapes,
gangs deleted, re-synced, cordoned or losing a node mid-solve, oversized
set counts, priority order, the deprecated speculative flag, portfolio
escalation with its damper, and the metric counters.
"""

from __future__ import annotations

import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.backend import service as r_service
from grove_tpu.runtime.config import SolverConfig as RSolverConfig
from grove_tpu.utils.metrics import Registry as RRegistry
from grove_tpu_torch.backend import service as p_service
from grove_tpu_torch.backend.proto import scheduler_backend_pb2 as pb
from grove_tpu_torch.runtime.config import SolverConfig as PSolverConfig
from grove_tpu_torch.utils.metrics import Registry as PRegistry
from test_backend import RACK, ZONE, _gang, _nodes
from test_backend_hardening import _Ctx, _gang_spec
from torch_jax_programs import _release_jax_programs  # noqa: F401


def plain(resp):
    """A response as comparable data: a SolveResponse without its wall clock."""
    out = type(resp)()
    out.CopyFrom(resp)
    if isinstance(out, pb.SolveResponse):
        out.solve_micros = 0
    return out


class Twin:
    """A JAX sidecar and the port's, driven with the same requests."""

    def __init__(self, metrics: bool = False, **cfg) -> None:
        self.r_reg = RRegistry() if metrics else None
        self.p_reg = PRegistry() if metrics else None
        self.jax = r_service.TPUSchedulerBackend(
            solver_config=RSolverConfig(**cfg), metrics=self.r_reg)
        self.port = p_service.TPUSchedulerBackend(
            solver_config=PSolverConfig(**cfg), metrics=self.p_reg, device="cpu")

    def call(self, method: str, req):
        """Both sidecars answer `req`; the answers must be equal. Returns
        the port's."""
        r = getattr(self.jax, method)(req, _Ctx())
        p = getattr(self.port, method)(req, _Ctx())
        assert plain(p) == plain(r), (method, p, r)
        return p

    def both(self):
        return self.jax, self.port

    # The RPCs of tests/test_backend.py's client, as requests.
    def init(self, topology, priority_classes=None):
        req = pb.InitRequest(topology=[pb.TopologyLevel(domain=d, node_label_key=k)
                                       for d, k in topology])
        for name, value in (priority_classes or {}).items():
            req.priority_classes[name] = value
        return self.call("Init", req)

    def update_cluster(self, nodes, full_replace=False):
        return self.call("UpdateCluster", pb.UpdateClusterRequest(nodes=nodes,
                                                                  full_replace=full_replace))

    def sync(self, spec):
        return self.call("SyncPodGang", pb.SyncPodGangRequest(pod_gang=spec))

    def delete(self, name):
        return self.call("OnPodGangDelete", pb.OnPodGangDeleteRequest(name=name,
                                                                      namespace="default"))

    def release(self, pods):
        return self.call("ReleasePods", pb.ReleasePodsRequest(pod_names=pods))

    def solve(self, **kw):
        return self.call("Solve", pb.SolveRequest(**kw))


def bench_twin(nodes=16, **cfg) -> Twin:
    """tests/test_backend_hardening.py's `_backend` on both sidecars: the
    bench topology and `nodes` 16-cpu nodes, 4 to a rack, 8 to a block."""
    from grove_tpu_torch.sim.workloads import bench_topology

    t = Twin(**cfg)
    t.init([(lv.domain.value, lv.node_label_key) for lv in bench_topology().levels])
    req = pb.UpdateClusterRequest(full_replace=True)
    for i in range(nodes):
        n = req.nodes.add()
        n.name = f"n{i}"
        n.schedulable = True
        for res, val in (("cpu", 16.0), ("memory", 64.0 * 2**30)):
            q = n.capacity.add()
            q.name = res
            q.value = val
        n.labels["topology.gke.io/zone"] = "z0"
        n.labels["topology.gke.io/block"] = f"b{i // 8}"
        n.labels["topology.gke.io/rack"] = f"r{i // 4}"
    t.call("UpdateCluster", req)
    return t


def admitted(resp) -> dict:
    return {g.name: g for g in resp.gangs if g.admitted}


# ---- tests/test_backend.py's cycle ---------------------------------------------------


def test_full_cycle_equals_jax():
    """Init, UpdateCluster, PreparePod, ValidatePodCliqueSet, a rack-packed
    gang bound whole, the release and its incremental re-solve, an
    all-or-nothing rejection, a scaled gang waiting for its base, and the
    deletes that free the fleet for a big gang: every answer equal."""
    t = Twin()
    assert t.init([("zone", ZONE), ("rack", RACK)]).name == "grove-tpu"
    assert t.update_cluster(_nodes(8), full_replace=True).node_count == 8
    t.call("PreparePod", pb.PreparePodRequest(pod_name="mypod", pod_gang_name="g1"))
    t.call("PreparePod", pb.PreparePodRequest(pod_name="other"))
    good = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata: {name: ok}
spec:
  replicas: 1
  template:
    cliques:
      - name: a
        spec:
          roleName: a
          replicas: 2
          podSpec: {containers: [{name: c, image: i}]}
"""
    for doc in (good, good.replace("replicas: 2", "replicas: 2\n          minAvailable: 5"),
                "{not a pcs"):
        t.call("ValidatePodCliqueSet", pb.ValidatePodCliqueSetRequest(pcs_yaml=doc))

    t.sync(_gang("g1", rack_required=True))
    resp = t.solve()
    assert resp.gangs[0].admitted and len(resp.gangs[0].bindings) == 6
    t.solve()  # nothing pending
    t.release(["g1-alpha-0"])
    resp = t.solve()
    assert [b.pod_name for b in admitted(resp)["g1"].bindings] == ["g1-alpha-0"]
    t.sync(_gang("g2", pods_per_group=40, min_replicas=40))
    assert "g2" not in admitted(t.solve())
    t.sync(_gang("g3-scaled", base="g3-base"))
    t.solve()
    t.sync(_gang("g3-base"))
    t.solve()
    t.solve()
    for name in ("g1", "g2", "g3-base", "g3-scaled"):
        t.delete(name)
    t.sync(_gang("g4", pods_per_group=8, min_replicas=8))
    assert len(admitted(t.solve())["g4"].bindings) == 16


def test_node_selector_equals_jax():
    t = Twin()
    t.init([("zone", ZONE), ("rack", RACK)])
    nodes = _nodes(8)
    for i, n in enumerate(nodes):
        n.labels["pool"] = "tpu" if i >= 6 else "cpu"
    t.update_cluster(nodes, full_replace=True)
    spec = _gang("gsel", pods_per_group=2, min_replicas=2)
    spec.pod_groups[0].node_selector["pool"] = "tpu"
    t.sync(spec)
    got = admitted(t.solve())["gsel"]
    assert {b.node_name for b in got.bindings if "alpha" in b.pod_name} <= {"n6", "n7"}


def test_taints_and_tolerations_equal_jax():
    t = Twin()
    t.init([("zone", ZONE), ("rack", RACK)])
    nodes = _nodes(8)
    for n in nodes[:6]:
        n.taints.append(pb.Taint(key="dedicated", value="infer", effect="NoSchedule"))
    t.update_cluster(nodes, full_replace=True)
    t.sync(_gang("gtaint", pods_per_group=2, min_replicas=2))
    assert {b.node_name for b in admitted(t.solve())["gtaint"].bindings} <= {"n6", "n7"}
    spec = _gang("gtol", pods_per_group=3, min_replicas=3)
    for grp in spec.pod_groups:
        grp.tolerations.append(pb.Toleration(key="dedicated", operator="Equal", value="infer",
                                             effect="NoSchedule"))
    t.sync(spec)
    got = admitted(t.solve())["gtol"]
    assert any(b.node_name not in ("n6", "n7") for b in got.bindings)


def test_sibling_spread_equals_jax():
    t = Twin()
    t.init([("zone", ZONE), ("rack", RACK)])
    nodes = []
    for z in range(2):
        for h in range(3):
            n = pb.Node(name=f"z{z}h{h}", schedulable=True)
            n.capacity.append(pb.ResourceQuantity(name="cpu", value=16))
            n.capacity.append(pb.ResourceQuantity(name="memory", value=8 * 2**30))
            n.labels[ZONE] = f"z{z}"
            n.labels[RACK] = f"r{z}"
            nodes.append(n)
    t.update_cluster(nodes, full_replace=True)

    def gang(name, replica):
        spec = pb.PodGangSpec(name=name, namespace="default", spread_key=ZONE, pcs_name="spr",
                              pcs_replica_index=replica)
        grp = pb.PodGroup(name=f"{name}-w", min_replicas=2)
        for i in range(2):
            grp.pod_references.append(pb.NamespacedName(namespace="default",
                                                        name=f"{name}-w-{i}"))
        grp.per_pod_requests.append(pb.ResourceQuantity(name="cpu", value=1))
        spec.pod_groups.append(grp)
        return spec

    t.sync(gang("spr-0", 0))
    z0 = {b.node_name[:2] for b in admitted(t.solve())["spr-0"].bindings}
    t.sync(gang("spr-1", 1))
    z1 = {b.node_name[:2] for b in admitted(t.solve())["spr-1"].bindings}
    assert len(z0) == 1 and z1 and z1.isdisjoint(z0)


def test_metric_counters_equal_jax():
    """The sidecar's counters (solves, admitted, rejected, pods bound, launch
    cache hits and misses, encode rows reused) render equal; only the
    solve-seconds histogram's buckets and sum carry wall time."""
    t = Twin(metrics=True)
    t.init([("zone", ZONE), ("rack", RACK)])
    t.update_cluster(_nodes(8), full_replace=True)
    t.sync(_gang("gm"))
    t.sync(_gang("gbig", pods_per_group=40, min_replicas=40))
    t.solve()
    t.release(["gm-alpha-0"])
    t.solve()
    t.solve()

    def counters(reg):
        return [ln for ln in reg.render_text().splitlines()
                if not ln.startswith("#") and (
                    not ln.startswith("grove_backend_solve_seconds_")
                    or ln.startswith("grove_backend_solve_seconds_count"))]

    assert counters(t.p_reg) == counters(t.r_reg)
    text = t.p_reg.render_text()
    assert "grove_backend_solves_total 3" in text  # gbig stays pending
    assert "grove_backend_pods_bound_total 7" in text
    assert "grove_backend_gangs_rejected_total 3" in text
    assert "grove_backend_encode_reuse_hits_total" in text


# ---- tests/test_backend_hardening.py's cases ---------------------------------------------


def test_bucketed_shapes_reuse_the_prepared_launch():
    """Drifting pending-set sizes inside one bucket prepare nothing new on
    the port (launch cache misses unchanged), as they compile nothing new
    in JAX."""
    from grove_tpu.solver.core import solve_batch as r_solve_batch

    t = bench_twin(pad_gangs_to=8)
    t.sync(_gang_spec("a", n_pods=2))
    t.solve()
    jax_before = r_solve_batch._cache_size()
    misses = t.port._warm.executables.misses
    for i, pods in enumerate((1, 2, 2)):
        t.sync(_gang_spec(f"x{i}", n_pods=pods))
    assert set(admitted(t.solve())) == {"x0", "x1", "x2"}
    assert t.port._warm.executables.misses == misses
    assert r_solve_batch._cache_size() == jax_before


def test_sync_not_blocked_by_an_inflight_solve(monkeypatch):
    """A SyncPodGang lands while the port's device phase is parked on a
    worker thread, and the parked Solve then commits as the JAX sidecar's
    does."""
    t = bench_twin()
    t.sync(_gang_spec("slow", n_pods=2))
    release, entered = threading.Event(), threading.Event()
    orig = t.port._solve_unlocked

    def slow_solve(work):
        entered.set()
        assert release.wait(timeout=30), "test deadlock"
        return orig(work)

    monkeypatch.setattr(t.port, "_solve_unlocked", slow_solve)
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "resp", t.port.Solve(pb.SolveRequest(), _Ctx())))
    th.start()
    try:
        assert entered.wait(timeout=30)
        t0 = time.perf_counter()
        t.port.SyncPodGang(pb.SyncPodGangRequest(pod_gang=_gang_spec("fast")), _Ctx())
        assert time.perf_counter() - t0 < 5.0
    finally:
        release.set()
        th.join(timeout=60)
    assert not th.is_alive()
    ref = t.jax.Solve(pb.SolveRequest(), _Ctx())
    t.jax.SyncPodGang(pb.SyncPodGangRequest(pod_gang=_gang_spec("fast")), _Ctx())
    assert plain(out["resp"]) == plain(ref)
    t.solve()  # both then place "fast" the same way


def _hook_both(monkeypatch, t, after):
    """Run `after(backend, solved)` on each sidecar between its device
    phase and its commit."""
    for b in t.both():
        orig = b._solve_unlocked

        def hooked(work, b=b, orig=orig):
            out = orig(work)
            after(b, out)
            return out

        monkeypatch.setattr(b, "_solve_unlocked", hooked)


def test_gang_deleted_mid_solve_not_committed(monkeypatch):
    t = bench_twin()
    t.sync(_gang_spec("doomed", n_pods=2))
    _hook_both(monkeypatch, t, lambda b, out: b.OnPodGangDelete(
        pb.OnPodGangDeleteRequest(name="doomed"), _Ctx()))
    resp = t.solve()
    assert not [g for g in resp.gangs if g.name == "doomed"] and not t.port._bindings


def test_node_removed_mid_solve_drops_the_whole_gang(monkeypatch):
    t = bench_twin()
    t.sync(_gang_spec("g", n_pods=2))
    fired = set()

    def shrink(b, out):
        if b in fired:
            return
        fired.add(b)
        victim = sorted(set(out[0]["g"].values()))[0]
        req = pb.UpdateClusterRequest(full_replace=True)
        for name, node in b._nodes.items():
            if name == victim:
                continue
            n = req.nodes.add()
            n.name = name
            n.schedulable = node.schedulable
            for res, val in node.capacity.items():
                q = n.capacity.add()
                q.name = res
                q.value = val
            n.labels.update(node.labels)
        b.UpdateCluster(req, _Ctx())

    _hook_both(monkeypatch, t, shrink)
    g = t.solve().gangs[0]
    assert not g.admitted and not g.bindings and not t.port._bindings
    assert len(admitted(t.solve())["g"].bindings) == 2


def test_oversized_set_count_buckets_instead_of_crashing():
    t = bench_twin(max_sets=1)
    spec = _gang_spec("many-sets", n_pods=1, groups=2)
    spec.pack_constraint.required_key = "topology.gke.io/block"
    for grp in spec.pod_groups:
        grp.pack_constraint.required_key = "topology.gke.io/rack"
    for gi in range(2):
        gc = spec.group_configs.add()
        gc.name = f"gc{gi}"
        gc.pod_group_names.append(spec.pod_groups[gi].name)
        gc.pack_constraint.required_key = "topology.gke.io/rack"
    t.sync(spec)
    assert [g for g in t.solve().gangs if g.name == "many-sets"]


def test_spec_drift_mid_solve_not_committed(monkeypatch):
    t = bench_twin()
    t.sync(_gang_spec("g", n_pods=2, cpu=1.0))
    fired = set()

    def resync(b, out):
        if b not in fired:
            fired.add(b)
            b.SyncPodGang(pb.SyncPodGangRequest(pod_gang=_gang_spec("g", n_pods=2, cpu=16.0)),
                          _Ctx())

    _hook_both(monkeypatch, t, resync)
    g = t.solve().gangs[0]
    assert not g.admitted and not t.port._bindings
    assert len(admitted(t.solve())["g"].bindings) == 2


def test_cordon_mid_solve_not_committed(monkeypatch):
    t = bench_twin()
    t.sync(_gang_spec("g", n_pods=2))
    fired = set()

    def cordon(b, out):
        if b not in fired:
            fired.add(b)
            for name in set(out[0].get("g", {}).values()):
                b._nodes[name].schedulable = False

    _hook_both(monkeypatch, t, cordon)
    assert not t.solve().gangs[0].admitted and not t.port._bindings
    t.solve()  # re-placed on the schedulable nodes, the same way


def test_bucket_rounding_equals_jax():
    for value, configured in ((9, 8), (5, 8), (5, None), (1, None), (17, 4), (64, 64)):
        assert p_service.TPUSchedulerBackend._bucket(value, configured) == \
            r_service.TPUSchedulerBackend._bucket(value, configured)


def test_priority_classes_order_the_solve():
    """Under contention the critical gang wins the capacity on both."""
    from grove_tpu_torch.sim.workloads import bench_topology

    t = bench_twin(nodes=2)
    t.init([(lv.domain.value, lv.node_label_key) for lv in bench_topology().levels],
           priority_classes={"critical": 100})
    high = _gang_spec("z-high", n_pods=2, cpu=16.0)
    high.priority_class_name = "critical"
    t.sync(_gang_spec("a-low", n_pods=2, cpu=16.0))
    t.sync(high)
    assert set(admitted(t.solve())) == {"z-high"}


def test_deprecated_speculative_flag_is_ignored():
    t = bench_twin()
    t.sync(_gang_spec("s", n_pods=2))
    assert "s" in admitted(t.solve(speculative=True))


def test_escalation_and_its_damper_equal_jax(monkeypatch):
    """portfolio_escalation=4 on a contended fleet: a rejecting base solve
    retries under 4 weight rows (B5 on the card); an unchanged state then
    solves at the base width (the damper), and a released pod re-arms it.
    The widths each sidecar asked its solve() for are the same, call by
    call, as are the responses."""
    widths = {"jax": [], "port": []}
    for mod, key in ((r_service, "jax"), (p_service, "port")):
        orig = mod.solve

        def spy(*a, _orig=orig, _key=key, **kw):
            widths[_key].append(kw["escalate_portfolio"])
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, "solve", spy)
    t = bench_twin(nodes=4, portfolio_escalation=4)
    for i in range(3):
        t.sync(_gang_spec(f"j{i}", n_pods=2, cpu=12.0))
    resp = t.solve()
    assert len(admitted(resp)) == 2
    t.sync(_gang_spec("late", n_pods=1, cpu=15.0))
    t.solve()
    t.solve()  # nothing changed: damped
    t.release([next(iter(admitted(resp).values())).bindings[0].pod_name])
    t.solve()
    assert widths["port"] == widths["jax"]
    assert 4 in widths["port"] and 1 in widths["port"], widths


def test_sidecar_bench_at_a_small_size():
    """chip_smoke.py phase 16's sequence on the CPU's plain versions (320
    nodes, 25 gangs): every gate holds, SyncPodGang RPCs are answered while
    the first Solve's device phase is parked, and the gRPC responses equal
    the in-process servicer's."""
    from grove_tpu_torch.bench import run_sidecar_bench

    out = run_sidecar_bench(0.05, 0.02, device="cpu")
    assert out["ok"], out["gates"]
    assert out["admitted"] == [25, 2] and out["lowerings"][1] == 0
    assert out["inflight_sync_rpcs"] == 25 and out["cpu_equal"] is True
    assert out["contended_gangs"] == 5 and out["contended_admitted"] == 4


def test_sidecar_sequence_under_the_default_config_prepares_again():
    """The same sequence under SolverConfig() (what an operator config
    without solver bucket floors gives): the incremental Solve's shape is
    not the first Solve's, so it prepares one more launch. The sidecar
    bench floors its buckets at the backlog's own to pin the launch cache."""
    from grove_tpu_torch.backend.client import gang_to_proto, node_to_proto
    from grove_tpu_torch.bench import build_backlog, sidecar_sequence
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_cluster

    topology = [(lv.domain.value, lv.node_label_key) for lv in bench_topology().levels]
    gangs, pods = build_backlog(0.02)
    nodes = [node_to_proto(n) for n in synthetic_cluster(racks_per_block=1)]
    reg = PRegistry()
    backend = p_service.TPUSchedulerBackend(solver_config=PSolverConfig(), metrics=reg,
                                            device="cpu")
    misses = reg.counter("grove_backend_exec_cache_misses_total", "")
    seen = []
    out = sidecar_sequence(lambda m, r: getattr(backend, m)(r, None), nodes,
                           [gang_to_proto(g, pods) for g in gangs], topology,
                           lambda: seen.append(misses.value()) or {})
    assert all(g.admitted for g in out["solves"][0].gangs)
    assert seen == [1, 2]


def test_sidecar_needs_the_card_unless_asked():
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_service.TPUSchedulerBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_service.create_server(port=0)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_backend.py` on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sidecar_on_the_card_equals_the_cpu_servicer(cuda):
    """chip_smoke.py phase 16 at a small size (320 nodes, 25 gangs): the
    sidecar served over gRPC with the card answers as the CPU servicer does,
    the incremental Solve prepares nothing and the contended Solve launches
    the portfolio."""
    from grove_tpu_torch.bench import run_sidecar_bench

    out = run_sidecar_bench(0.05, 0.02, device=cuda)
    assert out["ok"], out["gates"]
    assert out["contended_launches"]["portfolio"] >= 1
