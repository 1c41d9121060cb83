"""The port's rollout bench, typed client, CLI and deploy renderer against
the JAX package's:

  - `run_rollout_bench(device="cpu")` at a 10 s trace (bench.py cut through
    its own GROVE_BENCH_ROLLOUT_DURATION_S) equals bench.py's document,
    wall-clock keys aside, with every gate green; without a card and without
    `device="cpu"` it refuses to run;
  - `GroveClient` over each package's Manager, and `FakeGroveClient`, decode
    the same objects;
  - the CLI's verbs print the same text against each package's Manager, and
    its journal verbs (`trace info|replay|whatif`, `tune sweep`) give the
    same documents on one journal, seconds aside; the solving ones need the
    card unless `--device cpu` is given;
  - `render_manifests` renders the JAX package's manifests, but for the
    manager container's command (the port's runtime) and its one NVIDIA card.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import pathlib

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
import torch
import yaml

from grove_tpu_torch import bench as p_bench
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---- the rollout bench -------------------------------------------------------------------


def test_rollout_document_equals_bench_py(monkeypatch):
    import bench

    monkeypatch.setenv("GROVE_BENCH_ROLLOUT_DURATION_S", "10")
    ref = bench.run_rollout_bench()
    port = p_bench.run_rollout_bench(device="cpu", duration_s=10.0)
    assert set(port) == set(ref)
    assert p_bench.manager_doc_core(port) == p_bench.manager_doc_core(ref)
    assert all(port["gates"].values()) and port["vs_baseline"] == 1.0
    assert port["revocable_nodes"] == 32 and port["trace_duration_s"] == 10.0
    assert port["rollout_counts"]["cutovers"] >= 1 and port["replay_waves"] >= 2


def test_rollout_bench_needs_the_card_unless_asked():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_bench.run_rollout_bench(duration_s=5.0)


# ---- typed client and CLI against a served Manager -----------------------------------------

SIMPLE = """
metadata: {name: cl}
spec:
  replicas: 1
  template:
    cliques:
      - name: web
        spec:
          roleName: web
          replicas: 2
          podSpec:
            containers:
              - name: c
                resources: {requests: {cpu: "1", memory: 1Gi}}
"""


def served_managers(tmp_path):
    """(JAX manager, port manager on the CPU), each serving its object API
    on a kernel-picked port, on bench_topology with the same six nodes, with
    SIMPLE applied through its GroveClient and simple1 through its
    FakeGroveClient, and reconciled once."""
    from grove_tpu.client import FakeGroveClient as RFake
    from grove_tpu.client import GroveClient as RClient
    from grove_tpu.runtime.config import parse_operator_config as r_parse
    from grove_tpu.runtime.manager import Manager as RManager
    from grove_tpu.sim import workloads as r_wl
    from grove_tpu_torch.client import FakeGroveClient as PFake
    from grove_tpu_torch.client import GroveClient as PClient
    from grove_tpu_torch.runtime.config import parse_operator_config as p_parse
    from grove_tpu_torch.runtime.manager import Manager as PManager
    from grove_tpu_torch.sim import workloads as p_wl

    out = []
    for side, parse, mgr, wl, client, fake, kw in (
            ("jax", r_parse, RManager, r_wl, RClient, RFake, {}),
            ("port", p_parse, PManager, p_wl, PClient, PFake, {"device": "cpu"})):
        root = tmp_path / side
        cfg, errors = parse({
            "servers": {"healthPort": 0, "metricsPort": -1, "tlsCertDir": str(root / "certs")},
            "backend": {"enabled": False},
            "solver": {"shapeHistoryPath": str(root / "solve-shapes.json")},
            "persistence": {"path": str(root / "state.json")},
            "leaderElection": {"enabled": False},
        })
        assert not errors
        m = mgr(cfg, **kw)
        m.controller.topology = wl.bench_topology()
        m.topology = m.controller.topology
        for n in wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=1,
                                      hosts_per_rack=6):
            m.cluster.nodes[n.name] = n
        m.start()
        out.append(m)
        assert client(f"http://127.0.0.1:{m.health_port}").apply_podcliqueset(SIMPLE) == "cl"
        fake(m).apply_podcliqueset((REPO / "examples" / "simple1.yaml").read_text())
        m.reconcile_once(now=1.0)
    return out


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    ms = served_managers(tmp_path_factory.mktemp("served"))
    try:
        yield ms
    finally:
        for m in ms:
            m.stop()


def test_typed_clients_decode_the_same_objects(managers):
    from grove_tpu.client import FakeGroveClient as RFake
    from grove_tpu.client import GroveApiError as RApiError
    from grove_tpu.client import GroveClient as RClient
    from grove_tpu_torch.client import FakeGroveClient as PFake
    from grove_tpu_torch.client import GroveApiError as PApiError
    from grove_tpu_torch.client import GroveClient as PClient

    view = p_bench.plain_view
    seen = []
    for m, client_cls, fake_cls, err in ((managers[0], RClient, RFake, RApiError),
                                         (managers[1], PClient, PFake, PApiError)):
        http = client_cls(f"http://127.0.0.1:{m.health_port}")
        fake = fake_cls(m)
        doc = {}
        for c in (http, fake):
            doc[type(c).__name__] = {
                "lists": [c.list_podcliquesets(), c.list_podgangs(), c.list_pods(),
                          c.list_nodes(), c.list_services()],
                "pcs": view(c.get_podcliqueset("cl")),
                "gang": view(c.get_podgang(c.list_podgangs()[0])),
                "pod": view(c.get_pod(c.list_pods()[0])),
                "node": view(c.get_node(c.list_nodes()[0])),
                "cliques": view(c.list_podcliques_full()),
                "groups": view(c.list_scaling_groups_full()),
                "events": c.events(),
            }
        with pytest.raises(err) as missing:
            http.get_podcliqueset("ghost")
        doc["missing"] = missing.value.status
        try:
            http.apply_podcliqueset("metadata: {name: " + "x" * 60 + "}\nspec: {}\n")
            doc["invalid"] = None
        except err as e:
            doc["invalid"] = [e.status, str(e)]
        seen.append(doc)
    assert seen[1] == seen[0]
    assert seen[1]["GroveClient"]["lists"][0] == ["cl", "simple1"]
    assert seen[1]["missing"] == 404 and seen[1]["invalid"][0] == 422


def cli(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


SERVER_VERBS = [
    ["get", "pcs"], ["get", "pclq"], ["get", "pcsg"], ["get", "podgangs"], ["get", "pods"],
    ["get", "nodes"], ["get", "services"], ["get", "queues"], ["get", "topology"],
    ["get", "pcs", "cl"], ["describe", "pcs", "simple1"], ["describe", "pclq", "cl-0-web"],
    ["top"], ["events", "--tail", "5"], ["get", "bogus"], ["delete", "pods", "x"],
]


def test_cli_verbs_print_the_same(managers, tmp_path):
    from grove_tpu.cli.main import main as r_main
    from grove_tpu_torch.cli.main import main as p_main

    second = tmp_path / "cl2.yaml"
    second.write_text(SIMPLE.replace("{name: cl}", "{name: cl2}"))
    bad = tmp_path / "bad.yaml"
    bad.write_text(SIMPLE.replace("{name: cl}", "{name: " + "x" * 60 + "}"))
    # The mutating verbs last, each undone, so the served stores end as
    # they began.
    verbs = SERVER_VERBS + [
        ["apply", "-f", str(second)], ["get", "pcs"], ["delete", "pcs", "cl2"],
        ["scale", "cl-0-web", "--replicas", "3"], ["get", "pclq"],
        ["scale", "cl-0-web", "--replicas", "2"], ["apply", "-f", str(bad)],
    ]
    for argv in verbs:
        got = [cli(main, ["--server", f"http://127.0.0.1:{m.health_port}", *argv])
               for main, m in ((r_main, managers[0]), (p_main, managers[1]))]
        assert got[1] == got[0], argv
    code, out, _ = cli(p_main, ["validate", "-f", str(REPO / "examples" / "simple1.yaml")])
    assert (code, out) == (0, "podcliqueset/simple1 valid\n")
    for argv in (["validate", "-f", str(REPO / "examples" / "simple1.yaml"), "--config",
                  str(REPO / "examples" / "operator-config.yaml")],
                 ["validate", "-f", str(bad)]):
        assert cli(p_main, argv) == cli(r_main, argv)
    code, out, _ = cli(p_main, ["--version"])
    assert code == 0 and f"torch {torch.__version__}" in out and "CUDA" in out


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    """A JAX drain of a small backlog, journaled by the JAX recorder."""
    from grove_tpu.api import DEFAULT_CLUSTER_TOPOLOGY as TOPO
    from grove_tpu.orchestrator import expand_podcliqueset
    from grove_tpu.sim.workloads import synthetic_backlog, synthetic_cluster
    from grove_tpu.solver.drain import drain_backlog
    from grove_tpu.state import build_snapshot
    from grove_tpu.trace.recorder import TraceRecorder

    path = tmp_path_factory.mktemp("journal") / "trace"
    gangs, pods = [], {}
    for pcs in synthetic_backlog(n_disagg=2, n_agg=2, n_frontend=2):
        ds = expand_podcliqueset(pcs, TOPO)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    snap = build_snapshot(synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2), TOPO)
    rec = TraceRecorder(str(path))
    rec.start()
    try:
        drain_backlog(gangs, pods, snap, wave_size=8, recorder=rec)
    finally:
        rec.stop()
    return str(path)


def seconds_aside(x):
    if isinstance(x, dict):
        return {k: seconds_aside(v) for k, v in x.items()
                if not k.lower().endswith(("seconds", "_s")) and k != "path"}
    if isinstance(x, list):
        return [seconds_aside(v) for v in x]
    return x


JOURNAL_VERBS = (
    ["trace", "info"], ["trace", "replay", "--json"], ["trace", "whatif", "--json"],
    ["tune", "sweep", "--k", "2", "--rungs", "1", "--json"],
)


def test_cli_journal_verbs_equal(journal):
    """Each journal verb of both CLIs on one JAX journal (one test, so the
    journal and the JAX compiles are made once)."""
    from grove_tpu.cli.main import main as r_main
    from grove_tpu_torch.cli.main import main as p_main

    def doc(text):
        return seconds_aside(json.loads(text[:text.rindex("}") + 1]))

    for argv in JOURNAL_VERBS:
        want = cli(r_main, [*argv, "--path", journal])
        got = cli(p_main, ["--device", "cpu", *argv, "--path", journal])
        assert got[0] == want[0] == 0, (argv, got)
        if "--json" in argv:
            assert doc(got[1]) == doc(want[1]), argv
            # A solving verb without --device needs the card.
            code, _, err = cli(p_main, [*argv, "--path", journal])
            assert code == 1 and "no CUDA device" in err, argv
        else:
            assert got[1] == want[1]


# ---- deploy ------------------------------------------------------------------------------


def deploy_configs():
    return {
        "sample": yaml.safe_load((REPO / "examples" / "operator-config.yaml").read_text()),
        "backend": {"servers": {"healthPort": 2751, "metricsPort": 2752},
                    "backend": {"enabled": True, "port": 50055}},
        "no-ports": {"servers": {"healthPort": -1, "metricsPort": -1}},
        "kubernetes-ha": {"servers": {"healthPort": 2751, "metricsPort": -1,
                                      "advertiseUrl": "http://op.grove-system.svc:2751"},
                          "leaderElection": {"enabled": True},
                          "cluster": {"source": "kubernetes"}},
        "webhook": {"servers": {"healthPort": 2751, "metricsPort": -1, "webhookPort": 9443,
                                "advertiseUrl": "http://op.grove-system.svc:2751",
                                "webhookSans": ["grove-tpu-operator-webhook.grove-system.svc"]},
                    "authorizer": {"enabled": True},
                    "cluster": {"source": "kubernetes"}},
    }


def port_manifests(jax_docs: list) -> list:
    """The JAX package's manifests as the port renders them: the manager
    container runs the port's runtime and holds one NVIDIA card."""
    from grove_tpu_torch.deploy import GPU_RESOURCE

    docs = copy.deepcopy(jax_docs)
    for d in docs:
        if d and d["kind"] == "Deployment":
            c = d["spec"]["template"]["spec"]["containers"][0]
            assert c["command"][2] == "grove_tpu.runtime"
            c["command"][2] = "grove_tpu_torch.runtime"
            c["resources"] = {"limits": {GPU_RESOURCE: 1}}
    return docs


@pytest.mark.parametrize("name", sorted(deploy_configs()))
def test_deploy_renders_the_jax_manifests_for_the_port(name):
    from grove_tpu.deploy import render_manifests as r_render
    from grove_tpu.runtime.config import parse_operator_config as r_parse
    from grove_tpu_torch.deploy import render_manifests as p_render
    from grove_tpu_torch.runtime.config import parse_operator_config as p_parse

    doc = deploy_configs()[name]
    doc.setdefault("servers", {}).setdefault("bindAddress", "0.0.0.0")
    text = yaml.safe_dump(doc)
    want = r_render(r_parse(copy.deepcopy(doc))[0], text)
    got = p_render(p_parse(copy.deepcopy(doc))[0], text)
    assert got == port_manifests(want)


def test_deploy_binary_renders_the_same_documents(tmp_path):
    from grove_tpu.deploy import main as r_main
    from grove_tpu_torch.deploy import main as p_main

    cfg = REPO / "examples" / "operator-config.yaml"
    want, got = cli(r_main, ["--config", str(cfg)]), cli(p_main, ["--config", str(cfg)])
    assert want[0] == got[0] == 0
    assert list(yaml.safe_load_all(got[1])) == port_manifests(list(yaml.safe_load_all(want[1])))
    bad = tmp_path / "bad.yaml"
    bad.write_text("servers: {healthPort: 0}\n")
    assert cli(r_main, ["--config", str(bad)])[0] == cli(p_main, ["--config", str(bad)])[0] == 2
