"""The port's sidecar on the wire.

- The JAX package's `BackendClient` drives the port's server, and the port's
  `BackendClient` drives the JAX server, through one RPC sequence over gRPC
  on 127.0.0.1: every answer of one pair equals the other's.
- The port's `scheduler_backend_pb2` and `.proto` are byte-equal to the JAX
  package's and its descriptor to the Go shim's: the wire contract (proto
  package `grove_tpu.backend.v1`) is shared, not renamed.
- The protoc-built stub of tests/test_backend_conformance.py runs its full
  cycle against `python -m grove_tpu_torch.backend.service --port 0
  --device cpu` as a subprocess.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.backend import client as r_client
from grove_tpu.backend import service as r_service
from grove_tpu.backend.proto import scheduler_backend_pb2 as r_pb
from grove_tpu_torch.backend import client as p_client
from grove_tpu_torch.backend import service as p_service
from grove_tpu_torch.backend.proto import scheduler_backend_pb2 as p_pb
from test_backend import RACK, ZONE, _gang, _nodes
from test_backend_conformance import _descriptor_set, wire  # noqa: F401  (fixture)
from test_backend_conformance import test_full_backend_cycle_over_the_wire as full_cycle
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PROTO = pathlib.Path("backend") / "proto"


def drive(client) -> list:
    """One RPC sequence through `client`; the answers, wall clock aside."""
    out = [client.init([("zone", ZONE), ("rack", RACK)]),
           client.update_cluster(_nodes(8), full_replace=True),
           client.prepare_pod("p", pod_gang_name="g1"),
           client.validate_podcliqueset("{not a pcs"),
           client.sync_pod_gang(_gang("g1", rack_required=True)),
           client.sync_pod_gang(_gang("g2", pods_per_group=40, min_replicas=40)),
           client.solve(),
           client.release_pods(["g1-alpha-0", "g1-beta-2"]),
           client.solve(),
           client.on_pod_gang_delete("g2"),
           client.sync_pod_gang(_gang("g3", pods_per_group=4, min_replicas=3)),
           client.solve()]
    for resp in out:
        if isinstance(resp, p_pb.SolveResponse):
            resp.solve_micros = 0
    return out


def test_clients_and_servers_of_both_packages_interoperate():
    r_server, r_port = r_service.create_server(port=0)
    p_server, p_port = p_service.create_server(port=0, device="cpu")
    try:
        with r_client.BackendClient(f"127.0.0.1:{p_port}") as jax_to_port, \
                p_client.BackendClient(f"127.0.0.1:{r_port}") as port_to_jax:
            a = drive(jax_to_port)
            b = drive(port_to_jax)
    finally:
        r_server.stop(grace=None)
        p_server.stop(grace=None)
    assert a == b
    solved = [r for r in a if isinstance(r, p_pb.SolveResponse)]
    assert [g.name for g in solved[0].gangs if g.admitted] == ["g1"]
    assert [len(g.bindings) for g in solved[1].gangs if g.admitted] == [2]
    assert any(g.admitted for g in solved[2].gangs)


def test_proto_files_are_byte_equal_to_the_jax_package_and_the_shim():
    for name in ("scheduler_backend.proto", "scheduler_backend_pb2.py"):
        assert (REPO / "grove_tpu_torch" / PROTO / name).read_bytes() == \
            (REPO / "grove_tpu" / PROTO / name).read_bytes(), name
    assert p_pb.DESCRIPTOR.serialized_pb == r_pb.DESCRIPTOR.serialized_pb
    assert p_pb.DESCRIPTOR.package == "grove_tpu.backend.v1"
    assert p_service.SERVICE_NAME == r_service.SERVICE_NAME == \
        "grove_tpu.backend.v1.SchedulerBackend"
    # One descriptor pool holds both copies, so one message class serves both.
    assert p_pb.SolveResponse is r_pb.SolveResponse


def test_port_descriptor_equals_the_shims():
    """protoc's descriptor of the Go shim's proto equals the port's, up to
    the go_package option and source info."""
    from google.protobuf import descriptor_pb2

    def normalized(raw: bytes):
        fds = descriptor_pb2.FileDescriptorSet.FromString(raw)
        for f in fds.file:
            f.ClearField("options")
            f.ClearField("source_code_info")
        return fds

    shim = normalized(_descriptor_set(REPO / "shim" / "go" / "proto" / "scheduler_backend.proto"))
    port = normalized(_descriptor_set(REPO / "grove_tpu_torch" / PROTO /
                                      "scheduler_backend.proto"))
    assert shim == port


@pytest.fixture(scope="module")
def port_sidecar():
    """The port's sidecar as a subprocess on the CPU's plain versions."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "grove_tpu_torch.backend.service", "--port", "0",
         "--device", "cpu"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on ([\d.]+:\d+)", line)
        assert m, f"sidecar banner: {line!r}"
        yield m.group(1)
    finally:
        proc.kill()
        proc.wait()


def test_protoc_stub_runs_the_full_cycle_against_the_port_sidecar(wire, port_sidecar):  # noqa: F811
    full_cycle(wire, port_sidecar)


def test_sidecar_cli_refuses_cuda_without_a_card():
    import torch

    assert not torch.cuda.is_available()
    out = subprocess.run(
        [sys.executable, "-m", "grove_tpu_torch.backend.service", "--port", "0"],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert "listening" not in out.stdout
