"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc); imports nothing of
JAX or of the grove_tpu package. Phases, each fatal on failure:

  1. card     nvidia-smi's name and power limit, the torch device name/count
  2. build    the place_wave kernel from grove_tpu_torch/kernels/csrc
  3. exact    the place_wave kernel against its plain PyTorch version, both
              on the card, on: the first wave (256 gangs) of the full-width
              bench backlog on the 5120-node snapshot, the same wave with
              seeded group_node_ok/reuse_nodes planes, a scaled-gang wave
              gated by a seeded ok_global bitmap, the first wave on a
              5120-node snapshot whose free capacity is not dyadic, and the
              contended and mixed-quality scenarios as single batches —
              torch.equal on ok, assigned, placement_score, free_after and
              ok_global
  4. drain    the full 5120-node, ~10k-pod backlog through drain_backlog
              (chained harvest): launches == waves, every gang admitted,
              the kernel's free_after equal to the snapshot's free minus
              every bound pod's request recomputed on the host, no node
              over capacity
  5. kernels  one JSON line: per kernel its launches on the main path, its
              error against the plain version, its time, the plain
              version's time and its bound
  6. the last line: {"ok": true, "device": {...}}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet


def check(ok: bool, message: str) -> None:
    """Fail the run (an assert statement would vanish under python -O)."""
    if not ok:
        raise AssertionError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from grove_tpu_torch.api import Container, Pod, PodSpec
    from grove_tpu_torch.bench import build_scenario
    from grove_tpu_torch.kernels import build
    from grove_tpu_torch.kernels.place_wave import domain_index, place_wave
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim import workloads as W
    from grove_tpu_torch.solver.core import SolverParams, batch_to
    from grove_tpu_torch.solver.drain import drain_backlog, plan_waves
    from grove_tpu_torch.solver.encode import encode_gangs
    from grove_tpu_torch.solver.reference import solve_batch_ref
    from grove_tpu_torch.state import build_snapshot, pod_request_vector

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card -------------------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load("place_wave")
    info = build.build_info.get("place_wave", {})
    print(f"build: place_wave.cu in {time.perf_counter() - t0:.2f}s\n{info.get('ptxas', '')}")

    params = SolverParams()

    def node_tensors(snap):
        return (
            torch.as_tensor(snap.free, dtype=torch.float32, device=dev),
            torch.as_tensor(snap.capacity, device=dev),
            torch.as_tensor(snap.schedulable, device=dev),
            torch.as_tensor(snap.node_domain_id, device=dev),
        )

    def scenario(cluster, backlog):
        topo = W.bench_topology()
        gangs, pods = [], {}
        for pcs in backlog:
            ds = expand_podcliqueset(pcs, topo)
            gangs.extend(ds.podgangs)
            pods.update({p.name: p for p in ds.pods})
        bound = None
        if isinstance(cluster, tuple):
            cluster, bound = cluster
        return gangs, pods, build_snapshot(cluster, topo, bound_pods=bound)

    def run_kernel(snap, tb, okg, domains):
        return place_wave(*node_tensors(snap), tb, params, okg.clone(), domains=domains)

    def run_plain(snap, tb, okg):
        return solve_batch_ref(*node_tensors(snap), tb, params, okg.clone())

    # ---- 3. kernel vs plain, exact, on the card ------------------------------
    gangs_b, pods_b, snap_b, n_nodes, _ = build_scenario(1.0)
    gidx_b = {g.name: i for i, g in enumerate(gangs_b)}
    plan_b = plan_waves(gangs_b, 256)
    dom_b = domain_index(snap_b.node_domain_id, dev)

    def encode_wave(ws, snap=snap_b):
        wave, (mg, ms, mp), pad = ws
        batch, _ = encode_gangs(
            wave, pods_b, snap, max_groups=mg, max_sets=ms, max_pods=mp,
            pad_gangs_to=pad, global_index_of=gidx_b,
        )
        return batch

    # The bench's quantities are dyadic rationals, which any summation order
    # adds exactly. This 5120-node snapshot's are not — 31.7-cpu hosts, a
    # third of them part-filled in 0.3-cpu / 300Mi steps — so the order of
    # every domain sum shows in its last bits.
    nd_nodes = W.synthetic_cluster(cpu=31.7, memory=100.3 * 2**30)
    squatters = [
        Pod(name=f"squat-{k}", node_name=node.name, spec=PodSpec(containers=[Container(
            name="c", requests={"cpu": 0.3 * (k % 7 + 1), "memory": 300 * 2**20 * (k % 3 + 1)})]))
        for k, node in enumerate(nd_nodes[::3])
    ]
    snap_nd = build_snapshot(nd_nodes, W.bench_topology(), bound_pods=squatters)

    rng = np.random.default_rng(0)
    first = encode_wave(plan_b[0])
    g0, mg0 = first.group_total.shape
    scaled_ws = next(ws for ws in plan_b if ws[0][0].base_podgang_name is not None)
    cases = [
        ("bench wave 0", snap_b, first, np.zeros(len(gangs_b), bool)),
        (
            "bench wave 0 + group_node_ok/reuse_nodes",
            snap_b,
            first._replace(
                group_node_ok=rng.random((g0, mg0, n_nodes)) < 0.9,
                reuse_nodes=rng.random((g0, n_nodes)) < 0.01,
            ),
            np.zeros(len(gangs_b), bool),
        ),
        ("bench scaled wave, gated by ok_global", snap_b, encode_wave(scaled_ws),
         rng.random(len(gangs_b)) < 0.7),
        ("bench wave 0 on non-dyadic free capacity", snap_nd, encode_wave(plan_b[0], snap_nd),
         np.zeros(len(gangs_b), bool)),
    ]
    for label, cluster, backlog in (
        ("contended", W.contended_cluster(), W.contended_backlog(48)),
        ("mixed quality", W.quality_cluster(), W.mixed_backlog()),
    ):
        gangs_s, pods_s, snap_s = scenario(cluster, backlog)
        batch_s, _ = encode_gangs(
            gangs_s, pods_s, snap_s, global_index_of={g.name: i for i, g in enumerate(gangs_s)}
        )
        cases.append((label, snap_s, batch_s, np.zeros(len(gangs_s), bool)))

    names = ("assigned", "ok", "placement_score", "free_after", "ok_global")
    max_err = 0.0
    for label, snap, batch, okg_np in cases:
        tb = batch_to(batch, dev)
        okg = torch.as_tensor(okg_np, device=dev)
        domains = dom_b if snap is snap_b else domain_index(snap.node_domain_id, dev)
        got = run_kernel(snap, tb, okg, domains)
        want = run_plain(snap, tb, okg)
        torch.cuda.synchronize()
        for nm, a, b in zip(names, got, want):
            check(torch.equal(a, b),
                  f"exact[{label}]: kernel != plain on {nm} at {torch.nonzero(a != b)[:8].tolist()}")
            if a.dtype.is_floating_point:
                max_err = max(max_err, float((a - b).abs().max()) if a.numel() else 0.0)
        print(f"exact[{label}]: G={batch.gang_valid.shape[0]} N={snap.capacity.shape[0]} "
              f"admitted {int(want[1].sum())}/{int(np.asarray(batch.gang_valid).sum())} "
              f"valid — kernel == plain on {', '.join(names)}")

    # Times at the main path's shape: the first full wave of the bench.
    tb0 = batch_to(first, dev)
    okg0 = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    frees = [node_tensors(snap_b)[0] for _ in range(6)]
    _, cap_b, sched_b, ndid_b = node_tensors(snap_b)
    place_wave(frees[0], cap_b, sched_b, ndid_b, tb0, params, okg0.clone(), domains=dom_b)
    torch.cuda.synchronize()
    okgs = [okg0.clone() for _ in frees[1:]]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for f, o in zip(frees[1:], okgs):
        place_wave(f, cap_b, sched_b, ndid_b, tb0, params, o, domains=dom_b)
    e1.record()
    torch.cuda.synchronize()
    kernel_ms = e0.elapsed_time(e1) / len(okgs)
    free_p = node_tensors(snap_b)[0]
    e0.record()
    solve_batch_ref(free_p, cap_b, sched_b, ndid_b, tb0, params, okg0.clone())
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    bound_ms, bound_by = place_wave_bound(first, snap_b)
    print(f"timing[bench wave 0, G={g0}, N={n_nodes}]: kernel {kernel_ms:.3f} ms/wave, "
          f"plain {plain_ms:.1f} ms, bound {bound_ms:.6f} ms ({bound_by}) on {card}")

    # ---- 4. the main path: full drain through the kernel ---------------------
    torch.cuda.synchronize()
    place_wave.launches = 0
    t0 = time.perf_counter()
    bindings, stats = drain_backlog(gangs_b, pods_b, snap_b, wave_size=256, params=params)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = place_wave.launches
    check(launches > 0, "drain: the main path launched no place_wave kernel")
    check(launches == stats.waves, f"drain: {launches} launches for {stats.waves} waves")
    check(stats.admitted == len(gangs_b), f"drain: admitted {stats.admitted}/{len(gangs_b)}")
    free_host = snap_b.free.astype(np.float32)
    idx = snap_b.node_index_map
    for pod_bindings in bindings.values():
        for pod_name, node_name in pod_bindings.items():
            i = idx[node_name]
            free_host[i] = free_host[i] - pod_request_vector(pods_b[pod_name], snap_b.resource_names)
    check(
        stats.free_after is not None and np.array_equal(stats.free_after, free_host),
        "drain: kernel free_after != snapshot free minus bound pods' requests",
    )
    check(bool((free_host >= 0).all()), "drain: a node is over capacity")
    n_pods = sum(len(b) for b in bindings.values())
    print(f"drain: gangs {len(gangs_b)} gangs_admitted {stats.admitted} pods {len(pods_b)} "
          f"pods_bound {stats.pods_bound} ({n_pods} bindings) waves {stats.waves} "
          f"launches {launches} drain_s {drain_s:.4f} (encode {stats.encode_s:.4f}, "
          f"dispatch {stats.dispatch_s:.4f}, harvest {stats.harvest_s:.4f}, "
          f"decode {stats.decode_s:.4f}) on {card}")

    # Per-wave kernel time over the drain's own waves (after the warm-up above).
    wave_ms = []
    free_w = node_tensors(snap_b)[0]
    okg_w = torch.zeros(len(gangs_b), dtype=torch.bool, device=dev)
    batches = [batch_to(encode_wave(ws), dev) for ws in plan_b]
    torch.cuda.synchronize()
    for tb in batches:
        e0.record()
        place_wave(free_w, cap_b, sched_b, ndid_b, tb, params, okg_w, domains=dom_b)
        e1.record()
        torch.cuda.synchronize()
        wave_ms.append(e0.elapsed_time(e1))
    print(f"drain kernels: per-wave ms {[round(x, 3) for x in wave_ms]} "
          f"sum {sum(wave_ms):.3f} ms on {card}")

    # ---- 5. kernels line -----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "place_wave(B1+B2)",
        "route": "cuda",
        "source": "grove_tpu_torch/kernels/csrc/place_wave.cu",
        "replaces": "grove_tpu/solver/core.py:537",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(f"elapsed {time.perf_counter() - t_start:.1f}s; card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def place_wave_bound(batch, snap) -> tuple[float, str]:
    """(bound_ms, "bytes" | "operations") for one place_wave launch on this
    batch: the larger of the bytes it must move (each input read once, each
    output written once) over HBM bandwidth and the f32 operations its
    valid gangs need over the f32 peak. Operations counted per valid gang:
    slot ratios (MG*N*R*3), domain tables (L*N*C adds), narrow-set
    feasibility (MS*N*(R+MG)), two domain picks per pack-set (N*(C+1+MS)
    adds + N*(R+MG+MS) compares each), and per group phase the node scores
    (N*(6R+7+3MS)) plus one argmax pass over N per pod."""
    import numpy as np

    n, r = snap.capacity.shape
    levels = snap.node_domain_id.shape[0]
    g, mg, _ = batch.group_req.shape
    ms = batch.set_member.shape[1]
    c = r + mg + 1
    nbytes = 4 * n * r * 3 + n + 4 * levels * n  # free in/out, capacity, sched, domains
    nbytes += sum(np.asarray(x).nbytes for x in batch if x is not None)
    nbytes += batch.pod_group.size * 4 + g * 5  # assigned, ok, score
    valid = np.asarray(batch.gang_valid, bool)
    pods = int(np.asarray(batch.group_total)[valid].sum())
    per_gang = (
        mg * n * r * 3 + levels * n * c + ms * n * (r + mg)
        + 2 * ms * (n * (c + 1 + ms) + n * (r + mg + ms))
        + 2 * mg * n * (6 * r + 7 + 3 * ms)
    )
    ops = int(valid.sum()) * per_gang + pods * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


if __name__ == "__main__":
    sys.exit(main())
