"""The headline drain on the port: python -m grove_tpu_torch.bench

Drives bench.py's default scenario (`run_bench`, chained harvest) through
grove_tpu_torch: the 5120-node synthetic cluster, the ~10k-pod synthetic
backlog, waves of 256 gangs, every wave solved by one place_wave kernel
launch on the card. Prints one JSON line with run_bench's drain fields, the
card's name and power limit, and the kernel's launch count.

  --scale S    cluster racks and backlog size times S (default 1.0)
  --device D   "cuda" (default) or "cpu" (plain PyTorch versions)
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np


def card_line() -> str:
    """nvidia-smi's "name, power.limit" for the card, or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def build_scenario(scale: float = 1.0):
    """(gangs, pods_by_name, snapshot, n_nodes, setup_s) of bench.py's
    default scenario at `scale`."""
    from grove_tpu_torch.orchestrator import expand_podcliqueset
    from grove_tpu_torch.sim.workloads import bench_topology, synthetic_backlog, synthetic_cluster
    from grove_tpu_torch.state import build_snapshot

    topo = bench_topology()
    nodes = synthetic_cluster(racks_per_block=max(1, round(16 * scale)))
    backlog = synthetic_backlog(
        n_disagg=max(1, round(350 * scale)),
        n_agg=max(1, round(250 * scale)),
        n_frontend=max(1, round(300 * scale)),
    )
    t0 = time.perf_counter()
    gangs, pods = [], {}
    for pcs in backlog:
        ds = expand_podcliqueset(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    snapshot = build_snapshot(nodes, topo)
    return gangs, pods, snapshot, len(nodes), time.perf_counter() - t0


def run_bench(scale: float = 1.0, wave_size: int = 256, device=None) -> dict:
    import torch

    from grove_tpu_torch.solver.core import SolverParams, resolve_device
    from grove_tpu_torch.solver.drain import drain_backlog

    dev = resolve_device(device)
    gangs, pods, snapshot, n_nodes, setup_s = build_scenario(scale)
    build_s = 0.0
    launches0 = 0
    if dev.type == "cuda":
        from grove_tpu_torch.kernels import build
        from grove_tpu_torch.kernels.place_wave import place_wave

        t0 = time.perf_counter()
        build.load("place_wave")
        build_s = time.perf_counter() - t0
        launches0 = place_wave.launches
    bindings, stats = drain_backlog(
        gangs, pods, snapshot, wave_size=wave_size, params=SolverParams(), device=dev
    )
    total_s = stats.total_s
    admitted = stats.admitted

    def _num(x, nd):
        return round(x, nd) if math.isfinite(x) else None

    out = {
        # Chained harvest: every gang's bind latency is the drain wall.
        "value": _num(total_s, 4) if admitted else None,
        "p50_s": _num(total_s, 4) if admitted else None,
        "total_drain_s": round(total_s, 4),
        "gangs": len(gangs),
        "gangs_admitted": admitted,
        "gangs_rejected": len(gangs) - admitted,
        "pods": len(pods),
        "pods_bound": stats.pods_bound,
        "gangs_per_sec": round(admitted / total_s, 1),
        "pods_per_sec": round(stats.pods_bound / total_s, 1),
        "nodes": n_nodes,
        "scale": scale,
        "wave_size": wave_size,
        "waves": stats.waves,
        "setup_s": round(setup_s, 3),
        "build_s": round(build_s, 3),
        "encode_s": round(stats.encode_s, 4),
        "dispatch_s": round(stats.dispatch_s, 4),
        "device_wait_s": round(stats.harvest_s, 4),
        "decode_s": round(stats.decode_s, 4),
        "solver_score": round(float(np.mean(stats.scores)), 4) if stats.scores else None,
        "harvest": "chained",
        "device": str(dev),
    }
    if dev.type == "cuda":
        from grove_tpu_torch.kernels.place_wave import place_wave

        out["kernel_launches"] = place_wave.launches - launches0
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(run_bench(args.scale, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
