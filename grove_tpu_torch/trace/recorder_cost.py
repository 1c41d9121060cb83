"""The flight recorder's cost to a long-lived recorder.

The record-overhead reading of the replay scenario (`bench.read_record_overhead`)
starts a fresh recorder for every window and stops it after; a Manager keeps one
recorder for its life, and `replay_verify` flushes it and reads the journal. This
reading keeps one `TraceRecorder` across every block of drains of the replay world
(`bench.replay_world`), so rotation, pruning and the writer thread's own passes
happen as they would in such a process, and whatever a recorder does at start() or
stop() falls outside every block.

Blocks of `drains` drains alternate OFF (no recorder) and ON in the reading's round
orders (`bench.ROUND_ORDERS`); an ON block ends with `flush()`, timed inside it.
Prints one JSON document per `--drains` value, with per drain (ms): the OFF and ON
walls, `flush()` on its caller's clock, and the recorder's capture and render parts;
the reading (ON - OFF) / OFF; the writes made; the card's name and power limit.

Run from the root of a checkout (it imports that checkout's package):

    python3 -m grove_tpu_torch.trace.recorder_cost [--drains 1,10] [--rounds 24]
        [--scale 1.0] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "not measured"


def read(drain, recorder, drains: int, rounds: int) -> dict:
    """The blocks' walls and flushes, and the recorder's parts over them."""
    from grove_tpu_torch.bench import ROUND_ORDERS

    def parts() -> dict:
        split = recorder.stats(split=True)["split"]
        return {p: split[p]["s"] for p in ("capture", "render")}

    before = parts()
    segments0, manifests0 = recorder.segments_written, recorder.manifest_writes
    walls = {"off": 0.0, "on": 0.0}
    flush_s, flushes = 0.0, 0
    for r in range(rounds):
        for side in ROUND_ORDERS[r % 2]:
            rec = recorder if side == "on" else None
            t0 = time.perf_counter()
            for _ in range(drains):
                drain(rec)
            if rec is not None:
                t1 = time.perf_counter()
                if not rec.flush(timeout=60.0):
                    raise RuntimeError("recorder_cost: the recorder did not flush in 60 s")
                flush_s += time.perf_counter() - t1
                flushes += 1
            walls[side] += time.perf_counter() - t0
    after = parts()
    n = rounds * 2 * drains  # drains a side
    ms = 1e3 / n
    return {
        "drains_a_block": drains,
        "rounds": rounds,
        "drains_a_side": n,
        "wall_off_ms": walls["off"] * ms,
        "wall_on_ms": walls["on"] * ms,
        "reading": (walls["on"] - walls["off"]) / walls["off"],
        "flush_ms": flush_s * ms,
        "flush_ms_a_flush": flush_s * 1e3 / flushes,
        "capture_ms": (after["capture"] - before["capture"]) * ms,
        "render_ms": (after["render"] - before["render"]) * ms,
        "segments_written": recorder.segments_written - segments0,
        "manifest_writes": recorder.manifest_writes - manifests0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drains", default="1,10", help="drains a block, comma-separated")
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="cpu, or the card when omitted")
    ap.add_argument("--out", default=None, help="also write the documents here")
    args = ap.parse_args(argv)

    from grove_tpu_torch.bench import replay_world
    from grove_tpu_torch.orchestrator.controller import GroveController
    from grove_tpu_torch.orchestrator.store import Cluster
    from grove_tpu_torch.sim.simulator import Simulator
    from grove_tpu_torch.solver.core import resolve_device
    from grove_tpu_torch.trace.recorder import TraceRecorder

    dev = resolve_device(args.device)
    topo, fleet, backlog = replay_world(args.scale)

    def drain(recorder):  # the replay scenario's drain (bench.run_replay_bench)
        cluster = Cluster()
        for n in fleet():
            cluster.nodes[n.name] = n
        ctrl = GroveController(cluster=cluster, topology=topo, recorder=recorder, device=dev)
        sim = Simulator(cluster=cluster, controller=ctrl)
        for pcs in backlog():
            cluster.podcliquesets[pcs.metadata.name] = pcs
        sim.run_until(
            lambda: all(p.ready for p in cluster.pods.values() if p.is_scheduled)
            and any(p.is_scheduled for p in cluster.pods.values()),
            timeout=120.0,
        )

    card = card_line() if args.device is None else "not measured (CPU)"
    drain(None)  # the kernels built, the process caches filled
    docs = []
    for drains in (int(x) for x in args.drains.split(",")):
        path = tempfile.mkdtemp(prefix="grove-trace-cost-")
        recorder = TraceRecorder(path)
        recorder.start()
        try:
            drain(recorder)  # the recorder path's first use
            recorder.flush(timeout=60.0)
            doc = read(drain, recorder, drains, args.rounds)
        finally:
            recorder.stop()
            shutil.rmtree(path, ignore_errors=True)
        doc.update(tree=os.getcwd(), scale=args.scale, card=card)
        docs.append(doc)
        print(json.dumps(doc), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(docs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
