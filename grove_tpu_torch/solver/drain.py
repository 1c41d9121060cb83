"""Mass admission: drain a whole gang backlog through the solver, one wave at
a time, chained on the device (grove_tpu/solver/drain.py counterpart, the
"chained" harvest discipline only).

  1. Shape-bucketed waves (plan_waves): gangs batch with others of their own
     padded encode shape; base gangs dispatch before scaled gangs.
  2. Every wave is encoded on the host, uploaded through pinned memory, and
     solved by one kernel launch on the current stream. The wave carry — the
     fleet's `free` tensor and the `ok_global` verdict bitmap — stays on the
     card and is updated in place by each launch (the JAX package donates
     the same two buffers), so the host never waits between waves.
  3. One harvest: a single synchronise, then every wave's verdicts come to
     the host and decode into pod -> node bindings.

Warm paths, pruning, recording, meshes, faults and the other harvest modes
of the JAX package are later slices of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from grove_tpu_torch.solver.core import (
    SolverParams,
    decode_bindings,
    resolve_device,
    solve_batch,
)
from grove_tpu_torch.solver.encode import encode_gangs, gang_shape, next_pow2


@dataclass
class DrainStats:
    """Phase breakdown of one drain (host wall seconds unless noted)."""

    encode_s: float = 0.0  # host dense encode, all waves
    dispatch_s: float = 0.0  # upload + launch of every wave (no waiting)
    harvest_s: float = 0.0  # the one synchronise + device->host copies
    decode_s: float = 0.0  # host decode of all bindings into the result
    total_s: float = 0.0  # encode + dispatch + harvest + decode
    waves: int = 0
    gangs: int = 0
    admitted: int = 0
    pods_bound: int = 0
    scores: list = field(default_factory=list)  # per admitted gang
    # The fleet's free capacity after the last wave, as the solver left it
    # (fetched in the one harvest).
    free_after: np.ndarray | None = None


def plan_waves(gangs: list, wave_size: int = 256) -> list[tuple[list, tuple, int]]:
    """Shape-bucketed, rank-ordered waves: (members, (mg, ms, mp), pad).

    Rank 0 (base gangs) precedes rank 1 (scaled gangs); within a rank, shape
    classes go in order of their first member. Full waves pad the gang axis
    to max(32, next_pow2(wave_size)); a class that fits in one wave pads to
    next_pow2 of its size; a class with a full wave pads its remainder to the
    full pad."""

    def _padded_shape(g):
        mg_g, ms_g, mp_g = gang_shape(g)
        return (mg_g, max(ms_g, 1), next_pow2(mp_g))

    full_pad = max(32, next_pow2(wave_size))
    waves: list[tuple[list, tuple, int]] = []
    for rank in (0, 1):
        classes: dict[tuple, list] = {}
        for g in gangs:
            if (g.base_podgang_name is not None) == bool(rank):
                classes.setdefault(_padded_shape(g), []).append(g)
        for shape, members in classes.items():
            n_full = len(members) // wave_size
            for i in range(0, len(members), wave_size):
                wave = members[i : i + wave_size]
                pad = full_pad
                if len(wave) < wave_size and n_full == 0:
                    pad = next_pow2(len(wave))
                waves.append((wave, shape, pad))
    return waves


def drain_backlog(
    gangs: list,
    pods_by_name: dict,
    snapshot,
    *,
    wave_size: int = 256,
    params: SolverParams | None = None,
    device=None,
) -> tuple[dict[str, dict[str, str]], DrainStats]:
    """Admit a whole backlog; returns ({gang: {pod: node}}, DrainStats).

    All-or-nothing per gang; scaled gangs wait for their base's verdict on
    the device. `device` None means the card; "cpu" runs the plain PyTorch
    versions."""
    dev = resolve_device(device)
    params = params or SolverParams()
    stats = DrainStats(gangs=len(gangs))
    if not gangs:
        return {}, stats
    waves = plan_waves(gangs, wave_size)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    capacity = torch.as_tensor(snapshot.capacity, device=dev)
    schedulable = torch.as_tensor(snapshot.schedulable, device=dev)
    node_domain_id = torch.as_tensor(snapshot.node_domain_id, device=dev)
    domains = None
    if dev.type == "cuda":
        from grove_tpu_torch.kernels.place_wave import domain_index

        domains = domain_index(snapshot.node_domain_id, dev)
    # The wave carry. On the card each launch updates both in place.
    free = torch.as_tensor(snapshot.free, dtype=torch.float32, device=dev)
    ok_g = torch.zeros((len(gangs),), dtype=torch.bool, device=dev)

    t0 = time.perf_counter()
    inflight = []
    for wave, (mg_c, ms_c, mp_c), pad in waves:
        te = time.perf_counter()
        batch, decode = encode_gangs(
            wave,
            pods_by_name,
            snapshot,
            max_groups=mg_c,
            max_sets=ms_c,
            max_pods=mp_c,
            pad_gangs_to=pad,
            global_index_of=gidx,
        )
        td = time.perf_counter()
        stats.encode_s += td - te
        res = solve_batch(
            free, capacity, schedulable, node_domain_id, batch, params, ok_g,
            device=dev, domains=domains,
        )
        free, ok_g = res.free_after, res.ok_global
        inflight.append((res, decode))
        stats.dispatch_s += time.perf_counter() - td
        stats.waves += 1

    th = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fetched = [
        (r.ok.cpu().numpy(), r.placement_score.cpu().numpy(), r.assigned.cpu().numpy())
        for r, _ in inflight
    ]
    stats.free_after = free.cpu().numpy()
    stats.harvest_s = time.perf_counter() - th

    bindings: dict[str, dict[str, str]] = {}
    for (ok_np, score_np, assigned_np), (_, decode) in zip(fetched, inflight):
        td = time.perf_counter()
        wave_bindings = decode_bindings(ok_np, assigned_np, decode, snapshot)
        stats.scores.extend(score_np[ok_np].tolist())
        for gang_name, pod_bindings in wave_bindings.items():
            bindings[gang_name] = pod_bindings
            stats.admitted += 1
            stats.pods_bound += len(pod_bindings)
        stats.decode_s += time.perf_counter() - td
    stats.total_s = time.perf_counter() - t0
    return bindings, stats
