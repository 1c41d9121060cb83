"""The device mesh of the node-sharded solve (grove_tpu/parallel/mesh.py
counterpart).

The solver's parallelism axes:

  portfolio — independent weight variants solved side by side, the winner
              kept (parallel/portfolio.py);
  node      — the node axis of every node tensor (free, capacity,
              schedulable, node_domain_id, the batch's node-seed planes)
              split into contiguous row spans, one per shard.

A `SolveLayout` is one negotiated (1, K) node-sharded layout. Its solve is
kernel B7 (kernels/place_wave.py `place_wave_sharded`): one launch, K chain
blocks, block s owning rows [s * N / K, (s + 1) * N / K); the shards sum
their rows' domain partials, exchange them through device memory and add
them in shard order, and merge their stage-2 candidates under lax.top_k's
order, so every shard holds the replicated verdict and the result equals
the unsharded solve on the fleets whose partial sums are exact
(solver/reference.py `sharded_solve_ref` is its plain version).

Devices. `mesh_devices()` lists the visible cards; after
`force_virtual_devices(k)` it lists k virtual devices that all name the
caller's one device (the card, or the CPU in tests), the port's
counterpart of the JAX package's virtual CPU devices. On virtual shards
the spans are views of one buffer and each shard is one block of one
launch. A layout over distinct cards negotiates and keys like any other,
but its launch raises: the exchange across cards is not ported (ROADMAP).

Negotiation is the JAX package's: `solve_layout_for` takes the largest
device count that divides the node axis; one device means no layout, and
no count. On more than one device, a fleet under minNodes or an axis no
K > 1 divides is counted on the process-wide `shard_fallbacks()` ledger
(the first one logs its reason), once per memoized (config, axis) when
it comes through `MeshConfig.layout_for`; the drains count every request
that got no layout on `DrainStats.shard_fallbacks` and solve unsharded.
The portfolio mesh (the JAX package's `factor_devices`, `solver_mesh`,
`solver_mesh_for`) is not ported: WAITS_PORTFOLIO. The JAX layout's
`shard_solve_args` and row ops have no counterpart: B7 splits the node
tensors, and gathers and scatters a pruned solve's candidate rows, inside
its launch (sharded_solve_ref on the CPU).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

import torch

PORTFOLIO_AXIS = "portfolio"
NODE_AXIS = "node"

# What waits for later slices (ROADMAP.md Queue A 2): each raises when asked
# for under a layout, naming its item.
WAITS_PORTFOLIO = "ROADMAP Queue A 2 (a): the portfolio mesh"
WAITS_SCAN = "ROADMAP Queue A 2 (b): the scan and resident disciplines under a layout"
WAITS_CARDS = "ROADMAP Queue A 2 (c): the launch across distinct cards"

logger = logging.getLogger(__name__)

_FALLBACKS = 0
_FALLBACK_LOCK = threading.Lock()
_FALLBACK_LOGGED = False


def _note_fallback(reason: str) -> None:
    global _FALLBACKS, _FALLBACK_LOGGED
    with _FALLBACK_LOCK:
        _FALLBACKS += 1
        first = not _FALLBACK_LOGGED
        _FALLBACK_LOGGED = True
    if first:
        logger.warning(
            "solver mesh fallback: %s — solving unsharded on one device "
            "(counted as shardFallbacks; only the first fallback logs)",
            reason,
        )


def shard_fallbacks() -> int:
    """Process-wide count of requested meshes that solved unsharded."""
    with _FALLBACK_LOCK:
        return _FALLBACKS


# ---- devices -------------------------------------------------------------------


@dataclass(frozen=True)
class MeshDevice:
    """One device of the mesh: `device` is where its rows live, `id` its
    place in mesh_devices(), `virtual` whether it is a shard of the one
    device the virtual list names."""

    device: torch.device
    id: int
    virtual: bool = False


_VIRTUAL: list[MeshDevice] = []
_VIRTUAL_LOCK = threading.Lock()


def force_virtual_devices(k: int, device=None) -> list[MeshDevice]:
    """From now on mesh_devices() lists `k` virtual devices naming `device`
    (None: the current card when there is one, else the CPU); k <= 0 goes
    back to the real devices. Returns the new list."""
    global _VIRTUAL
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _VIRTUAL_LOCK:
        _VIRTUAL = [MeshDevice(device, i, True) for i in range(max(int(k), 0))]
        _LAYOUT_MEMO.clear()
    return mesh_devices()


def mesh_devices() -> list[MeshDevice]:
    """The devices a mesh may span: the virtual ones when forced, else every
    visible card (the CPU as one device where there is none)."""
    with _VIRTUAL_LOCK:
        if _VIRTUAL:
            return list(_VIRTUAL)
    if torch.cuda.is_available():
        return [MeshDevice(torch.device("cuda", i), i) for i in range(torch.cuda.device_count())]
    return [MeshDevice(torch.device("cpu"), 0)]


@dataclass(frozen=True)
class Mesh:
    """A (portfolio, node) grid of devices, row-major."""

    devices: tuple  # tuple of `portfolio` rows of `node` MeshDevices

    @property
    def shape(self) -> dict:
        return {PORTFOLIO_AXIS: len(self.devices), NODE_AXIS: len(self.devices[0])}

    @property
    def flat(self) -> tuple:
        return tuple(d for row in self.devices for d in row)


def _grid(devices: list, p: int, k: int) -> Mesh:
    return Mesh(tuple(tuple(devices[i * k:(i + 1) * k]) for i in range(p)))


def mesh_divisible_pad(pad: int, k: int) -> int:
    """Round `pad` up to the next multiple of `k` (identity for k <= 1)."""
    if k <= 1:
        return pad
    return ((pad + k - 1) // k) * k


# ---- the node-sharded layout -----------------------------------------------------


@dataclass(frozen=True)
class SolveLayout:
    """One negotiated (1, K) layout for the single-variant solve: the node
    axis of every node tensor split into K contiguous row spans, one per
    device of the mesh's node axis.

    One instance is one launch family: `key()` is part of the launch-cache
    key (solver/warm.py) and the sharded-solve table (solver/core.py
    `sharded_solve_fn`); `fingerprint()` is what the flight recorder
    journals, so replay can rebuild the layout. On virtual shards each
    shard's rows are a view of the one buffer: kernel B7 gathers and
    scatters a pruned solve's candidate rows inside its launch, each shard
    its own span."""

    mesh: Mesh

    @property
    def node_devices(self) -> int:
        return self.mesh.shape[NODE_AXIS]

    @property
    def portfolio_devices(self) -> int:
        return self.mesh.shape[PORTFOLIO_AXIS]

    @property
    def virtual(self) -> bool:
        return all(d.virtual for d in self.mesh.flat)

    @property
    def device(self) -> torch.device:
        """The one device the launch runs on: virtual shards name one device;
        a layout over distinct cards raises (WAITS_CARDS)."""
        devs = {str(d.device) for d in self.mesh.flat}
        if len(devs) != 1:
            raise NotImplementedError(
                f"a sharded solve across {len(devs)} distinct devices waits for {WAITS_CARDS}")
        return self.mesh.flat[0].device

    def key(self) -> tuple:
        """Hashable launch-cache identity: axis sizes, device ids and whether
        the devices are virtual (a virtual layout and one over real cards
        never share an entry)."""
        return (self.portfolio_devices, self.node_devices,
                tuple(d.id for d in self.mesh.flat), self.virtual)

    def fingerprint(self) -> dict:
        """JSON-able journal record (trace/recorder.py wave records)."""
        return {"portfolio": self.portfolio_devices, "node": self.node_devices}

    def spans(self, n: int) -> list[tuple[int, int]]:
        """The K row spans of a node axis of `n` (n divisible by K)."""
        k = self.node_devices
        if n % k:
            raise ValueError(f"node axis {n} is not divisible by the layout's {k} shards")
        step = n // k
        return [(s * step, (s + 1) * step) for s in range(k)]


def solve_layout_for(n_nodes: int, devices: list | None = None, *, max_devices: int = 0,
                     min_nodes: int = 0, count_fallback: bool = True) -> SolveLayout | None:
    """Negotiate the (1, K) node-sharded layout for a single-variant solve:
    K is the largest device count <= the available devices (clamped by
    `max_devices` when > 0) that divides `n_nodes`. None means stay
    unsharded: one device (uncounted), a fleet below `min_nodes`, or no
    K > 1 dividing the axis (both counted unless `count_fallback=False`)."""
    devices = list(devices if devices is not None else mesh_devices())
    if max_devices > 0:
        devices = devices[:max_devices]
    nd = len(devices)
    if nd <= 1:
        return None
    if n_nodes < min_nodes:
        if count_fallback:
            _note_fallback(f"fleet axis {n_nodes} below solver.mesh.minNodes={min_nodes}")
        return None
    for k in range(nd, 1, -1):
        if n_nodes % k == 0:
            return SolveLayout(mesh=_grid(devices, 1, k))
    if count_fallback:
        _note_fallback(f"no node-axis split: {n_nodes} nodes not divisible by any k in 2..{nd}")
    return None


@dataclass(frozen=True)
class MeshConfig:
    """The `solver.mesh` config block (runtime/config.py validates the YAML
    shape)."""

    enabled: bool = False
    # Fleets whose padded node axis is below this stay unsharded.
    min_nodes: int = 512
    # Devices the solve may occupy; 0 = every visible device.
    max_devices: int = 0

    def layout_for(self, n_nodes: int) -> SolveLayout | None:
        """The negotiated layout for a fleet axis (memoized per config, axis
        and device list, so a fallback counts once per memoized key); None
        when disabled or negotiation falls back."""
        if not self.enabled:
            return None
        key = (self, int(n_nodes))
        with _VIRTUAL_LOCK:
            if key in _LAYOUT_MEMO:
                return _LAYOUT_MEMO[key]
        layout = solve_layout_for(int(n_nodes), max_devices=self.max_devices,
                                  min_nodes=self.min_nodes)
        with _VIRTUAL_LOCK:
            if len(_LAYOUT_MEMO) > 64:
                _LAYOUT_MEMO.clear()
            _LAYOUT_MEMO[key] = layout
        return layout


# Dropped whenever the device list changes (force_virtual_devices).
_LAYOUT_MEMO: dict[tuple, SolveLayout | None] = {}


def resolve_layout(mesh, n_nodes: int) -> SolveLayout | None:
    """Normalize a caller-facing `mesh` argument (None | SolveLayout |
    MeshConfig) to a SolveLayout or None (the process-wide ledger counts
    in solve_layout_for; the drains count each request that got none on
    their DrainStats)."""
    if mesh is None:
        return None
    if isinstance(mesh, SolveLayout):
        return mesh
    if isinstance(mesh, MeshConfig):
        return mesh.layout_for(n_nodes)
    raise TypeError(f"mesh must be None, SolveLayout or MeshConfig; got {type(mesh)!r}")


def mesh_requested(mesh) -> bool:
    """Did the caller ask for a sharded solve (a fallback when it gets none)?"""
    return mesh is not None and (not isinstance(mesh, MeshConfig) or mesh.enabled)


def layout_from_fingerprint(fp: dict | None, n_nodes: int) -> SolveLayout | None:
    """Rebuild a journaled layout when this process can host it: the
    recorded node axis fits the devices (virtual ones included) and divides
    `n_nodes`. None otherwise (replay then solves unsharded, which gives the
    same verdicts); never counts a fallback."""
    if not fp:
        return None
    k = int(fp.get("node", 1))
    if k <= 1:
        return None
    devices = mesh_devices()
    if len(devices) < k or n_nodes % k != 0:
        return None
    layout = SolveLayout(mesh=_grid(devices, 1, k))
    try:
        layout.device
    except NotImplementedError:
        return None  # distinct cards: this process cannot launch it
    return layout
