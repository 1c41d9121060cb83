"""The device mesh, cut to what one card needs (grove_tpu/parallel/mesh.py
counterpart).

The port solves on one card, so a mesh never shards here:

- `MeshConfig` is the `solver.mesh` config block the drains' `mesh=`
  accepts, with the JAX package's fields;
- `resolve_layout` makes the JAX package's decision for one device: no
  layout. A requested, enabled mesh that resolves to none is counted on the
  process-wide `shard_fallbacks()` ledger, and the drains count it on
  `DrainStats.shard_fallbacks` and solve unsharded, as the JAX drain does
  when it cannot host the mesh — a fallback is never silent;
- a journal recorded under a mesh still fixes the candidate pad the
  recorded solve ran with: the JAX package negotiates the pad divisible by
  the mesh's node axis, so replay rounds it the same way
  (`mesh_divisible_pad`, solver/pruning.py `candidate_pad`).

The node-sharded solve across cards (kernel B7) is not ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

_FALLBACKS = 0
_FALLBACK_LOCK = threading.Lock()


def _note_fallback() -> None:
    global _FALLBACKS
    with _FALLBACK_LOCK:
        _FALLBACKS += 1


def shard_fallbacks() -> int:
    """Process-wide count of requested meshes that solved unsharded."""
    with _FALLBACK_LOCK:
        return _FALLBACKS


@dataclass(frozen=True)
class MeshConfig:
    """The `solver.mesh` config block."""

    enabled: bool = False
    # Fleets whose padded node axis is below this stay unsharded.
    min_nodes: int = 512
    # Devices the solve may occupy; 0 = every visible device.
    max_devices: int = 0


def resolve_layout(mesh, n_nodes: int):
    """Normalize a caller-facing `mesh` argument (None | MeshConfig) to a
    layout: always None on one card. An enabled MeshConfig counts one
    fallback (the drains also count it on their DrainStats)."""
    if mesh is None:
        return None
    if not isinstance(mesh, MeshConfig):
        raise TypeError(f"mesh must be None or MeshConfig; got {type(mesh)!r}")
    if mesh.enabled:
        _note_fallback()
    return None


def mesh_requested(mesh) -> bool:
    """Did the caller ask for a sharded solve (a fallback when it gets none)?"""
    return mesh is not None and (not isinstance(mesh, MeshConfig) or mesh.enabled)


def mesh_divisible_pad(pad: int, k: int) -> int:
    """Round `pad` up to the next multiple of `k` (identity for k <= 1)."""
    if k <= 1:
        return pad
    return ((pad + k - 1) // k) * k
