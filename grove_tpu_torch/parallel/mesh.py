"""The device mesh's pad rule (grove_tpu/parallel/mesh.py counterpart, cut
to what one card needs).

The port solves on one card. A journal recorded under a mesh still fixes
the candidate pad the recorded solve ran with: the JAX package negotiates
the pad divisible by the mesh's node axis, so replay rounds it the same
way (solver/pruning.py `candidate_pad`)."""

from __future__ import annotations


def mesh_divisible_pad(pad: int, k: int) -> int:
    """Round `pad` up to the next multiple of `k` (identity for k <= 1)."""
    if k <= 1:
        return pad
    return ((pad + k - 1) // k) * k
