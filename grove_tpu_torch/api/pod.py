"""Lightweight Pod object — the unit the orchestrator creates and the solver
places (grove_tpu/api/pod.py counterpart, cut to what placement reads)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from grove_tpu_torch.api.types import PodSpec


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    spec: PodSpec = field(default_factory=PodSpec)
    pclq_fqn: str = ""
    podgang_name: str = ""
    node_name: Optional[str] = None  # set for pods already bound

    @property
    def is_scheduled(self) -> bool:
        return self.node_name is not None

    @property
    def is_active(self) -> bool:
        """Not terminal and not being deleted. The port's pods carry no
        lifecycle (phase, deletion stamp), so every pod is active."""
        return True
