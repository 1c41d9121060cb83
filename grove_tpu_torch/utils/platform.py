"""The CUDA platform probe: which device a process runs on, named.

The sidecar and the benches run on the card unless the caller asks for the
CPU. A missing card is an error (`solver.core.resolve_device` raises): there
is no fall back to the CPU, whose plain PyTorch versions run only when the
caller passes "cpu" itself.
"""

from __future__ import annotations

import subprocess


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


def describe_device(device=None) -> str:
    """Resolve `device` (None or "cuda": the card, which must be present;
    "cpu": the plain versions) and name it: the card's name and nvidia-smi's
    name and power limit, or the CPU."""
    import torch

    from grove_tpu_torch.solver.core import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu (the plain PyTorch versions)"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"{torch.cuda.get_device_name(index)}; power limit: {card_line()}"


def ensure_usable_backend(device=None) -> tuple[str, str]:
    """The operator binary's platform check (the JAX package's
    `ensure_usable_backend` probes its accelerator and falls back to the
    CPU; this one never falls back): resolve `device` (None: the card,
    raising RuntimeError without one; "cpu" only when the caller asked for
    it) and return (platform, description), platform "cuda" or "cpu"."""
    from grove_tpu_torch.solver.core import resolve_device

    dev = resolve_device(device)
    return dev.type, describe_device(dev)
