"""Kubernetes resource-quantity parsing (the subset Grove workloads use).

Parity target: resource requests in PodSpecs, e.g. `cpu: 10m`, `memory: 1Gi`,
`nvidia.com/gpu: 8` (reference sample workloads, operator/samples/**.yaml). We
normalize every quantity to a float in base units (cores for cpu, bytes for
memory, count for extended resources) so cluster snapshots are dense float32
tensors (see grove_tpu/state/cluster.py).

The port's copy of grove_tpu/api/quantity.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import re

_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DECIMAL_SUFFIXES = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]{0,2})$")


def parse_quantity(value: str | int | float) -> float:
    """Parse a Kubernetes quantity string into a float in base units."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    m = _QUANTITY_RE.match(s)
    if m is None:
        raise ValueError(f"invalid quantity: {value!r}")
    number, suffix = m.groups()
    base = float(number)
    if suffix in _BINARY_SUFFIXES:
        return base * _BINARY_SUFFIXES[suffix]
    if suffix in _DECIMAL_SUFFIXES:
        return base * _DECIMAL_SUFFIXES[suffix]
    raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")


def format_quantity(value: float) -> str:
    """Render a float back into a compact quantity string (for status display)."""
    if value == int(value):
        return str(int(value))
    milli = value * 1000
    if milli == int(milli):
        return f"{int(milli)}m"
    return repr(value)
