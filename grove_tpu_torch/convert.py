"""Carry the JAX package's solver state across to the port.

`from_reference` takes the reference's snapshot arrays, GangBatch fields and
SolverParams as plain numpy arrays and floats (never JAX or grove_tpu
objects, so this module imports neither) and returns the port's tensors on a
given device, its GangBatch and its SolverParams. The tests feed the
reference's own encoded batch to the port's solver through it.

`pruning_config_from_reference` and `plan_from_reference` do the same for a
PruningConfig and a CandidatePlan (their fields as plain values and numpy
arrays), so the tests feed both packages the same candidate plan.
`params_stack_from_reference` turns a reference SolverParams stack (each
field [K]) into the port's weight stack, f32 [K, 5], and
`scan_config_from_reference` a ScanConfig's fields into the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from grove_tpu_torch.solver.core import SolverParams, resolve_device
from grove_tpu_torch.solver.drain import ScanConfig
from grove_tpu_torch.solver.encode import GangBatch
from grove_tpu_torch.solver.pruning import CandidatePlan, PruningConfig

_DTYPES = {
    "group_req": np.float32,
    "set_member": np.bool_,
    "group_valid": np.bool_,
    "set_valid": np.bool_,
    "gang_valid": np.bool_,
    "reuse_nodes": np.bool_,
    "group_node_ok": np.bool_,
    "spread_avoid": np.bool_,
}


def from_reference(
    free,
    capacity,
    schedulable,
    node_domain_id,
    batch_arrays: dict,
    params: dict,
    device=None,
):
    """-> (free, capacity, schedulable, node_domain_id tensors on `device`,
    GangBatch of numpy arrays, SolverParams).

    `batch_arrays` maps GangBatch field names to numpy arrays or None (the
    reference's `batch._asdict()` with each field passed through
    np.asarray); `params` maps SolverParams field names to floats. Missing
    optional fields are None. `device` None means the card."""
    dev = resolve_device(device)
    unknown = set(batch_arrays) - set(GangBatch._fields)
    if unknown:
        raise ValueError(f"unknown GangBatch fields: {sorted(unknown)}")
    fields = {}
    for name in GangBatch._fields:
        x = batch_arrays.get(name)
        fields[name] = None if x is None else np.ascontiguousarray(
            x, dtype=_DTYPES.get(name, np.int32)
        )
    unknown = set(params) - set(SolverParams._fields)
    if unknown:
        raise ValueError(f"unknown SolverParams fields: {sorted(unknown)}")
    sp = SolverParams(**{k: float(v) for k, v in params.items()})
    return (
        torch.as_tensor(np.array(free, dtype=np.float32), device=dev),
        torch.as_tensor(np.array(capacity, dtype=np.float32), device=dev),
        torch.as_tensor(np.array(schedulable, dtype=np.bool_), device=dev),
        torch.as_tensor(np.array(node_domain_id, dtype=np.int32), device=dev),
        GangBatch(**fields),
        sp,
    )


def pruning_config_from_reference(fields: dict) -> PruningConfig:
    """The reference's PruningConfig fields (`dataclasses.asdict`) -> the
    port's PruningConfig."""
    fields = dict(fields)
    fields["pad_ladder"] = tuple(int(x) for x in fields.get("pad_ladder", ()))
    unknown = set(fields) - set(PruningConfig.__dataclass_fields__)
    if unknown:
        raise ValueError(f"unknown PruningConfig fields: {sorted(unknown)}")
    return PruningConfig(**fields)


_PLAN_DTYPES = {
    "idx": np.int32,
    "gang_lossy": np.bool_,
    "capacity": np.float32,
    "schedulable": np.bool_,
    "node_domain_id": np.int32,
    "num_domains": np.int32,
}


def plan_from_reference(fields: dict) -> CandidatePlan:
    """The reference's CandidatePlan fields (`vars(plan)`: numpy arrays,
    ints, a bool and the per-level `_remap` dicts) -> the port's
    CandidatePlan."""
    names = {f for f in CandidatePlan.__dataclass_fields__ if f != "_tensors"}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown CandidatePlan fields: {sorted(unknown)}")
    out = {}
    for name in names:
        x = fields[name]
        if name in _PLAN_DTYPES:
            x = np.ascontiguousarray(x, dtype=_PLAN_DTYPES[name])
        elif name == "_remap":
            x = [{int(k): int(v) for k, v in level.items()} for level in x]
        elif name == "clipped":
            x = bool(x)
        else:
            x = int(x)
        out[name] = x
    return CandidatePlan(**out)


def params_stack_from_reference(fields: dict, device=None) -> torch.Tensor:
    """The reference's stacked SolverParams (`stack._asdict()` with each
    field passed through np.asarray: f32 [K] per weight) -> the port's
    weight stack, f32 [K, 5] on `device` (None = the card), columns in
    SolverParams' field order."""
    unknown = set(fields) - set(SolverParams._fields)
    missing = set(SolverParams._fields) - set(fields)
    if unknown or missing:
        raise ValueError(f"SolverParams stack fields: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    cols = [np.asarray(fields[k], dtype=np.float32).reshape(-1) for k in SolverParams._fields]
    if len({c.shape[0] for c in cols}) != 1:
        raise ValueError("SolverParams stack fields differ in length")
    return torch.as_tensor(np.stack(cols, axis=1), device=resolve_device(device))


def scan_config_from_reference(fields: dict) -> ScanConfig:
    """The reference's ScanConfig fields (`dataclasses.asdict`) -> the
    port's ScanConfig, field for field."""
    unknown = set(fields) - set(ScanConfig.__dataclass_fields__)
    if unknown:
        raise ValueError(f"unknown ScanConfig fields: {sorted(unknown)}")
    cast = {"enabled": bool, "device_resident": bool}
    return ScanConfig(**{k: cast.get(k, int)(v) for k, v in fields.items()})
