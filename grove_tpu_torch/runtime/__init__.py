"""Operator runtime: the validated OperatorConfiguration (config.py) and the
leader-election lease (lease.py). The manager that boots from them is not
ported yet."""

from grove_tpu_torch.runtime.config import (
    OperatorConfiguration,
    load_operator_config,
    validate_operator_config,
)

__all__ = [
    "OperatorConfiguration",
    "load_operator_config",
    "validate_operator_config",
]
