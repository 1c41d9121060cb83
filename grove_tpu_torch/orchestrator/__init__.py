"""PodCliqueSet expansion into gangs and pods."""

from grove_tpu_torch.orchestrator.expansion import (  # noqa: F401
    DesiredState,
    expand_podcliqueset,
    translate_pack_constraint,
)
