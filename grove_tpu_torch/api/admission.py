"""The admission gateway: defaulting → validation → authorization.

In-process analog of the reference's webhook chain
(`operator/internal/webhook/register.go:34-62`): a mutation enters through
`admit_*` and passes the defaulting webhook
(`admission/pcs/defaulting/podcliqueset.go:35-108`), the validating webhook
(`admission/pcs/validation/`), and — when enabled — the authorizer
(`admission/pcs/authorization/handler.go:60-80`), which blocks actors other
than the operator (and configured exempt actors) from mutating resources the
operator manages: PodCliques, PodCliqueScalingGroups, PodGangs, and Pods
owned by a PodCliqueSet. Users create/update/delete PodCliqueSets; everything
below them belongs to the reconciler.
"""

from __future__ import annotations

from dataclasses import dataclass

from grove_tpu_torch.api import constants
from grove_tpu_torch.api.defaulting import default_podcliqueset
from grove_tpu_torch.api.types import ClusterTopology, PodCliqueSet
from grove_tpu_torch.api.validation import (
    ValidationError,
    validate_podcliqueset,
    validate_update,
)

# The reconciler's own identity; always allowed to touch managed resources.
OPERATOR_ACTOR = "system:grove-operator"

# Kinds the operator owns end-to-end (authorization/handler.go exempt list is
# the inverse: these kinds are protected FROM everyone else).
MANAGED_KINDS = ("PodClique", "PodCliqueScalingGroup", "PodGang", "Pod")


class AdmissionError(Exception):
    """Mutation rejected by the admission chain."""

    def __init__(self, errors: list):
        self.errors = list(errors)
        super().__init__("; ".join(str(e) for e in self.errors))


@dataclass
class Authorizer:
    """authorizer webhook analog (types.go:211-220, handler.go:60-80)."""

    enabled: bool = False
    exempt_actors: tuple[str, ...] = ()

    def check(self, actor: str, kind: str, name: str) -> None:
        """Raise PermissionError for a non-exempt actor mutating a managed kind."""
        if not self.enabled or kind not in MANAGED_KINDS:
            return
        if actor == OPERATOR_ACTOR or actor in self.exempt_actors:
            return
        raise PermissionError(
            f"actor {actor!r} may not mutate managed resource {kind}/{name} "
            f"(grove authorizer; exempt actors: {list(self.exempt_actors)})"
        )


@dataclass
class AdmissionChain:
    """defaulting + validation + authorization, invoked at apply time."""

    topology: ClusterTopology | None = None
    authorizer: Authorizer = None  # type: ignore[assignment]
    # Configured capacity queue names (scheduling.queues); None = don't
    # check (e.g. the CLI's config-less dry run). A workload naming an
    # unknown queue is rejected at the door — a typo'd queue would
    # otherwise silently run unquoted.
    known_queues: frozenset | None = None
    # networkAcceleration.autoSliceEnabled (the MNNVL webhook's feature
    # gate, mnnvl/webhook.go:33-169). None = config unknown (CLI dry run
    # without --config): the annotation value is still checked but the
    # feature-enabled cross-check is skipped.
    auto_slice_enabled: bool | None = None
    slice_resource_name: str = constants.DEFAULT_SLICE_RESOURCE

    def __post_init__(self):
        if self.authorizer is None:
            self.authorizer = Authorizer()

    def admit_podcliqueset(
        self,
        pcs: PodCliqueSet,
        old: PodCliqueSet | None = None,
    ) -> PodCliqueSet:
        """Default + validate a PCS create/update; returns the mutated object.

        `old` triggers update-path immutability checks
        (validation/podcliqueset.go:440-508)."""
        pcs = default_podcliqueset(pcs)
        if old is None:
            # Auto-annotation is applied only on creation
            # (defaulting/handler.go:62-65).
            self._default_auto_slice(pcs)
        errors = validate_podcliqueset(pcs, self.topology)
        errors += self._validate_auto_slice(pcs, old)
        if old is not None:
            errors += validate_update(old, pcs)
        queue = pcs.metadata.annotations.get(constants.ANNOTATION_QUEUE, "")
        if queue and self.known_queues is not None and queue not in self.known_queues:
            errors = errors + [
                ValidationError(
                    f"metadata.annotations[{constants.ANNOTATION_QUEUE}]",
                    f"unknown queue {queue!r} (configured: "
                    f"{sorted(self.known_queues) or 'none'})",
                )
            ]
        if errors:
            raise AdmissionError(errors)
        return pcs

    def _requests_slice(self, pcs: PodCliqueSet) -> bool:
        """hasGPURequirement analog (mnnvl/webhook.go:~57): any clique
        template requesting the slice resource."""
        for tmpl in pcs.spec.template.cliques:
            if (
                tmpl.spec.pod_spec.total_requests().get(self.slice_resource_name, 0.0)
                > 0
            ):
                return True
        return False

    def _default_auto_slice(self, pcs: PodCliqueSet) -> None:
        """MutateAutoMNNVL analog (mnnvl/webhook.go:33-66): when the feature
        is globally enabled and the workload requests the slice resource,
        stamp grove.io/auto-slice: enabled — unless the user already set the
        annotation (explicit values, including "disabled", are never
        overridden)."""
        if not self.auto_slice_enabled:
            return
        if constants.ANNOTATION_AUTO_SLICE in pcs.metadata.annotations:
            return
        if not self._requests_slice(pcs):
            return
        pcs.metadata.annotations[constants.ANNOTATION_AUTO_SLICE] = (
            constants.AUTO_SLICE_ENABLED
        )

    def _validate_auto_slice(self, pcs: PodCliqueSet, old: PodCliqueSet | None) -> list:
        """auto-slice annotation validation, mirroring the MNNVL webhook:

        CREATE (ValidateMetadataOnCreate, mnnvl/webhook.go:69-118): value
        must be enabled|disabled; "enabled" while the feature is off is an
        error (the injection would silently never happen). The feature
        cross-check is create-only — flipping the feature off later must not
        brick updates to workloads that were auto-stamped while it was on.

        UPDATE (ValidateMetadataOnUpdate, webhook.go:120-169): the
        annotation is immutable — changing the value or adding it after
        creation is forbidden. One replace-semantics accommodation: the
        reference relies on apiserver merge-patch to carry the stamped
        annotation through user applies that never mention it; this
        surface's applies are whole-object, so an absent annotation on
        update is carried forward from `old` rather than treated as an
        explicit removal."""
        path = f"metadata.annotations[{constants.ANNOTATION_AUTO_SLICE}]"
        value = pcs.metadata.annotations.get(constants.ANNOTATION_AUTO_SLICE)
        if old is not None:
            old_value = old.metadata.annotations.get(constants.ANNOTATION_AUTO_SLICE)
            if value is None and old_value is not None:
                pcs.metadata.annotations[constants.ANNOTATION_AUTO_SLICE] = old_value
                return []
            if value is not None and old_value is None:
                return [
                    ValidationError(
                        path, "annotation cannot be added after creation (immutable)"
                    )
                ]
            if value != old_value:
                return [
                    ValidationError(
                        path,
                        f"annotation is immutable (was {old_value!r}, got {value!r})",
                    )
                ]
            return []
        if value is None:
            return []
        errors = []
        if value not in (constants.AUTO_SLICE_ENABLED, constants.AUTO_SLICE_DISABLED):
            errors.append(
                ValidationError(
                    path,
                    f"must be {constants.AUTO_SLICE_ENABLED!r} or "
                    f"{constants.AUTO_SLICE_DISABLED!r}, got {value!r}",
                )
            )
        elif value == constants.AUTO_SLICE_ENABLED and self.auto_slice_enabled is False:
            errors.append(
                ValidationError(
                    path,
                    "TPU slice injection requested but "
                    "networkAcceleration.autoSliceEnabled is false",
                )
            )
        return errors

    def admit_managed_mutation(self, actor: str, kind: str, name: str) -> None:
        self.authorizer.check(actor, kind, name)
