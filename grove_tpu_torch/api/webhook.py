"""AdmissionReview v1 wire handlers — the inbound-HTTPS webhook surface.

In the reference, the kube-apiserver POSTs `admission.k8s.io/v1`
AdmissionReview objects to the operator's webhook server: a mutating
(defaulting) handler (`webhook/admission/pcs/defaulting/handler.go`) and a
validating handler (`validation/handler.go`), registered at
`internal/webhook/register.go:34-62`. This module speaks that exact wire
format so an apiserver (or the deploy renderer's
Mutating/ValidatingWebhookConfiguration objects) can call THIS operator the
same way — no client library, just the review JSON in and out.

The semantic work stays in one place (`api/defaulting.py`,
`api/validation.py`, `api/admission.py`); this module only translates:

  - mutate: run the chain's defaulting on the incoming object and emit an
    RFC-6902 JSON patch covering exactly the fields defaulting touches
    (targeted `add` ops — never a whole-spec replace, so fields this build
    does not model survive untouched).
  - validate: run the full chain (create or update path) and translate
    AdmissionError into `allowed: false` + message.
"""

from __future__ import annotations

import base64
import copy
import json
from typing import Any

from grove_tpu_torch.api import constants
from grove_tpu_torch.api.admission import AdmissionChain, AdmissionError
from grove_tpu_torch.api.types import PodCliqueSet


def _escape_pointer(token: str) -> str:
    """RFC-6901 token escaping (`/` and `~` in annotation keys)."""
    return token.replace("~", "~0").replace("/", "~1")


def _ensure_map(ops: list, doc: dict, path: str, key: str) -> dict:
    """Make sure `doc[key]` exists as a map, adding a patch op if created."""
    cur = doc.get(key)
    if not isinstance(cur, dict):
        doc[key] = {}
        ops.append({"op": "add", "path": f"{path}/{key}", "value": {}})
    return doc[key]


def _set(ops: list, parent: dict, path: str, key: str, value: Any) -> None:
    """Add/replace `parent[key] = value`, recording the patch op when the
    current wire value differs."""
    if parent.get(key) == value:
        return
    op = "replace" if key in parent else "add"
    parent[key] = value
    ops.append({"op": op, "path": f"{path}/{_escape_pointer(key)}", "value": value})


def default_patch_ops(
    doc: dict,
    chain: AdmissionChain,
    operation: str = "CREATE",
    old_doc: dict | None = None,
) -> list[dict]:
    """Compute the defaulting JSON patch for a PodCliqueSet CR document.

    Values come from the typed defaulting pass (so the semantics live only
    in `defaulting.py`/`admission.py`); this function knows the CR paths.
    The incoming `doc` is not modified.
    """
    pcs = PodCliqueSet.from_dict(copy.deepcopy(doc))
    # Defaulting only — validation/authorization belong to the validating
    # webhook; a mutating handler must still patch objects it would reject
    # so the user sees the validation message, not a patch failure.
    from grove_tpu_torch.api.defaulting import default_podcliqueset

    default_podcliqueset(pcs)
    if operation == "CREATE":
        # Auto-annotation only on creation (defaulting/handler.go:62-65);
        # on update the live object already carries it (immutable).
        chain._default_auto_slice(pcs)
    elif isinstance(old_doc, dict):
        # UPDATE carry-forward: a whole-object PUT that omits the immutable
        # annotation must not silently drop it — the validating webhook can
        # only allow/deny, so the MUTATING webhook (which sees oldObject)
        # re-stamps it. Without this, an explicit "disabled" opt-out would
        # vanish on the next full replace and injection would switch on.
        old_val = (old_doc.get("metadata", {}) or {}).get("annotations", {}) or {}
        old_slice = old_val.get(constants.ANNOTATION_AUTO_SLICE)
        if (
            old_slice is not None
            and constants.ANNOTATION_AUTO_SLICE not in pcs.metadata.annotations
        ):
            pcs.metadata.annotations[constants.ANNOTATION_AUTO_SLICE] = old_slice

    doc = copy.deepcopy(doc)
    ops: list[dict] = []
    meta = _ensure_map(ops, doc, "", "metadata")
    if not meta.get("namespace"):
        _set(ops, meta, "/metadata", "namespace", pcs.metadata.namespace)
    want_slice = pcs.metadata.annotations.get(constants.ANNOTATION_AUTO_SLICE)
    if want_slice is not None:
        anns = _ensure_map(ops, meta, "/metadata", "annotations")
        _set(ops, anns, "/metadata/annotations", constants.ANNOTATION_AUTO_SLICE, want_slice)

    spec = _ensure_map(ops, doc, "", "spec")
    tmpl = _ensure_map(ops, spec, "/spec", "template")
    tpath = "/spec/template"

    cliques = tmpl.get("cliques") or []
    for i, cdoc in enumerate(cliques):
        typed = pcs.spec.template.cliques[i].spec
        cspec = _ensure_map(ops, cdoc, f"{tpath}/cliques/{i}", "spec")
        cpath = f"{tpath}/cliques/{i}/spec"
        if int(cspec.get("replicas") or 0) == 0:
            _set(ops, cspec, cpath, "replicas", typed.replicas)
        if cspec.get("minAvailable") is None:
            _set(ops, cspec, cpath, "minAvailable", typed.min_available)
        asc = cspec.get("autoScalingConfig")
        if isinstance(asc, dict) and asc.get("minReplicas") is None:
            _set(
                ops,
                asc,
                f"{cpath}/autoScalingConfig",
                "minReplicas",
                typed.scale_config.min_replicas,
            )
        ps = _ensure_map(ops, cspec, cpath, "podSpec")
        if not ps.get("restartPolicy"):
            _set(ops, ps, f"{cpath}/podSpec", "restartPolicy", typed.pod_spec.restart_policy)
        if ps.get("terminationGracePeriodSeconds") is None:
            _set(
                ops,
                ps,
                f"{cpath}/podSpec",
                "terminationGracePeriodSeconds",
                typed.pod_spec.termination_grace_period_seconds,
            )

    # PCSG configs: accept both CR key spellings the loader does.
    key = (
        "podCliqueScalingGroups"
        if "podCliqueScalingGroups" in tmpl
        else "podCliqueScalingGroupConfigs"
    )
    for i, gdoc in enumerate(tmpl.get(key) or []):
        typed_g = pcs.spec.template.pod_clique_scaling_group_configs[i]
        gpath = f"{tpath}/{key}/{i}"
        if gdoc.get("replicas") is None:
            _set(ops, gdoc, gpath, "replicas", typed_g.replicas)
        if gdoc.get("minAvailable") is None:
            _set(ops, gdoc, gpath, "minAvailable", typed_g.min_available)
        gsc = gdoc.get("scaleConfig") or gdoc.get("autoScalingConfig")
        if isinstance(gsc, dict) and gsc.get("minReplicas") is None:
            sub = "scaleConfig" if "scaleConfig" in gdoc else "autoScalingConfig"
            _set(ops, gsc, f"{gpath}/{sub}", "minReplicas", typed_g.scale_config.min_replicas)

    if tmpl.get("terminationDelay") is None:
        # CR field is a metav1.Duration string (podcliqueset.go:154).
        _set(ops, tmpl, tpath, "terminationDelay", "4h")
    if tmpl.get("headlessServiceConfig") is None:
        _set(
            ops,
            tmpl,
            tpath,
            "headlessServiceConfig",
            {"publishNotReadyAddresses": True},
        )
    return ops


def _review_response(uid: str, allowed: bool, message: str = "", patch: list | None = None) -> dict:
    resp: dict[str, Any] = {"uid": uid, "allowed": allowed}
    if message:
        resp["status"] = {"message": message, "code": 200 if allowed else 422}
    if patch:
        resp["patchType"] = "JSONPatch"
        resp["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": resp,
    }


def _review_request(body: dict) -> tuple[str, str, dict | None, dict | None]:
    req = body.get("request") or {}
    return (
        str(req.get("uid", "")),
        str(req.get("operation", "")).upper(),
        req.get("object"),
        req.get("oldObject"),
    )


def handle_mutate(body: dict, chain: AdmissionChain) -> dict:
    """Defaulting (mutating) webhook endpoint body → AdmissionReview response."""
    uid, operation, obj, old = _review_request(body)
    if operation not in ("CREATE", "UPDATE") or not isinstance(obj, dict):
        return _review_response(uid, True)
    try:
        ops = default_patch_ops(obj, chain, operation=operation, old_doc=old)
    except Exception as e:  # malformed object: let validation produce the message
        return _review_response(uid, True, message=f"defaulting skipped: {e}")
    return _review_response(uid, True, patch=ops or None)


def handle_authorize(
    body: dict,
    chain: AdmissionChain,
    operator_users: frozenset,
    pcs_lookup=None,
) -> dict:
    """Authorizer webhook endpoint (admission/pcs/authorization/handler.go:
    60-135): deny any user other than the reconciler (and configured exempt
    actors) mutating a grove-managed resource. Reference exceptions kept:
    CONNECT is always allowed; Pod DELETE is allowed for everyone (the
    kubelet's completion deletes and the GC's owner-reference cascade are
    system identities no exempt list could enumerate, handler.go:121-124);
    a parent PCS annotated grove.io/disable-managed-resource-protection:
    "true" bypasses the check for its children (handler.go:89-93,
    `pcs_lookup` resolves the parent by the part-of label). The rendered
    configuration pre-filters with an objectSelector on the managed-by
    label; this handler re-checks the label so a mis-scoped configuration
    fails closed for managed objects and open for everything else."""
    req = body.get("request") or {}
    uid = str(req.get("uid", ""))
    operation = str(req.get("operation", "")).upper()
    if operation == "CONNECT":
        # Always allowed for users with sufficient RBAC (handler.go:66-70).
        return _review_response(uid, True)
    username = str((req.get("userInfo") or {}).get("username", ""))
    kind = str((req.get("kind") or {}).get("kind", ""))
    if kind == "Pod" and operation == "DELETE":
        return _review_response(uid, True)

    def _managed(o) -> bool:
        labels = ((o or {}).get("metadata", {}) or {}).get("labels", {}) or {}
        return labels.get(constants.LABEL_MANAGED_BY) == constants.LABEL_MANAGED_BY_VALUE

    obj = req.get("object") if isinstance(req.get("object"), dict) else None
    old = req.get("oldObject") if isinstance(req.get("oldObject"), dict) else None
    # Managed if EITHER side carries the label: an UPDATE that strips the
    # managed-by label would otherwise walk straight past the check — the
    # objectSelector fires on either side and so must we.
    if not (_managed(obj) or _managed(old)):
        return _review_response(uid, True)  # not grove-managed
    if obj is None:
        obj = old  # DELETE reviews carry only oldObject
    if username in operator_users:
        return _review_response(uid, True)
    meta = (obj or {}).get("metadata", {}) or {}
    if pcs_lookup is not None:
        pcs_name = (meta.get("labels", {}) or {}).get(constants.LABEL_PART_OF, "")
        parent = pcs_lookup(pcs_name) if pcs_name else None
        if parent is not None and (
            parent.metadata.annotations.get(constants.ANNOTATION_DISABLE_PROTECTION)
            == "true"
        ):
            return _review_response(uid, True)
    try:
        chain.admit_managed_mutation(username, kind, meta.get("name", ""))
    except PermissionError as e:
        return _review_response(uid, False, message=str(e))
    return _review_response(uid, True)


def handle_validate(body: dict, chain: AdmissionChain) -> dict:
    """Validating webhook endpoint body → AdmissionReview response."""
    uid, operation, obj, old = _review_request(body)
    if operation == "DELETE":
        return _review_response(uid, True)
    if not isinstance(obj, dict):
        return _review_response(uid, False, message="request.object missing")
    try:
        new_pcs = PodCliqueSet.from_dict(copy.deepcopy(obj))
        old_pcs = (
            PodCliqueSet.from_dict(copy.deepcopy(old))
            if operation == "UPDATE" and isinstance(old, dict)
            else None
        )
        chain.admit_podcliqueset(new_pcs, old=old_pcs)
    except AdmissionError as e:
        return _review_response(uid, False, message=str(e))
    except Exception as e:
        return _review_response(uid, False, message=f"malformed PodCliqueSet: {e}")
    return _review_response(uid, True)
