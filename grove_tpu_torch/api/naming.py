"""Deterministic resource naming, parity with operator/api/common/namegen.go.

Scheme (docs/user-guide/02_pod-and-resource-naming-conventions/02_naming-conventions.md):
  headless service       <pcs>-<i>                      (namegen.go:34-36)
  PodClique (standalone) <pcs>-<i>-<clique>             (namegen.go:70-72)
  PCSG                   <pcs>-<i>-<sg>                 (namegen.go:76-78)
  PodClique (in PCSG)    <pcs>-<i>-<sg>-<j>-<clique>    (PCSG FQN as owner)
  base PodGang           <pcs>-<i>                      (namegen.go:82-84)
  scaled PodGang         <pcsgFQN>-<k>  k = j - minAvailable  (namegen.go:88-115)
  pod                    <pclqFQN>-<5char-suffix>; hostname <pclqFQN>-<idx>

The port's copy of grove_tpu/api/naming.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import random
import string

from grove_tpu_torch.api.types import PodCliqueScalingGroup, PodCliqueSet

GROUP = "grove.io"

_SUFFIX_ALPHABET = string.ascii_lowercase + string.digits


def headless_service_name(pcs_name: str, replica: int) -> str:
    return f"{pcs_name}-{replica}"


def headless_service_address(pcs_name: str, replica: int, namespace: str) -> str:
    return f"{headless_service_name(pcs_name, replica)}.{namespace}.svc.cluster.local"


def pod_role_name(pcs_name: str) -> str:
    return f"{GROUP}:pcs:{pcs_name}"


def pod_role_binding_name(pcs_name: str) -> str:
    return f"{GROUP}:pcs:{pcs_name}"


def pod_service_account_name(pcs_name: str) -> str:
    return pcs_name


def initc_sa_token_secret_name(pcs_name: str) -> str:
    return f"{pcs_name}-initc-sa-token-secret"


def podclique_name(owner_name: str, owner_replica: int, clique_template_name: str) -> str:
    """Owner is the PCS (standalone cliques) or the PCSG FQN (member cliques)."""
    return f"{owner_name}-{owner_replica}-{clique_template_name}"


def scaling_group_name(pcs_name: str, pcs_replica: int, sg_config_name: str) -> str:
    return f"{pcs_name}-{pcs_replica}-{sg_config_name}"


def base_podgang_name(pcs_name: str, pcs_replica: int) -> str:
    return f"{pcs_name}-{pcs_replica}"


def scaled_podgang_name(pcsg_fqn: str, scaled_index: int) -> str:
    """scaled_index is 0-based, counted from PCSG replica minAvailable upward."""
    return f"{pcsg_fqn}-{scaled_index}"


def podgang_name_for_pcsg_replica(
    pcs: PodCliqueSet, pcs_replica: int, pcsg: PodCliqueScalingGroup, pcsg_replica: int
) -> str:
    """PCSG replicas [0, minAvailable) belong to the base gang; the rest each get
    a scaled gang indexed from 0 (namegen.go:100-115)."""
    min_available = pcsg.spec.min_available
    if pcsg_replica < min_available:
        return base_podgang_name(pcs.metadata.name, pcs_replica)
    return scaled_podgang_name(pcsg.metadata.name, pcsg_replica - min_available)


def extract_sg_name_from_fqn(pcsg_fqn: str, pcs_name: str, pcs_replica: int) -> str:
    prefix = f"{pcs_name}-{pcs_replica}-"
    return pcsg_fqn[len(prefix):]


def pod_name(pclq_fqn: str, rng: random.Random | None = None) -> str:
    """Pod object name: clique FQN + random 5-char suffix (k8s generateName style)."""
    r = rng or random
    suffix = "".join(r.choice(_SUFFIX_ALPHABET) for _ in range(5))
    return f"{pclq_fqn}-{suffix}"


def pod_hostname(pclq_fqn: str, pod_index: int) -> str:
    """Stable DNS hostname: clique FQN + stable index
    (podclique/components/pod/pod.go:262-269)."""
    return f"{pclq_fqn}-{pod_index}"
