"""Deterministic resource naming, parity with operator/api/common/namegen.go:

  PodClique (standalone) <pcs>-<i>-<clique>             (namegen.go:70-72)
  PCSG                   <pcs>-<i>-<sg>                 (namegen.go:76-78)
  PodClique (in PCSG)    <pcs>-<i>-<sg>-<j>-<clique>
  base PodGang           <pcs>-<i>                      (namegen.go:82-84)
  scaled PodGang         <pcsgFQN>-<k>  k = j - minAvailable  (namegen.go:88-115)
  pod                    <pclqFQN>-<5char-suffix>
"""

from __future__ import annotations

import random
import string

_SUFFIX_ALPHABET = string.ascii_lowercase + string.digits


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


def pod_name(pclq_fqn: str, rng: random.Random) -> str:
    """Pod object name: clique FQN + random 5-char suffix (k8s generateName style)."""
    suffix = "".join(rng.choice(_SUFFIX_ALPHABET) for _ in range(5))
    return f"{pclq_fqn}-{suffix}"
