"""External cluster sources (grove_tpu/cluster counterpart): the watch
driver, the KWOK fabricated fleet and the kube-apiserver source."""

from grove_tpu_torch.cluster.kubernetes import (  # noqa: F401
    KubeContext,
    KubernetesWatchSource,
    load_kube_context,
)
from grove_tpu_torch.cluster.kwok import KwokCluster  # noqa: F401
from grove_tpu_torch.cluster.watch import EventType, WatchDriver, WatchEvent  # noqa: F401
