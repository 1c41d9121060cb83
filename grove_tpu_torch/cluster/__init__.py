"""External cluster sources (grove_tpu/cluster counterpart): the watch
driver and the KWOK fabricated fleet. The kube-apiserver source is not
ported yet."""

from grove_tpu_torch.cluster.kwok import KwokCluster  # noqa: F401
from grove_tpu_torch.cluster.watch import EventType, WatchDriver, WatchEvent  # noqa: F401
