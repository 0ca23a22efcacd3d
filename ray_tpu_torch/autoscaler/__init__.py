"""Autoscaler: demand-driven node lifecycle.

Reference: `python/ray/autoscaler/` — v2 architecture
(`v2/autoscaler.py:42`: declarative reconcile from GCS autoscaler
state) with the v1 `StandardAutoscaler.update()` loop shape
(`_private/autoscaler.py:172,374`) and a `FakeMultiNodeProvider`-style
local provider (`_private/fake_multi_node/node_provider.py:236`) as the
test backend.
"""

from ray_tpu_torch.autoscaler.autoscaler import AutoscalerConfig, StandardAutoscaler
from ray_tpu_torch.autoscaler.gke import GkeNodeProvider
from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider, NodeProvider
from ray_tpu_torch.autoscaler.v2 import (
    AutoscalerV2,
    AutoscalerV2Config,
    InstanceManager,
    NodeTypeConfigV2,
    ResourceDemandScheduler,
)

__all__ = [
    "AutoscalerConfig",
    "AutoscalerV2",
    "AutoscalerV2Config",
    "GkeNodeProvider",
    "InstanceManager",
    "LocalNodeProvider",
    "NodeProvider",
    "NodeTypeConfigV2",
    "ResourceDemandScheduler",
    "StandardAutoscaler",
]
