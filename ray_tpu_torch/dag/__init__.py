"""Compiled actor DAGs (reference: `python/ray/dag/` +
`python/ray/experimental/channel/` — "accelerated DAGs").

Author with `actor.method.bind(...)` under a `with InputNode() as inp:`
block, compile with `.experimental_compile()`, then `execute()` per
input: data moves over shared-memory ring channels between resident
per-actor exec loops, bypassing the per-call submit/lease path.
"""

from ray_tpu_torch.dag.channel import Channel, ChannelClosed
from ray_tpu_torch.dag.compiled_dag import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "Channel",
    "ChannelClosed",
    "ClassMethodNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "InputNode",
    "MultiOutputNode",
]
