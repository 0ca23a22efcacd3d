"""DAG authoring: .bind() graphs over actor methods.

Reference: `python/ray/dag/dag_node.py:29`, `input_node.py`,
`output_node.py` — `actor.method.bind(x)` builds a node instead of
executing; `with InputNode() as inp:` marks the per-execution input;
`MultiOutputNode([a, b])` returns multiple leaves.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

_node_counter = itertools.count()


class DAGNode:
    def __init__(self):
        self._id = next(_node_counter)

    def _upstream(self) -> List["DAGNode"]:
        return []


class InputNode(DAGNode):
    """Per-execution input placeholder (reference: `dag/input_node.py`).
    Usable as a context manager for parity with the reference API."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc_info):
        return False


class ClassMethodNode(DAGNode):
    """One actor-method invocation in the graph (reference:
    `dag/class_node.py` ClassMethodNode)."""

    def __init__(self, actor_handle, method_name: str, args: Tuple,
                 kwargs: Dict):
        super().__init__()
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs

    def _upstream(self) -> List[DAGNode]:
        ups = [a for a in self.args if isinstance(a, DAGNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def __repr__(self):
        return f"ClassMethodNode({self.method_name}#{self._id})"


class FunctionNode(DAGNode):
    """One remote-function invocation in a task DAG (reference:
    `dag/function_node.py`) — the node type workflows execute."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict):
        super().__init__()
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    def _upstream(self) -> List[DAGNode]:
        ups = [a for a in self.args if isinstance(a, DAGNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def execute(self, _memo: Optional[Dict[int, Any]] = None):
        """Eager recursive execution (reference: DAGNode.execute).
        Shared nodes (diamond DAGs) run exactly once per execute()."""
        import ray_tpu_torch as rt

        memo: Dict[int, Any] = {} if _memo is None else _memo

        def resolve(v):
            if isinstance(v, FunctionNode):
                if v._id not in memo:
                    memo[v._id] = v.execute(memo)
                return memo[v._id]
            return v

        args = [resolve(a) for a in self.args]
        kwargs = {k: resolve(v) for k, v in self.kwargs.items()}
        return rt.get(self.remote_fn.remote(*args, **kwargs))

    def __repr__(self):
        name = getattr(self.remote_fn, "__name__", "fn")
        return f"FunctionNode({name}#{self._id})"


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one execute() result (reference:
    `dag/output_node.py`)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        self.outputs = list(outputs)

    def _upstream(self) -> List[DAGNode]:
        return list(self.outputs)

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)
