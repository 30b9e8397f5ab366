"""Stream-plan -> batch-plan translation (the port's own copy of the JAX
package's `batch/from_stream.py`).

The SQL frontend plans once (binder + stream lowering in `sql/planner.py`
— the reference's logical plan); a batch query then converts that tree
to batch executors (`to_batch`, the reference's
`optimizer/plan_node/logical_*.rs` batch lowering). Stateless operators
(project/filter/hop-window/expand/row-id) are engine-agnostic and run
as-is over the batch stream; stateful ones (agg, join, top-n, dedup) map
to their batch twins. Returns None when a node has no batch form yet —
the caller falls back to replaying the plan as a bounded stream.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from .executor import (BatchExecutor, BatchHashAgg, BatchHashJoin,
                       BatchSimpleAgg, BatchUnion, SeqScan, StatelessWrap)


def translate_stream_plan(e: Any,
                          scan_of: Callable[[Any], Optional[BatchExecutor]]
                          ) -> Optional[BatchExecutor]:
    """Map a planned stream executor tree to batch executors.

    `scan_of(source_executor)` supplies the snapshot SeqScan for a leaf
    (the caller knows where the pinned chunks live)."""
    from ..ops.agg import (HashAggExecutor, SimpleAggExecutor,
                           StatelessSimpleAggExecutor)
    from ..ops.device_agg import DeviceHashAggExecutor
    from ..ops.device_join import DeviceHashJoinExecutor
    from ..ops.join import HashJoinExecutor, JoinType
    from ..ops.simple import (ExpandExecutor, FilterExecutor,
                              ProjectExecutor, RowIdGenExecutor,
                              UnionExecutor, ValuesExecutor)
    from ..ops.source import SourceExecutor
    from ..ops.topn import AppendOnlyDedupExecutor, TopNExecutor
    from ..ops.window import HopWindowExecutor

    def rec(node: Any) -> Optional[BatchExecutor]:
        if isinstance(node, SourceExecutor):
            return scan_of(node)
        if isinstance(node, RowIdGenExecutor):
            # snapshot rows already carry their ids; the generator only
            # matters for live DML — but batch scans feed fresh chunks
            # through it so NULL ids (none in snapshots) would stay NULL
            inner = rec(node.input)
            return None if inner is None else StatelessWrap(inner, node)
        if isinstance(node, (ProjectExecutor, FilterExecutor,
                             HopWindowExecutor, ExpandExecutor,
                             AppendOnlyDedupExecutor)):
            # Dedup is stateful across barriers but a freshly planned
            # instance over a finite batch behaves identically
            inner = rec(node.input)
            return None if inner is None else StatelessWrap(inner, node)
        if isinstance(node, (HashAggExecutor, DeviceHashAggExecutor)):
            inner = rec(node.input)
            if inner is None:
                return None
            return BatchHashAgg(inner, node.group_key_indices, node.calls)
        if isinstance(node, SimpleAggExecutor):
            inner = rec(node.input)
            return None if inner is None else BatchSimpleAgg(inner,
                                                             node.calls)
        if isinstance(node, StatelessSimpleAggExecutor):
            inner = rec(node.input)
            return None if inner is None else BatchSimpleAgg(inner,
                                                             node.calls)
        if isinstance(node, HashJoinExecutor):
            left = rec(node.left_exec)
            right = rec(node.right_exec)
            if left is None or right is None:
                return None
            return BatchHashJoin(left, right,
                                 node.sides["l"].key_indices,
                                 node.sides["r"].key_indices,
                                 node.join_type, node.condition)
        if isinstance(node, DeviceHashJoinExecutor):
            left = rec(node.left_exec)
            right = rec(node.right_exec)
            if left is None or right is None:
                return None
            return BatchHashJoin(left, right, node.key_idx["a"],
                                 node.key_idx["b"], JoinType.INNER,
                                 node.condition)
        if isinstance(node, UnionExecutor):
            subs = [rec(i) for i in node.inputs]
            if any(s is None for s in subs):
                return None
            return BatchUnion(subs)
        # TopN / group-TopN / dedup / over-window / EOWC and anything
        # unknown: no batch form here yet
        return None

    return rec(e)
