"""Stream executors (reference: `src/stream/src/executor/`).

The port's own copies of the JAX package's host executors (`simple`,
`agg`, `join`, `topn`, `watermark`, `window`, `misc`, `project_set`,
`exchange`, the asof / temporal / lookup joins), beside the executor
protocol, the source and materialize executors, and the two
per-operator device executors. Host executors stay numpy and Python, as
in the JAX package; the device executors run on the card.
"""
from .executor import Executor, SharedStream, UnaryExecutor
from .materialize import BatchScan, ConflictBehavior, MaterializeExecutor
from .message import (Barrier, BarrierKind, Message, Mutation, MutationKind,
                      Watermark, is_chunk)
from .simple import (ExpandExecutor, FilterExecutor, ProjectExecutor,
                     RowIdGenExecutor, UnionExecutor, ValuesExecutor)
from .exchange import (Channel, ChannelSource, DispatchExecutor,
                       FragmentPump, MergeExecutor, ThreadedChannel)
from .source import (BarrierInjector, BarrierSource, SourceExecutor,
                     SourceReader)
from .agg import (HashAggExecutor, SimpleAggExecutor,
                  StatelessSimpleAggExecutor)
from .device_agg import DeviceHashAggExecutor, device_agg_eligible
from .device_join import DeviceHashJoinExecutor
from .join import HashJoinExecutor, JoinType
from .topn import AppendOnlyDedupExecutor, TopNExecutor
from .watermark import WatermarkFilterExecutor
from .window import HopWindowExecutor, OverWindowExecutor, WindowFuncCall
from .misc import (ChangelogExecutor, DynamicFilterExecutor, NowExecutor,
                   SortExecutor)
from .project_set import (BoundTableFunction, ProjectSetExecutor,
                          TableFunctionScanExecutor)
from .asof_join import AsOfJoinExecutor
from .lookup_join import LookupJoinExecutor
from .temporal_join import TemporalJoinExecutor

__all__ = [
    "Executor", "SharedStream", "UnaryExecutor", "BatchScan",
    "ConflictBehavior", "MaterializeExecutor", "Barrier", "BarrierKind",
    "Message", "Mutation", "MutationKind", "Watermark", "is_chunk",
    "ExpandExecutor", "FilterExecutor", "ProjectExecutor",
    "RowIdGenExecutor", "UnionExecutor", "ValuesExecutor",
    "BarrierInjector", "BarrierSource", "SourceExecutor", "SourceReader",
    "HashAggExecutor", "SimpleAggExecutor", "StatelessSimpleAggExecutor",
    "DeviceHashAggExecutor", "device_agg_eligible",
    "DeviceHashJoinExecutor",
    "HashJoinExecutor", "JoinType", "AppendOnlyDedupExecutor", "TopNExecutor",
    "HopWindowExecutor", "OverWindowExecutor", "WindowFuncCall",
    "WatermarkFilterExecutor", "Channel", "ChannelSource",
    "DispatchExecutor", "FragmentPump", "MergeExecutor", "ThreadedChannel",
    "ChangelogExecutor", "DynamicFilterExecutor", "NowExecutor",
    "SortExecutor", "BoundTableFunction", "ProjectSetExecutor",
    "TableFunctionScanExecutor", "AsOfJoinExecutor", "LookupJoinExecutor",
    "TemporalJoinExecutor",
]
