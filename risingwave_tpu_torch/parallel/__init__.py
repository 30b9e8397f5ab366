"""Parallel execution: vnode-sharded dataflow over a mesh of shards (the
port's own copy of `risingwave_tpu/parallel/`).

The reference's only compute parallelism is streaming data parallelism:
rows hash to one of VNODE_COUNT virtual nodes (CRC32), vnodes map to
parallel actors, and a hash dispatcher + merge executor pair moves rows
between them. Here the parallel units are mesh shards (`mesh.py`): vnode
-> shard is a static contiguous-block map, and the hash exchange is the
`bucket_exchange` kernel (`Mesh.exchange`: one call over every source
shard on one device, the mesh's `all_to_all` over several), at barrier
granularity.
"""
from .mesh import (device_set, make_mesh, shard_of_vnode,  # noqa: F401
                   vnode_block_bounds)
from .sharded_agg import ShardedHashAgg, make_sharded_agg_step  # noqa: F401
