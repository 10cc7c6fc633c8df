"""Scale-out: posting lists sharded by centroid range over a shard group
(one process, or one rank per shard under torch.distributed), the
data-parallel build step, the streamed build. Counterpart of
``ivfhnsw_tpu/parallel/``."""

from ivfhnsw_tpu_torch.parallel.mesh import (DistributedShards,  # noqa: F401
                                             LocalShards, make_mesh)
from ivfhnsw_tpu_torch.parallel.sharded import ShardedIVFADC  # noqa: F401
from ivfhnsw_tpu_torch.parallel.sharded_grouping import (  # noqa: F401
    ShardedGrouping)
