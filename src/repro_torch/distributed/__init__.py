"""Distribution substrate of the port: the shard layout of a solve and
the one-device data mesh its shards live on (port of the
``repro/distributed`` subset the solvers need)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    DataMesh,
    ShardedOperator,
    ShardLayout,
    make_data_mesh,
    place_state,
    shard_problem,
)
