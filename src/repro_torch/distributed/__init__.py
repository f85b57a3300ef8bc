"""Distribution substrate of the port: the shard layout of a solve, the
data mesh its shards live on, and the LM stack's ``(data, model)``
device mesh (port of ``repro/distributed``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    DataMesh,
    DeviceMesh,
    Placed,
    ShardedOperator,
    ShardLayout,
    make_data_mesh,
    make_device_mesh,
    place_state,
    shard_problem,
)
