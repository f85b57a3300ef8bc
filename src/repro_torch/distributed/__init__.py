"""Distribution substrate of the port: the logical shard layout of a
solve (port of the ``repro/distributed`` subset the service needs)."""
from repro_torch.distributed.sharding import ShardLayout  # noqa: F401
