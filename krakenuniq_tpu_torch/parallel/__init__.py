"""Minimizer-range partitioning (out-of-core chunks and mesh shards), the
data x db mesh over torch.distributed and multi-host span sharding.

The mesh module imports torch.distributed; it is imported on use."""

from .partition import ShardedDBPlanes, ShardedHashPlanes, partition_bins_equal_keys, shard_db_planes

__all__ = ["partition_bins_equal_keys", "ShardedDBPlanes", "ShardedHashPlanes", "shard_db_planes"]
