"""Data substrate of the port: :class:`PartitionedDataset` (a copy of the
reference's numpy-only dataset), disk-sharded datasets
(:mod:`~distkeras_torch.data.shard_io`), text corpora
(:mod:`~distkeras_torch.data.text`) and the Spark ingest adapter."""

from distkeras_torch.data.dataset import PartitionedDataset  # noqa: F401
from distkeras_torch.data.spark_adapter import (  # noqa: F401
    dataset_from_spark,
    dataset_from_spark_session,
    spark_available,
)
from distkeras_torch.data.shard_io import (  # noqa: F401
    ShardedDataset,
    write_shards,
)

__all__ = ["PartitionedDataset", "ShardedDataset", "dataset_from_spark",
           "dataset_from_spark_session", "spark_available", "write_shards"]
