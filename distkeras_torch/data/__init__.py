"""Data substrate of the port: :class:`PartitionedDataset`, a copy of
the reference's numpy-only dataset (disk-sharded datasets are not
ported yet, ROADMAP A9b)."""

from distkeras_torch.data.dataset import PartitionedDataset  # noqa: F401

__all__ = ["PartitionedDataset"]
