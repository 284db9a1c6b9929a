"""Synthetic data pipeline of the port (``src/repro/data`` ported):
generators and federated partitioning."""
from repro_torch.data import partition, synthetic

__all__ = ["partition", "synthetic"]
