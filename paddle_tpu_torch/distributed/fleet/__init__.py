"""Fleet layers of the port (mp=1 dense forms)."""

from .mpu import ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
