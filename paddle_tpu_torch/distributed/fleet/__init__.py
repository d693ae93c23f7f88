"""Fleet layers of the port: the mp=1 dense forms of the model-parallel
layers (with the weight-only int8 branch) and activation recomputation."""

from .mpu import ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding
from .recompute import (RecomputeFunction, mark_recompute, recompute,
                        recompute_hybrid, recompute_sequential)

__all__ = ["ColumnParallelLinear", "RecomputeFunction", "RowParallelLinear",
           "VocabParallelEmbedding", "mark_recompute", "recompute",
           "recompute_hybrid", "recompute_sequential"]
