"""Training step of the port."""

from .train_step import TrainStep

__all__ = ["TrainStep"]
