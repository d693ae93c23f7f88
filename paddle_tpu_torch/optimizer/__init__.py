"""Optimizers of the port (the subset Llama training uses)."""

from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "Optimizer"]
