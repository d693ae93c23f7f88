"""Optimizers of the port (the subset Llama and ResNet training use)."""

from .optimizer import Optimizer
from .optimizers import Adam, AdamW, Momentum

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer"]
