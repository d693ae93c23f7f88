"""Optimizers of the port (port of ``optimizer/``): the optimizer base,
eleven optimizers and the learning-rate schedulers (``optimizer.lr``).
``LBFGS`` is not ported yet."""

from . import lr
from .optimizer import Optimizer
from .optimizers import (ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Momentum, RMSProp, Rprop)

__all__ = ["ASGD", "SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "Lamb", "Momentum", "Optimizer", "RMSProp", "Rprop", "lr"]
