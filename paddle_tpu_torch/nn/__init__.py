"""Neural-network functions and layers of the port."""

from . import functional, layer
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss,
                    Linear, MaxPool2D, ReLU, Sequential)

__all__ = ["AdaptiveAvgPool2D", "BatchNorm2D", "Conv2D", "CrossEntropyLoss",
           "Linear", "MaxPool2D", "ReLU", "Sequential", "functional",
           "layer"]
