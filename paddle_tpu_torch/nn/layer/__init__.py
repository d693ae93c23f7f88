"""Layers of the port (the subset the ResNet models use). Containers are
``torch.nn.Sequential``, whose parameter names match the JAX package's
(``layer1.0.conv1.weight``)."""

from torch.nn import Sequential

from .activation import ReLU
from .common import Linear
from .conv import Conv2D
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "BatchNorm2D", "Conv2D", "CrossEntropyLoss",
           "Linear", "MaxPool2D", "ReLU", "Sequential"]
