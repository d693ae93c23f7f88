"""Layers of the port: the subset the ResNet and transformer models use
and the twelve loss layers of ``nn/layer/loss.py``. Containers are
``torch.nn.Sequential``, whose parameter names match the JAX package's
(``layer1.0.conv1.weight``)."""

from torch.nn import Sequential

from .activation import ReLU
from .common import Linear
from .conv import Conv2D
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MSELoss, MarginRankingLoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "BCELoss", "BCEWithLogitsLoss", "BatchNorm2D",
           "Conv2D", "CosineEmbeddingLoss", "CrossEntropyLoss",
           "HingeEmbeddingLoss", "KLDivLoss", "L1Loss", "LayerNorm", "Linear",
           "MSELoss", "MarginRankingLoss", "MaxPool2D", "NLLLoss", "ReLU",
           "Sequential", "SmoothL1Loss", "TripletMarginLoss"]
