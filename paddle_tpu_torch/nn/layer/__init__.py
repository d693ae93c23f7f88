"""Layers of the port: the subset the ResNet, transformer and UNet
models use, the simple activations and the twelve loss layers of
``nn/layer/loss.py``. Containers are
``torch.nn.Sequential``, whose parameter names match the JAX package's
(``layer1.0.conv1.weight``)."""

from torch.nn import Sequential

from .activation import (Hardswish, LogSigmoid, Mish, ReLU, ReLU6, Sigmoid,
                         Silu, Softsign, Swish, Tanh, Tanhshrink)
from .common import Linear, Upsample
from .conv import Conv2D
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MSELoss, MarginRankingLoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import BatchNorm2D, GroupNorm, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "BCELoss", "BCEWithLogitsLoss", "BatchNorm2D",
           "Conv2D", "CosineEmbeddingLoss", "CrossEntropyLoss", "GroupNorm",
           "Hardswish", "HingeEmbeddingLoss", "KLDivLoss", "L1Loss",
           "LayerNorm", "Linear", "LogSigmoid", "MSELoss",
           "MarginRankingLoss", "MaxPool2D", "Mish", "NLLLoss", "ReLU",
           "ReLU6", "Sequential", "Sigmoid", "Silu", "SmoothL1Loss",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "TripletMarginLoss",
           "Upsample"]
