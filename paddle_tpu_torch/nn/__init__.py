"""Neural-network functions and layers of the port."""

from . import functional, initializer, layer
from .layer import (AdaptiveAvgPool2D, BCELoss, BCEWithLogitsLoss, BatchNorm2D,
                    Conv2D, CosineEmbeddingLoss, CrossEntropyLoss, GroupNorm,
                    Hardswish, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                    LayerNorm, Linear, LogSigmoid, MSELoss, MarginRankingLoss,
                    MaxPool2D, Mish, NLLLoss, ReLU, ReLU6, Sequential,
                    Sigmoid, Silu, SmoothL1Loss, Softsign, Swish, Tanh,
                    Tanhshrink, TripletMarginLoss, Upsample)
from .layer import __all__ as _layers

__all__ = [*_layers, "functional", "initializer", "layer"]
