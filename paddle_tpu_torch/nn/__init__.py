"""Neural-network functions and layers of the port."""

from . import functional, layer
from .layer import (AdaptiveAvgPool2D, BCELoss, BCEWithLogitsLoss, BatchNorm2D,
                    Conv2D, CosineEmbeddingLoss, CrossEntropyLoss,
                    HingeEmbeddingLoss, KLDivLoss, L1Loss, Linear, MSELoss,
                    MarginRankingLoss, MaxPool2D, NLLLoss, ReLU, Sequential,
                    SmoothL1Loss, TripletMarginLoss)

__all__ = ["AdaptiveAvgPool2D", "BCELoss", "BCEWithLogitsLoss", "BatchNorm2D",
           "Conv2D", "CosineEmbeddingLoss", "CrossEntropyLoss",
           "HingeEmbeddingLoss", "KLDivLoss", "L1Loss", "Linear", "MSELoss",
           "MarginRankingLoss", "MaxPool2D", "NLLLoss", "ReLU", "Sequential",
           "SmoothL1Loss", "TripletMarginLoss", "functional", "layer"]
