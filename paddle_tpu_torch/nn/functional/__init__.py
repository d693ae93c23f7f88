"""Functional ops of the port."""

from .activation import relu
from .common import linear
from .conv import conv2d
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy
from .norm import batch_norm, ema_update_stats, rms_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "batch_norm", "conv2d", "cross_entropy",
           "ema_update_stats", "flash_attention", "linear", "max_pool2d",
           "relu", "rms_norm", "scaled_dot_product_attention"]
