"""Functional ops of the port."""

from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["cross_entropy", "flash_attention", "rms_norm",
           "scaled_dot_product_attention"]
