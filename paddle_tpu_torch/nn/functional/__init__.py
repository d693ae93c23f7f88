"""Functional ops of the port."""

from .norm import rms_norm

__all__ = ["rms_norm"]
