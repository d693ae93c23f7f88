"""Operators of the port; the kernels live in ``ops/hopper``."""
