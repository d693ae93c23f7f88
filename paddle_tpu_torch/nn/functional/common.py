"""Common functions (port of ``nn/functional/common.py``: ``linear``)."""

from __future__ import annotations


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with Paddle's ``[in, out]`` weight; the
    product is rounded to the input dtype before the bias is added, as
    in the JAX package."""
    out = x @ weight
    return out if bias is None else out + bias
