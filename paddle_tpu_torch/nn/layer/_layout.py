"""Layer-level channel-last compute (port of ``nn/layer/_layout.py``).

The 2-D conv, norm and pool layers keep their NCHW API but compute
channel-last: permute in, run the functional with
``data_format="NHWC"``, permute back. The permutes are views, so a
channel-last body costs no copies at its layer edges. Models that pass
``data_format="NHWC"`` themselves (ResNet computes channel-last
throughout) are untouched: the layer sees NHWC and passes through. The
JAX package makes this a flag (``layout_autotune``, on by default); the
port always computes channel-last, which gives the same function.
"""

from __future__ import annotations


def nhwc_compute(x, data_format, fn):
    """Run ``fn(x, data_format)`` channel-last. Applies only to 4-D NCHW
    inputs; ``fn`` returns one tensor."""
    if data_format != "NCHW" or x.dim() != 4:
        return fn(x, data_format)
    out = fn(x.permute(0, 2, 3, 1), "NHWC")
    return out.permute(0, 3, 1, 2)
