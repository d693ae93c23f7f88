"""Loss layers (port of ``nn/layer/loss.py``: ``CrossEntropyLoss``)."""

from __future__ import annotations

from torch import nn

from .. import functional as F


class CrossEntropyLoss(nn.Module):
    """Takes what ``nn.functional.cross_entropy`` takes; the other
    options raise there."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax,
                        label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)
