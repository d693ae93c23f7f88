"""Loss functions (port of ``nn/functional/loss.py``: the subset of
``cross_entropy`` that Llama training uses).

Integer class labels along the last axis, ``ignore_index`` and the
``mean`` reduction, with the log-softmax in f32. Soft labels, class
weights, label smoothing, ``use_softmax=False`` and the other reductions
are not ported yet and raise.
"""

from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Mean cross-entropy of ``input [..., classes]`` logits against
    integer ``label [...]`` (or ``[..., 1]``), over the labels that are
    not ``ignore_index`` (divided by at least one)."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing or axis not in (-1, input.dim() - 1)
            or reduction != "mean"):
        raise NotImplementedError(
            "the port's cross_entropy takes integer labels over the last "
            "axis and reduction='mean', with no class weights, soft labels "
            "or smoothing")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    logp = torch.log_softmax(input.float(), dim=-1)
    safe = label.clamp(0, input.shape[-1] - 1).long()
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    valid = label != ignore_index
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return loss.sum() / valid.sum().clamp(min=1).float()
