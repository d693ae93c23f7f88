"""Loss functions (port of ``nn/functional/loss.py``).

Every function of the JAX module, term by term: ``cross_entropy`` with
class weights, soft labels, ``label_smoothing``, ``use_softmax=False``,
any axis and the ``none``/``sum``/``mean`` reductions (the log-softmax
in f32), ``softmax_with_cross_entropy``, ``nll_loss``, ``mse_loss``,
``l1_loss``, ``smooth_l1_loss``, ``binary_cross_entropy(_with_logits)``,
``kl_div``, ``hinge_embedding_loss``, ``margin_ranking_loss``,
``cosine_embedding_loss``, ``triplet_margin_loss``, ``log_loss``,
``square_error_cost`` and ``sigmoid_focal_loss``. Plain PyTorch, which
autograd differentiates: the JAX package's are XLA code. The Llama
LM-head loss fused with the head's matmul is
``models.llama.fused_head_cross_entropy``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...ops.registry import named_op


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


@named_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross-entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) against ``label`` along ``axis``, in f32.

    Soft labels (``soft_label``, or a floating ``label`` of ``input``'s
    shape): ``-sum(label * logp)``, smoothed toward ``1 / classes``, then
    reduced; ``weight`` and ``ignore_index`` do not apply. Integer labels
    (with or without the class axis): ``-logp[label]`` (smoothed:
    ``-(1 - e) * logp[label] - e * mean(logp)``), 0 where the label is
    ``ignore_index``, times ``weight[label]``; ``mean`` divides by the
    summed weights of the kept labels (at least 1e-12), or without
    weights by their count (at least one)."""
    ax = axis % input.dim()
    x = input.float()
    if use_softmax:
        logp = torch.log_softmax(x, dim=ax)
    else:
        logp = torch.log(torch.clamp(x, min=1e-30))
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape
                      and label.is_floating_point()):
        soft = label.float()
        if label_smoothing > 0.0:
            k = input.shape[ax]
            soft = (1 - label_smoothing) * soft + label_smoothing / k
        return _reduce(-(soft * logp).sum(dim=ax), reduction)
    ids = label.squeeze(ax) if label.dim() == input.dim() else label
    safe = ids.clamp(0, input.shape[ax] - 1).long()
    picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0.0:
        loss = (-(1 - label_smoothing) * picked
                - label_smoothing * logp.mean(dim=ax))
    else:
        loss = -picked
    mask = ids != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            denom = torch.where(mask, w, torch.zeros_like(w)).sum()
            return loss.sum() / torch.clamp(denom, min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.sum().float(), min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False):
    """``cross_entropy(reduction="none")`` with the class axis kept (of
    size 1); with ``return_softmax``, also the softmax of ``logits``."""
    loss = cross_entropy(logits, label, soft_label=soft_label, axis=axis,
                         ignore_index=ignore_index, reduction="none")
    loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


@named_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """``input`` holds log-probabilities (``[N, C]``, ``[C]`` or spatial
    ``[N, C, d1, ...]``); the loss picks ``-input[label]`` along the class
    axis, weighted, 0 at ``ignore_index``; ``mean`` divides by the summed
    weights of the kept labels (at least 1e-12)."""
    ax = 1 if input.dim() > 1 else 0
    lbl = label.long()
    safe = lbl.clamp(0, input.shape[ax] - 1)
    picked = input.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    valid = (lbl != ignore_index).to(input.dtype)
    wv = (torch.ones_like(picked) if weight is None
          else weight.reshape(-1)[safe])
    wv = wv * valid
    losses = -picked * wv
    if reduction == "mean":
        return losses.sum() / torch.clamp(wv.sum(), min=1e-12)
    if reduction == "sum":
        return losses.sum()
    return losses


@named_op("mse_loss")
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@named_op("l1_loss")
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


@named_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    out = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(out, reduction)


@named_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """``input`` holds probabilities, clipped to [1e-12, 1 - 1e-12] in
    f32."""
    p = torch.clamp(input.float(), 1e-12, 1 - 1e-12)
    out = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


@named_op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """From logits, in f32: ``max(z, 0) - z * t + log(1 + exp(-|z|))``,
    or with ``pos_weight``
    ``-(pos_weight * t * log_sigmoid(z) + (1 - t) * log_sigmoid(-z))``."""
    z = logit.float()
    if pos_weight is not None:
        out = -(pos_weight * label * tF.logsigmoid(z)
                + (1 - label) * tF.logsigmoid(-z))
    else:
        out = (torch.clamp(z, min=0) - z * label
               + torch.logaddexp(torch.zeros_like(z), -torch.abs(z)))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


@named_op("kl_div")
def kl_div(input, label, reduction="mean"):
    """``label * (log(label) - input)`` with ``input`` log-probabilities;
    ``batchmean`` divides the sum by the first dimension."""
    out = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


@named_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    out = torch.where(label == 1, input, torch.clamp(margin - input, min=0))
    return _reduce(out, reduction)


@named_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    out = torch.clamp(-label * (input - other) + margin, min=0)
    return _reduce(out, reduction)


@named_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    out = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0))
    return _reduce(out, reduction)


@named_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def dist(u, v):
        return torch.pow(torch.pow(torch.abs(u - v) + epsilon, p).sum(-1),
                         1.0 / p)

    d_ap = dist(input, positive)
    d_an = dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    out = torch.clamp(d_ap - d_an + margin, min=0)
    return _reduce(out, reduction)


@named_op("log_loss")
def log_loss(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


@named_op("square_error_cost")
def square_error_cost(input, label):
    return torch.square(input - label)


@named_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    """``alpha_t * (1 - p_t)^gamma * bce(logit, label)``, divided by
    ``normalizer`` when one is given."""
    p = torch.sigmoid(logit.float())
    ce = (torch.clamp(logit, min=0) - logit * label
          + torch.logaddexp(torch.zeros_like(logit), -torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)
