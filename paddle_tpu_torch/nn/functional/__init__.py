"""Functional ops of the port."""

from .activation import relu
from .common import linear
from .conv import conv2d
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, hinge_embedding_loss,
                   kl_div, l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import batch_norm, ema_update_stats, rms_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "batch_norm", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "conv2d",
           "cosine_embedding_loss", "cross_entropy", "ema_update_stats",
           "flash_attention", "hinge_embedding_loss", "kl_div", "l1_loss",
           "linear", "log_loss", "margin_ranking_loss", "max_pool2d",
           "mse_loss", "nll_loss", "relu", "rms_norm",
           "scaled_dot_product_attention", "sigmoid_focal_loss",
           "smooth_l1_loss", "softmax_with_cross_entropy",
           "square_error_cost", "triplet_margin_loss"]
