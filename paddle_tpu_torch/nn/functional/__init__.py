"""Functional ops of the port."""

from .activation import (gelu, hardswish, log_sigmoid, logsigmoid, mish,
                         relu, relu6, sigmoid, silu, softsign, swish, tanh,
                         tanhshrink)
from .common import interpolate, linear, upsample
from .conv import conv2d
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, hinge_embedding_loss,
                   kl_div, l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, ema_update_stats, group_norm, layer_norm,
                   rms_norm)
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "batch_norm", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "conv2d",
           "cosine_embedding_loss", "cross_entropy", "ema_update_stats",
           "flash_attention", "gelu", "group_norm", "hardswish",
           "hinge_embedding_loss", "interpolate", "kl_div", "l1_loss",
           "layer_norm", "linear", "log_loss", "log_sigmoid", "logsigmoid",
           "margin_ranking_loss", "max_pool2d", "mish", "mse_loss",
           "nll_loss", "relu", "relu6", "rms_norm",
           "scaled_dot_product_attention", "sigmoid", "sigmoid_focal_loss",
           "silu", "smooth_l1_loss", "softmax_with_cross_entropy",
           "softsign", "square_error_cost", "swish", "tanh", "tanhshrink",
           "triplet_margin_loss", "upsample"]
