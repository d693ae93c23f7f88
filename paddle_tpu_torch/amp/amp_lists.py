"""Per-op AMP white and black lists (port of ``paddle_tpu/amp/amp_lists.py``,
the same sets).

Ops on the white list compute in the low dtype under ``auto_cast``
(matmul-class products: tensor-core work); ops on the black list stay in
f32 (reductions, softmax, norms, losses: numerically sensitive). The names
are the JAX package's op names, which the port's functional ops record
at their cast point (``ops/registry.py``).
"""

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "flash_attention", "flash_attention_ref", "sdpa", "addmm",
}

BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "reciprocal", "rsqrt", "softmax", "log_softmax", "cross_entropy",
    "bce_with_logits", "binary_cross_entropy", "mse_loss", "l1_loss",
    "kl_div", "layer_norm", "batch_norm", "instance_norm", "group_norm",
    "rms_norm", "local_response_norm", "sum", "mean", "logsumexp",
    "cumsum", "cumprod", "norm", "dist", "cosine_similarity", "softplus",
    "erfinv", "std", "var",
}


def white_list():
    return WHITE_LIST


def black_list():
    return BLACK_LIST
