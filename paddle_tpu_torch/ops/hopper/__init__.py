"""Hand-written Hopper kernels of the port, one module per TPU kernel.

- ``paged_attention``: K5, ragged paged attention (CUDA C++, sm_90a,
  ``csrc/paged_attention.cu``), replacing
  ``paddle_tpu/ops/pallas/paged_attention.py``.
- ``rms_norm``: K6, RMSNorm forward (Triton), replacing
  ``paddle_tpu/ops/pallas/rms_norm.py``, with the autograd Function
  whose backward is plain PyTorch (XLA code in the JAX package).
- ``flash_attention``: K1/K3 (forward) and K2/K4 (dq and dkv), flash
  attention (CUDA C++, sm_90a, ``csrc/flash_attention.cu``), replacing
  ``paddle_tpu/ops/pallas/flash_attention.py``, with the autograd
  Function around them.

Each module holds the kernel's wrapper with its launch counter
(``<wrapper>.launches``) and the plain PyTorch version of the same
function. Nothing here builds or imports a compiler when imported.
"""
