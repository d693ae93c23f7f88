"""Hand-written Hopper kernels of the port, one module per TPU kernel.

- ``paged_attention``: K5, ragged paged attention (CUDA C++, sm_90a,
  ``csrc/paged_attention.cu``), replacing
  ``paddle_tpu/ops/pallas/paged_attention.py``.
- ``rms_norm``: K6, RMSNorm forward (CUDA C++, sm_90a,
  ``csrc/rms_norm.cu``), replacing
  ``paddle_tpu/ops/pallas/rms_norm.py``, with the autograd Function
  whose backward is plain PyTorch (XLA code in the JAX package).
- ``flash_attention``: K1/K3 (forward) and K2/K4 (dq and dkv), flash
  attention (CUDA C++, sm_90a, ``csrc/flash_attention.cu``), replacing
  ``paddle_tpu/ops/pallas/flash_attention.py``, with the autograd
  Function around them.
- ``resnet_unit``: K7 (fused 1x1 conv + BatchNorm statistics, with the
  previous BatchNorm's scale/shift as prologue) and K8 (the same for the
  3x3 conv), forward and backward (CUDA C++, sm_90a,
  ``csrc/resnet_unit.cu``), replacing
  ``paddle_tpu/ops/pallas/resnet_unit.py``, with their autograd
  Functions.
- ``bn_stats``: K9, BatchNorm statistics (CUDA C++, sm_90a,
  ``csrc/bn_stats.cu``), replacing
  ``paddle_tpu/ops/pallas/bn_stats.py``, with the autograd Function
  whose backward is plain PyTorch.
- ``int8_matmul``: K10, the weight-only int8 matmul of
  ``quantize_for_decode`` (CUDA C++, sm_90a, ``csrc/int8_matmul.cu``).
  It replaces no Pallas kernel: XLA fuses the JAX package's
  ``(x @ convert(q)) * s`` (``paddle_tpu/distributed/fleet/mpu.py``
  ``_int8_matmul``), which PyTorch would run as a dense bf16 copy of
  every weight.

Each module holds the kernel's wrapper with its launch counter
(``<wrapper>.launches``) and the plain PyTorch version of the same
function. Nothing here builds or imports a compiler when imported.
"""
