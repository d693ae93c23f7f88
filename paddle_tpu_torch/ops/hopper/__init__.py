"""Hand-written Hopper kernels of the port, one module per TPU kernel.

- ``paged_attention``: K5, ragged paged attention (CUDA C++, sm_90a,
  ``csrc/paged_attention.cu``), replacing
  ``paddle_tpu/ops/pallas/paged_attention.py``.
- ``rms_norm``: K6, RMSNorm forward (Triton), replacing
  ``paddle_tpu/ops/pallas/rms_norm.py``.

Each module holds the kernel's wrapper with its launch counter
(``<wrapper>.launches``) and the plain PyTorch version of the same
function. Nothing here builds or imports a compiler when imported.
"""
