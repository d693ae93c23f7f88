"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package never
imports it or JAX. Each Pallas TPU kernel on a ported path has a
hand-written Hopper kernel under ``ops/hopper`` beside a plain PyTorch
version of the same function. The tensor's device picks between them:
a CUDA tensor launches the kernel (or raises), a CPU tensor runs the
plain version. Entry points run on the card unless the caller passes
``device="cpu"``.

Ported so far: Llama serving (``models``, ``serving``), with kernels
K5 (ragged paged attention) and K6 (RMSNorm forward), CUDA C++;
single-device Llama training (``models``, ``optimizer``, ``nn.clip``,
``jit.TrainStep``), with the flash-attention forward, dq and dkv kernels
(CUDA C++) and RMSNorm's gradient; single-device ResNet training
(``vision.models``, ``nn`` layers, ``optimizer.Momentum``), with the fused
conv+BatchNorm kernels K7 and K8 and the BatchNorm-statistics kernel K9
(CUDA C++).
"""

from . import flags, vision
from .convert import load_reference_state
from .jit import TrainStep
from .models import LlamaConfig, LlamaForCausalLM, llama_loss_fn
from .serving import ServingEngine

__all__ = ["LlamaConfig", "LlamaForCausalLM", "ServingEngine", "TrainStep",
           "flags", "llama_loss_fn", "load_reference_state", "vision"]
