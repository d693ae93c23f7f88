"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package never
imports it or JAX. Each Pallas TPU kernel on a ported path has a
hand-written Hopper kernel under ``ops/hopper`` beside a plain PyTorch
version of the same function. The tensor's device picks between them:
a CUDA tensor launches the kernel (or raises), a CPU tensor runs the
plain version. Entry points run on the card unless the caller passes
``device="cpu"``.

Ported so far: Llama serving (``models``, ``serving``, with the prefix
cache and speculative decoding), with kernels
K5 (ragged paged attention) and K6 (RMSNorm forward), CUDA C++;
single-device Llama training (``models``, ``optimizer``, ``nn.clip``,
``jit.TrainStep``), with the flash-attention forward, dq and dkv kernels
(CUDA C++) and RMSNorm's gradient; single-device ResNet training
(``vision.models``, ``nn`` layers, ``optimizer.Momentum``), with the fused
conv+BatchNorm kernels K7 and K8 and the BatchNorm-statistics kernel K9
(CUDA C++). Serving also has the host-RAM KV tier, the robustness
contract, request handoff and fleet publishing, the fleet
(``serving.fleet``: router with self-healing replicas, autoscaler,
disaggregated prefill/decode, live migration), and the ``telemetry``
package (metric families, spans, flight recorder, request timelines,
exporters, cross-rank aggregation; off by default). Weight-only int8
serving (``models.quantize_for_decode``) runs the int8 matmul kernel K10
(CUDA C++); training has per-layer recompute
(``distributed.fleet.recompute``), the learning-rate schedulers
(``optimizer.lr``), eleven optimizers with an eager ``step()`` and the
loss functions and layers of ``nn``.
"""

from . import flags, nn, optimizer, telemetry, vision
from .convert import load_reference_state
from .jit import TrainStep
from .models import (LlamaConfig, LlamaForCausalLM, llama_loss_fn,
                     quantize_for_decode)
from .serving import ServingEngine

__all__ = ["LlamaConfig", "LlamaForCausalLM", "ServingEngine", "TrainStep",
           "flags", "llama_loss_fn", "load_reference_state", "nn",
           "optimizer", "quantize_for_decode", "telemetry", "vision"]
