"""Models of the port: Llama, GPT, BERT, DiT and the Stable-Diffusion
UNet."""

from .bert import BertConfig, BertForPretraining, BertModel
from .dit import DiT, DiTConfig, dit_loss_fn
from .generation import (cached_attention, generate_with_cache,
                         quantize_for_decode)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaConfig, LlamaForCausalLM, causal_lm_loss,
                    fused_head_cross_entropy, llama_loss_fn)
from .unet import (UNet2DConditionModel, UNetConfig, sd_loss_fn,
                   timestep_embedding)

__all__ = ["BertConfig", "BertForPretraining", "BertModel", "DiT", "DiTConfig",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "LlamaConfig",
           "LlamaForCausalLM", "UNet2DConditionModel", "UNetConfig",
           "cached_attention", "causal_lm_loss", "dit_loss_fn",
           "fused_head_cross_entropy", "generate_with_cache", "llama_loss_fn",
           "quantize_for_decode", "sd_loss_fn", "timestep_embedding"]
