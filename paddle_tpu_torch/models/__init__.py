"""Models of the port."""

from .generation import cached_attention, generate_with_cache
from .llama import (LlamaConfig, LlamaForCausalLM, causal_lm_loss,
                    fused_head_cross_entropy, llama_loss_fn)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "cached_attention",
           "causal_lm_loss", "fused_head_cross_entropy",
           "generate_with_cache", "llama_loss_fn"]
