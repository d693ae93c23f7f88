"""Models of the port."""

from .generation import cached_attention, generate_with_cache
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "cached_attention",
           "generate_with_cache"]
