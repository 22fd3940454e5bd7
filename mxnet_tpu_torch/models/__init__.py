"""Model zoo: the Llama family."""
from .convert import load_jax_params
from .llama import (LlamaForCausalLM, LlamaModel, RMSNormBlock, get_llama,
                    llama3_8b, llama_tiny)

__all__ = ["LlamaForCausalLM", "LlamaModel", "RMSNormBlock", "get_llama",
           "llama3_8b", "llama_tiny", "load_jax_params"]
