"""Model zoo: the Llama family and BERT."""
from .bert import (BERTForPretrain, BERTModel, bert_base, bert_large,
                   bert_small, get_bert)
from .convert import (load_jax_bert_params, load_jax_gluon_params,
                      load_jax_params)
from .llama import (LlamaForCausalLM, LlamaModel, RMSNormBlock, get_llama,
                    llama3_8b, llama_tiny)

__all__ = ["BERTForPretrain", "BERTModel", "LlamaForCausalLM",
           "LlamaModel", "RMSNormBlock", "bert_base", "bert_large",
           "bert_small", "get_bert", "get_llama", "llama3_8b",
           "llama_tiny", "load_jax_bert_params", "load_jax_gluon_params",
           "load_jax_params"]
