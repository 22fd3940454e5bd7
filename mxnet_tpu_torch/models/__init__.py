"""Model zoo: the Llama family (with beam search), BERT and the GluonTS
forecasters (DeepAR, TransformerForecaster)."""
from .bert import (BERTForPretrain, BERTModel, bert_base, bert_large,
                   bert_small, get_bert)
from .convert import (load_jax_bert_params, load_jax_gluon_params,
                      load_jax_params)
from .forecast import DeepAR, TransformerForecaster, gaussian_nll
from .llama import (LlamaForCausalLM, LlamaModel, RMSNormBlock, get_llama,
                    llama3_8b, llama_tiny)
from .nmt import BeamSearchSampler, BeamSearchScorer

__all__ = ["BERTForPretrain", "BERTModel", "BeamSearchSampler",
           "BeamSearchScorer", "DeepAR", "LlamaForCausalLM",
           "LlamaModel", "RMSNormBlock", "TransformerForecaster",
           "bert_base", "bert_large", "bert_small", "gaussian_nll",
           "get_bert", "get_llama", "llama3_8b", "llama_tiny",
           "load_jax_bert_params", "load_jax_gluon_params",
           "load_jax_params"]
