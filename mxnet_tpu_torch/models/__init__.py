"""Model zoo: the Llama family, BERT, the GluonTS forecasters (DeepAR,
TransformerForecaster) and Transformer NMT with beam search."""
from .bert import (BERTForPretrain, BERTModel, bert_base, bert_large,
                   bert_small, get_bert)
from .convert import (load_jax_bert_params, load_jax_gluon_params,
                      load_jax_params)
from .forecast import DeepAR, TransformerForecaster, gaussian_nll
from .llama import (LlamaForCausalLM, LlamaModel, RMSNormBlock, get_llama,
                    llama3_8b, llama_tiny)
from .nmt import (BeamSearchSampler, BeamSearchScorer, TransformerNMT,
                  get_nmt, nmt_tiny, transformer_en_de_512)

__all__ = ["BERTForPretrain", "BERTModel", "BeamSearchSampler",
           "BeamSearchScorer", "DeepAR", "LlamaForCausalLM",
           "LlamaModel", "RMSNormBlock", "TransformerForecaster",
           "TransformerNMT", "bert_base", "bert_large", "bert_small",
           "gaussian_nll", "get_bert", "get_llama", "get_nmt", "llama3_8b",
           "llama_tiny", "load_jax_bert_params", "load_jax_gluon_params",
           "load_jax_params", "nmt_tiny", "transformer_en_de_512"]
