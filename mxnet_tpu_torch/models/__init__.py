"""Model zoo: the Llama family, BERT, the GluonTS forecasters (DeepAR,
TransformerForecaster), Transformer NMT with beam search, semantic
segmentation (FCN, DeepLabV3), the SSD detector, HF safetensors
checkpoints (``hf_loader``) and Llama over a (tp, pp) mesh
(``llama_spmd``)."""
from . import hf_loader, llama_spmd
from .bert import (BERTForPretrain, BERTModel, bert_base, bert_large,
                   bert_small, get_bert)
from .convert import (load_jax_bert_params, load_jax_gluon_params,
                      load_jax_params)
from .forecast import DeepAR, TransformerForecaster, gaussian_nll
from .hf_loader import (export_hf_bert, export_hf_llama, load_hf_bert,
                        load_hf_llama, read_safetensors, write_safetensors)
from .llama import (LlamaForCausalLM, LlamaModel, RMSNormBlock, get_llama,
                    llama3_8b, llama_tiny)
from .nmt import (BeamSearchSampler, BeamSearchScorer, TransformerNMT,
                  get_nmt, nmt_tiny, transformer_en_de_512)
from .segmentation import (FCN, DeepLabV3, SegmentationMetric,
                           SoftmaxSegLoss, deeplab_tiny, fcn_tiny)
from .ssd import SSD, MultiBoxLoss, ssd_tiny

__all__ = ["BERTForPretrain", "BERTModel", "BeamSearchSampler",
           "BeamSearchScorer", "DeepAR", "DeepLabV3", "FCN",
           "LlamaForCausalLM", "LlamaModel", "MultiBoxLoss", "RMSNormBlock",
           "SSD", "SegmentationMetric", "SoftmaxSegLoss",
           "TransformerForecaster", "TransformerNMT", "bert_base",
           "export_hf_bert", "export_hf_llama", "hf_loader",
           "llama_spmd", "load_hf_bert", "load_hf_llama",
           "read_safetensors", "write_safetensors",
           "bert_large", "bert_small", "deeplab_tiny", "fcn_tiny",
           "gaussian_nll", "get_bert", "get_llama", "get_nmt", "llama3_8b",
           "llama_tiny", "load_jax_bert_params", "load_jax_gluon_params",
           "load_jax_params", "nmt_tiny", "ssd_tiny",
           "transformer_en_de_512"]
