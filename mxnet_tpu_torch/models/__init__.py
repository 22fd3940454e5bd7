"""Model zoo: the Llama family, BERT, the GluonTS forecasters (DeepAR,
TransformerForecaster), Transformer NMT with beam search, semantic
segmentation (FCN, DeepLabV3), the SSD, YOLOv3 and Faster R-CNN
detectors, SimplePose, HF safetensors
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
from .pose import (PCKMetric, PoseHeatmapLoss, SimplePose,
                   gaussian_heatmaps, simple_pose_tiny)
from .rcnn import FasterRCNN, FasterRCNNLoss, faster_rcnn_tiny
from .ssd import SSD, MultiBoxLoss, ssd_tiny
from .yolo import YOLOv3, YOLOv3Loss, build_targets, yolo3_tiny
from . import pose, rcnn, segmentation, ssd, yolo

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
           "transformer_en_de_512", "pose", "rcnn", "segmentation", "ssd",
           "yolo", "YOLOv3", "YOLOv3Loss", "build_targets", "yolo3_tiny",
           "FasterRCNN", "FasterRCNNLoss", "faster_rcnn_tiny", "SimplePose",
           "PoseHeatmapLoss", "PCKMetric", "gaussian_heatmaps",
           "simple_pose_tiny"]
