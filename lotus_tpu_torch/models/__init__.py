"""Embedding and rerank models of the port (M9, M13): the encoder families
FlaxAutoModel loads that the port runs (BERT, RoBERTa, XLM-RoBERTa,
DistilBERT, ELECTRA, ALBERT, RoFormer, BigBird, RoBERTa-PreLayerNorm) in
PyTorch, with their own tokenizers (WordPiece, byte-level BPE, Unigram and
sentencepiece BPE, read from ``tokenizer.json`` or the older vocab files)
and checkpoint readers (safetensors, ``pytorch_model.bin``, Flax msgpack),
so no ``transformers``, ``tokenizers``, ``safetensors`` or ``msgpack`` is
needed."""

from lotus_tpu_torch.models.albert import AlbertConfig, AlbertForSequenceClassification, AlbertModel
from lotus_tpu_torch.models.auto import load_encoder, load_tokenizer
from lotus_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, BertModel, EncoderConfig
from lotus_tpu_torch.models.big_bird import BigBirdConfig, BigBirdForSequenceClassification, BigBirdModel
from lotus_tpu_torch.models.checkpoint import (
    FAMILIES, encoder_config, fit_state_dict, from_flax_params, load_state_dict, read_safetensors,
)
from lotus_tpu_torch.models.distilbert import DistilBertConfig, DistilBertForSequenceClassification, DistilBertModel
from lotus_tpu_torch.models.electra import ElectraConfig, ElectraForSequenceClassification, ElectraModel
from lotus_tpu_torch.models.msgpack import read_flax_msgpack
from lotus_tpu_torch.models.reranker import Reranker
from lotus_tpu_torch.models.rm import RM, as_query_matrix
from lotus_tpu_torch.models.roberta import RobertaConfig, RobertaForSequenceClassification, RobertaModel
from lotus_tpu_torch.models.roberta_prelayernorm import (
    RobertaPreLayerNormConfig, RobertaPreLayerNormForSequenceClassification, RobertaPreLayerNormModel,
)
from lotus_tpu_torch.models.roformer import RoFormerConfig, RoFormerForSequenceClassification, RoFormerModel
from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer
from lotus_tpu_torch.models.torch_reranker import TorchCrossEncoderReranker
from lotus_tpu_torch.models.torch_rm import TorchSentenceEncoderRM
from lotus_tpu_torch.models.wordpiece import WordPieceTokenizer

__all__ = [
    "FAMILIES", "RM", "AlbertConfig", "AlbertForSequenceClassification", "AlbertModel", "BertConfig",
    "BertForSequenceClassification", "BertModel", "BigBirdConfig", "BigBirdForSequenceClassification",
    "BigBirdModel", "DistilBertConfig", "DistilBertForSequenceClassification", "DistilBertModel", "ElectraConfig",
    "ElectraForSequenceClassification", "ElectraModel", "EncoderConfig", "JsonTokenizer", "Reranker",
    "RoFormerConfig", "RoFormerForSequenceClassification", "RoFormerModel", "RobertaConfig",
    "RobertaForSequenceClassification", "RobertaModel", "RobertaPreLayerNormConfig",
    "RobertaPreLayerNormForSequenceClassification", "RobertaPreLayerNormModel", "TorchCrossEncoderReranker",
    "TorchSentenceEncoderRM", "WordPieceTokenizer", "as_query_matrix", "encoder_config", "fit_state_dict",
    "from_flax_params", "load_encoder", "load_state_dict", "load_tokenizer", "read_flax_msgpack",
    "read_safetensors",
]
