"""Embedding and rerank models of the port (M9, M13): the encoder families
FlaxAutoModel loads that the port runs (BERT, RoBERTa, XLM-RoBERTa,
DistilBERT, ELECTRA, ALBERT, RoFormer, BigBird, RoBERTa-PreLayerNorm) and
its encoder-decoder families (BART and mBART, also as rerankers; Pegasus,
Blenderbot, Blenderbot-Small and Marian as RMs) and its decoder-only
families (GPT-2, GPT-SW3, GPT-Neo, GPT-J, Llama, Mistral, Gemma, BLOOM and
XGLM as RMs) in PyTorch, with their own tokenizers (WordPiece, byte-level
BPE, Unigram and sentencepiece BPE with byte fallback, read from
``tokenizer.json`` or the older vocab files, its regular expressions read
as Oniguruma reads them; Blenderbot-Small's slow BPE; GPT-SW3's and
Marian's slow tokenizers over sentencepiece ``.model`` files, read and
encoded without ``sentencepiece`` or ``protobuf``) and checkpoint readers
(safetensors, ``pytorch_model.bin``, either sharded, and Flax msgpack), so
no ``transformers``, ``tokenizers``, ``sentencepiece``, ``protobuf``,
``safetensors`` or ``msgpack`` is needed.  These are every type the
reference's ``FlaxAutoModel`` maps and runs."""

from lotus_tpu_torch.models.albert import AlbertConfig, AlbertForSequenceClassification, AlbertModel
from lotus_tpu_torch.models.auto import load_encoder, load_tokenizer
from lotus_tpu_torch.models.bart import BartConfig, BartForSequenceClassification, BartModel
from lotus_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, BertModel, EncoderConfig
from lotus_tpu_torch.models.big_bird import BigBirdConfig, BigBirdForSequenceClassification, BigBirdModel
from lotus_tpu_torch.models.blenderbot import BlenderbotConfig
from lotus_tpu_torch.models.blenderbot_small import BlenderbotSmallConfig, BlenderbotSmallModel
from lotus_tpu_torch.models.blenderbot_small_tokenizer import BlenderbotSmallTokenizer
from lotus_tpu_torch.models.bloom import BloomConfig, BloomModel
from lotus_tpu_torch.models.checkpoint import (
    FAMILIES, encoder_config, fit_state_dict, from_flax_params, load_state_dict, read_safetensors,
)
from lotus_tpu_torch.models.distilbert import DistilBertConfig, DistilBertForSequenceClassification, DistilBertModel
from lotus_tpu_torch.models.electra import ElectraConfig, ElectraForSequenceClassification, ElectraModel
from lotus_tpu_torch.models.gemma import GemmaConfig
from lotus_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from lotus_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from lotus_tpu_torch.models.gpt_sw3_tokenizer import GPTSw3Tokenizer
from lotus_tpu_torch.models.gptj import GPTJConfig, GPTJModel
from lotus_tpu_torch.models.llama import LlamaConfig, LlamaModel
from lotus_tpu_torch.models.marian import MarianConfig, MarianModel
from lotus_tpu_torch.models.marian_tokenizer import MarianTokenizer
from lotus_tpu_torch.models.mbart import MBartConfig, MBartForSequenceClassification, MBartModel
from lotus_tpu_torch.models.mistral import MistralConfig
from lotus_tpu_torch.models.msgpack import read_flax_msgpack
from lotus_tpu_torch.models.pegasus import PegasusConfig, PegasusModel
from lotus_tpu_torch.models.reranker import Reranker
from lotus_tpu_torch.models.rm import RM, as_query_matrix
from lotus_tpu_torch.models.roberta import RobertaConfig, RobertaForSequenceClassification, RobertaModel
from lotus_tpu_torch.models.roberta_prelayernorm import (
    RobertaPreLayerNormConfig, RobertaPreLayerNormForSequenceClassification, RobertaPreLayerNormModel,
)
from lotus_tpu_torch.models.roformer import RoFormerConfig, RoFormerForSequenceClassification, RoFormerModel
from lotus_tpu_torch.models.sentencepiece import SentencePieceEncoder, read_model
from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer
from lotus_tpu_torch.models.torch_reranker import TorchCrossEncoderReranker
from lotus_tpu_torch.models.torch_rm import TorchSentenceEncoderRM
from lotus_tpu_torch.models.wordpiece import WordPieceTokenizer
from lotus_tpu_torch.models.xglm import XGLMConfig, XGLMModel

__all__ = [
    "FAMILIES", "RM", "AlbertConfig", "AlbertForSequenceClassification", "AlbertModel", "BartConfig",
    "BartForSequenceClassification", "BartModel", "BertConfig", "BertForSequenceClassification", "BertModel",
    "BigBirdConfig", "BigBirdForSequenceClassification", "BigBirdModel", "BlenderbotConfig", "BlenderbotSmallConfig",
    "BlenderbotSmallModel", "BlenderbotSmallTokenizer", "BloomConfig", "BloomModel", "DistilBertConfig",
    "DistilBertForSequenceClassification",
    "DistilBertModel", "ElectraConfig", "ElectraForSequenceClassification", "ElectraModel", "EncoderConfig",
    "GPT2Config", "GPT2Model", "GPTJConfig", "GPTJModel", "GPTNeoConfig", "GPTNeoModel", "GPTSw3Tokenizer",
    "GemmaConfig", "JsonTokenizer", "LlamaConfig", "LlamaModel", "MBartConfig", "MBartForSequenceClassification",
    "MBartModel", "MarianConfig", "MarianModel", "MarianTokenizer", "MistralConfig", "PegasusConfig", "PegasusModel",
    "Reranker", "RoFormerConfig", "RoFormerForSequenceClassification", "RoFormerModel", "RobertaConfig",
    "RobertaForSequenceClassification", "RobertaModel", "RobertaPreLayerNormConfig",
    "RobertaPreLayerNormForSequenceClassification", "RobertaPreLayerNormModel", "SentencePieceEncoder",
    "TorchCrossEncoderReranker",
    "TorchSentenceEncoderRM", "WordPieceTokenizer", "XGLMConfig", "XGLMModel", "as_query_matrix", "encoder_config",
    "fit_state_dict", "from_flax_params", "load_encoder", "load_state_dict", "load_tokenizer", "read_flax_msgpack",
    "read_model", "read_safetensors",
]
