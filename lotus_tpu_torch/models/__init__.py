"""Embedding and rerank models of the port (M9): BERT in PyTorch with its
own WordPiece tokenizer and checkpoint reader, so no ``transformers``,
``tokenizers`` or ``safetensors`` is needed."""

from lotus_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, BertModel
from lotus_tpu_torch.models.checkpoint import from_flax_params, load_bert, load_state_dict, read_safetensors
from lotus_tpu_torch.models.reranker import Reranker
from lotus_tpu_torch.models.rm import RM, as_query_matrix
from lotus_tpu_torch.models.torch_reranker import TorchCrossEncoderReranker
from lotus_tpu_torch.models.torch_rm import TorchSentenceEncoderRM
from lotus_tpu_torch.models.wordpiece import WordPieceTokenizer

__all__ = [
    "BertConfig", "BertForSequenceClassification", "BertModel", "RM", "Reranker", "TorchCrossEncoderReranker",
    "TorchSentenceEncoderRM", "WordPieceTokenizer", "as_query_matrix", "from_flax_params", "load_bert",
    "load_state_dict", "read_safetensors",
]
