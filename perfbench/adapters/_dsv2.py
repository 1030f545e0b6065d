"""DeepSeek-V2-Lite for the passage join: the seeded model built on the
device and handed to the RM the user's path runs (no checkpoint written),
the seeded tokenizer written under ``TMPDIR``, the right side embedded by the
RM and stored in an int8 IVF ``TorchVS``, and the plain reference's
embeddings of the judged passages."""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from perfbench import bpe_files, texts
from perfbench.adapters._e5 import left_texts, sub_seed
from perfbench.reference import deepseek_v2 as ref
from perfbench.reference.bpe import ByteBPE

WORDS = 30522  # the seeded word list's entries (texts.make_vocab, as the e5 cells'); the BPE reads 1.6 tokens a word


def word_list(seed: int) -> list[str]:
    return texts.make_vocab(sub_seed(seed, "vocab"), WORDS)


def tokenizer_spec(cfg: dict, vocab: list[str]) -> dict:
    return bpe_files.bpe_spec([w for w in vocab if w.isalpha()], cfg["vocab_size"])


def build_model(cfg: dict, seed: int, device: torch.device):
    """The program's DeepSeek-V2 in the configuration's dtype on ``device``,
    every weight from the reference's seeded draw, loaded layer by layer
    under the checkpoint's names."""
    from lotus_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model

    dtype = getattr(torch, cfg["dtype"])
    with torch.device("meta"):
        model = DeepseekV2Model(DeepseekV2Config.from_dict(cfg)).to(dtype=dtype)
    model = model.to_empty(device=device)
    with torch.no_grad():
        emb = ref.embedding_weights(cfg, seed, device, dtype)
        model.embed_tokens.weight.copy_(emb["embed_tokens.weight"])
        model.norm.weight.copy_(emb["norm.weight"])
        del emb
        for i, layer in enumerate(model.layers):
            missing, _ = layer.load_state_dict(ref.layer_weights(cfg, seed, i, device, dtype), strict=False)
            if missing:
                raise KeyError(f"layer {i}: the reference's weights lack {missing}")
    return model.eval()


class Store:
    """The program's side of the cell: the model, the RM and the store."""

    def __init__(self, ctx):
        from lotus_tpu_torch import TorchVS
        from lotus_tpu_torch.models import TorchSentenceEncoderRM

        cfg, dev = ctx.config, ctx.device
        self.cfg = cfg
        self.vocab = word_list(ctx.seed)
        self.root = os.path.join(ctx.tmp_dir, "dsv2")
        bpe_files.write_tokenizer_dir(os.path.join(self.root, "model"), tokenizer_spec(cfg, self.vocab), cfg)
        self.rm = TorchSentenceEncoderRM(model=os.path.join(self.root, "model"), max_batch_size=cfg["max_batch_size"],
                                         max_seq_length=cfg["max_seq_length"], device=dev,
                                         encoder=build_model(cfg, ctx.seed, dev))
        self.right = texts.synth_texts(self.vocab, cfg["right_docs"], *cfg["words"], sub_seed(ctx.seed, "right"),
                                       cfg["k"])
        self.right_emb = self.rm(self.right)
        st = cfg["store"]
        self.vs = TorchVS(index_type=st["index_type"], nlist=st["nlist"], device_dtype=st["device_dtype"], device=dev)
        self.vs.index([], self.right_emb, os.path.join(self.root, "index"))
        self.every = list(range(cfg["right_docs"]))
        self.vs(self.right_emb[: ctx.cell["traffic"]["batch"]], cfg["k"], ids=self.every)  # loads the store

    def close(self) -> None:
        del self.rm, self.vs
        shutil.rmtree(self.root, ignore_errors=True)


def reference_embeddings(cfg: dict, seed: int, device: torch.device, docs: list[str], fp8: bool = False
                         ) -> np.ndarray:
    """The plain reference's f32 embeddings of ``docs`` (or the fp8
    control's), tokenized by the plain BPE encoder."""
    bpe = ByteBPE(tokenizer_spec(cfg, word_list(seed)), bpe_files.BOS)
    ids = [bpe.encode(t, cfg["max_seq_length"]) for t in docs]
    plain = ref.PlainDeepseekV2(cfg, seed, device, getattr(torch, cfg["dtype"]), fp8=fp8)
    return plain.embed(ids)


def sample(seed: int, n: int, size: int, stream_index: int) -> np.ndarray:
    rng = np.random.default_rng(sub_seed(seed, "sample", stream_index))
    return np.sort(rng.choice(n, min(size, n), replace=False))

