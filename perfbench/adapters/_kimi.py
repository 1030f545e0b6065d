"""Kimi-Linear-48B-A3B for the long-document join: the seeded model (the
card's share of the experts) built on the device and handed to the RM the
user's path runs (no checkpoint written), the seeded tokenizer written under
``TMPDIR``, the right side embedded by the RM and stored in an int8 IVF
``TorchVS``, and the plain reference's embeddings of the judged documents."""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from perfbench import bpe_files, texts
from perfbench.adapters._dsv2 import left_texts, sample, sub_seed, tokenizer_spec, word_list  # noqa: F401
from perfbench.reference import deepseek_v2 as ref_dsv2
from perfbench.reference import kimi_linear as ref
from perfbench.reference.bpe import ByteBPE


def build_model(cfg: dict, seed: int, device: torch.device):
    """The program's Kimi-Linear in the configuration's dtype on ``device``,
    routing over ``router_experts`` and holding the first ``num_experts`` of
    them, every weight from the reference's seeded draw, loaded layer by
    layer under the checkpoint's names."""
    from lotus_tpu_torch.models.kimi_linear import KimiLinearConfig, KimiLinearModel

    dtype = getattr(torch, cfg["dtype"])
    model_cfg = KimiLinearConfig.from_dict({**cfg, "num_experts": ref.router_experts(cfg)})
    with torch.device("meta"):
        model = KimiLinearModel(model_cfg, experts=(0, cfg["num_experts"])).to(dtype=dtype)
    model = model.to_empty(device=device)
    with torch.no_grad():
        emb = ref_dsv2.embedding_weights(cfg, seed, device, dtype)
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
        model = build_model(cfg, ctx.seed, dev)  # first: a program without the model fails here, at once
        self.vocab = word_list(ctx.seed)
        self.root = os.path.join(ctx.tmp_dir, "kimi")
        bpe_files.write_tokenizer_dir(os.path.join(self.root, "model"), tokenizer_spec(cfg, self.vocab), cfg)
        self.rm = TorchSentenceEncoderRM(model=os.path.join(self.root, "model"), max_batch_size=cfg["max_batch_size"],
                                         max_seq_length=cfg["max_seq_length"], device=dev, encoder=model)
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
    control's), tokenized by the plain BPE encoder, all in one batch."""
    bpe = ByteBPE(tokenizer_spec(cfg, word_list(seed)), bpe_files.BOS)
    ids = [bpe.encode(t, cfg["max_seq_length"]) for t in docs]
    return ref.PlainKimiLinear(cfg, seed, device, getattr(torch, cfg["dtype"]), fp8=fp8).embed(ids)
