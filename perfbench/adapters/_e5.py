"""BASELINE config 2's e5-base-v2 for the e5 cells: a seeded checkpoint
written under ``TMPDIR``, the RM the user's path loads from it, the right
side embedded by it and stored in an int8 IVF ``TorchVS``, and the judge
that re-embeds every text with the plain reference."""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from perfbench import texts
from perfbench.reference import judge
from perfbench.reference.bert import PlainBert
from perfbench.reference.wordpiece import WordPiece

STREAMS = {"vocab": 1, "weights": 2, "right": 3, "left": 4, "sample": 5}


def sub_seed(seed: int, stream: str, i: int = 0) -> int:
    return int(np.random.SeedSequence([seed % (1 << 63), STREAMS[stream], i]).generate_state(1, np.uint64)[0] >> 1)


def left_texts(cfg: dict, vocab: list[str], seed: int, n: int) -> list[str]:
    """``n`` left documents on the right side's topics, in draws of the
    right side's size."""
    out: list[str] = []
    i = 0
    while len(out) < n:
        out += texts.synth_texts(vocab, cfg["right_docs"], *cfg["words"], sub_seed(seed, "left", i), cfg["k"])
        i += 1
    return out[:n]


class Store:
    """The program's side of an e5 cell: the checkpoint, the RM and the store."""

    def __init__(self, ctx):
        from lotus_tpu_torch import TorchVS
        from lotus_tpu_torch.models import TorchSentenceEncoderRM

        cfg, dev = ctx.config, ctx.device
        self.cfg = cfg
        self.vocab = texts.make_vocab(sub_seed(ctx.seed, "vocab"), cfg["model"]["vocab_size"])
        weights = texts.bert_weights(cfg["model"], sub_seed(ctx.seed, "weights"), dev, getattr(torch, cfg["dtype"]))
        self.root = os.path.join(ctx.tmp_dir, "e5")
        texts.write_model_dir(os.path.join(self.root, "model"), cfg["model"], self.vocab, weights)
        del weights
        self.rm = TorchSentenceEncoderRM(model=os.path.join(self.root, "model"), max_batch_size=cfg["max_batch_size"],
                                         max_seq_length=cfg["max_seq_length"], dtype=getattr(torch, cfg["dtype"]),
                                         device=dev)
        right = texts.synth_texts(self.vocab, cfg["right_docs"], *cfg["words"], sub_seed(ctx.seed, "right"), cfg["k"])
        right_emb = self.rm(right)
        st = cfg["store"]
        self.vs = TorchVS(index_type=st["index_type"], nlist=st["nlist"], device_dtype=st["device_dtype"], device=dev)
        self.vs.index([], right_emb, os.path.join(self.root, "index"))
        self.every = list(range(cfg["right_docs"]))
        self.vs(right_emb[: ctx.cell["traffic"]["batch"]], cfg["k"], ids=self.every)  # loads the store

    def close(self) -> None:
        del self.rm, self.vs
        shutil.rmtree(self.root, ignore_errors=True)


def reference_embeddings(cfg: dict, seed: int, device: torch.device, docs: list[str], fp8: bool = False
                         ) -> tuple[np.ndarray, np.ndarray]:
    """The plain reference's embeddings of ``docs`` and of every right-side
    document, from the seed's vocabulary and weights (f32, or the fp8
    control)."""
    vocab = texts.make_vocab(sub_seed(seed, "vocab"), cfg["model"]["vocab_size"])
    weights = texts.bert_weights(cfg["model"], sub_seed(seed, "weights"), device, getattr(torch, cfg["dtype"]))
    bert = PlainBert(cfg["model"], weights, device, fp8=fp8)
    del weights
    wp = WordPiece(vocab)
    right = texts.synth_texts(vocab, cfg["right_docs"], *cfg["words"], sub_seed(seed, "right"), cfg["k"])
    ml = cfg["max_seq_length"]
    return bert.embed([wp.encode(t, ml) for t in docs]), bert.embed([wp.encode(t, ml) for t in right])


def control_answers(cfg: dict, left: np.ndarray, right: np.ndarray, device: torch.device
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k of ``left`` over ``right`` in f64 (the control's search)."""
    lt, rt = (torch.from_numpy(x).to(device, torch.float64) for x in (left, right))
    s, i = torch.topk(lt @ rt.T, cfg["k"], dim=1)
    return i.cpu().numpy(), s.cpu().numpy()


def judge_join(cfg: dict, ret_ids: np.ndarray, ret_scores: np.ndarray, left: np.ndarray, right: np.ndarray,
               emb: np.ndarray | None, device: torch.device) -> list[dict]:
    """``emb_gap`` (the program's embeddings of the sampled texts against
    the reference's, ``left``) where the timed path made them, and
    ``join_gap`` (its returned ids and scores against the reference's
    scores of ``left`` over ``right``)."""
    lim = cfg["limits"]
    out = []
    if emb is not None:
        out.append(judge.check("emb_gap", judge.emb_gap(emb, left), lim["emb_gap"], "max"))
    out.append(judge.check("join_gap", judge.join_gap(ret_ids, ret_scores, left, right, device), lim["join_gap"], "max"))
    return out
