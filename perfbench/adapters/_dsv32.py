"""DeepSeek-V3.2-Exp for the 32,768-token document join: the seeded model
(the card's share: its layers and its experts of each MoE layer) built on
the device and handed to the RM the user's path runs (no checkpoint
written), the seeded tokenizer written under ``TMPDIR``, the right side
embedded by the RM and stored in an int8 IVF ``TorchVS``, the probes that
keep layer 0's selection and attention output at sampled query rows of the
judged requests, and the plain reference's embeddings and probes."""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from perfbench import bpe_files, texts
from perfbench.adapters._dsv2 import left_texts, sample, sub_seed, tokenizer_spec, word_list  # noqa: F401
from perfbench.reference import deepseek_v2 as ref_dsv2
from perfbench.reference import deepseek_v32 as ref
from perfbench.reference.bpe import ByteBPE


def build_model(cfg: dict, seed: int, device: torch.device):
    """The program's DeepSeek-V3.2 in the configuration's dtype on
    ``device``, routing over ``router_experts`` and holding the first
    ``n_routed_experts`` of them, every weight from the reference's seeded
    draw, loaded layer by layer under the checkpoint's names."""
    from lotus_tpu_torch.models.deepseek_v32 import DeepseekV32Config, DeepseekV32Model

    dtype = getattr(torch, cfg["dtype"])
    model_cfg = DeepseekV32Config.from_dict({**cfg, "n_routed_experts": ref.router_experts(cfg)})
    with torch.device("meta"):
        model = DeepseekV32Model(model_cfg, experts=(0, cfg["n_routed_experts"])).to(dtype=dtype)
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
        self.model = build_model(cfg, ctx.seed, dev)  # first: a program without the model fails here, at once
        self.vocab = word_list(ctx.seed)
        self.root = os.path.join(ctx.tmp_dir, "dsv32")
        bpe_files.write_tokenizer_dir(os.path.join(self.root, "model"), tokenizer_spec(cfg, self.vocab), cfg)
        self.rm = TorchSentenceEncoderRM(model=os.path.join(self.root, "model"), max_batch_size=cfg["max_batch_size"],
                                         max_seq_length=cfg["max_seq_length"], device=dev, encoder=self.model)
        self.right = texts.synth_texts(self.vocab, cfg["right_docs"], *cfg["words"], sub_seed(ctx.seed, "right"),
                                       cfg["k"])
        self.right_emb = self.rm(self.right)
        st = cfg["store"]
        self.vs = TorchVS(index_type=st["index_type"], nlist=st["nlist"], device_dtype=st["device_dtype"], device=dev)
        self.vs.index([], self.right_emb, os.path.join(self.root, "index"))
        self.every = list(range(cfg["right_docs"]))
        self.vs(self.right_emb[: ctx.cell["traffic"]["batch"]], cfg["k"], ids=self.every)  # loads the store

    def close(self) -> None:
        del self.rm, self.vs, self.model
        shutil.rmtree(self.root, ignore_errors=True)


def probe_rows(seed: int, n: int, span: list[int]) -> np.ndarray:
    """``n`` sorted query rows drawn without replacement from [lo, hi)."""
    rng = np.random.default_rng(sub_seed(seed, "sample", 2))
    return np.sort(rng.choice(np.arange(*span), min(n, span[1] - span[0]), replace=False))


class Probe:
    """Forward hooks on layer 0 that keep, for the first ``forwards``
    forwards (one document each), the indexer's selection and the
    attention's output (``o_proj``'s, in f32) at ``rows``, on the device: a
    gather each, no synchronisation."""

    def __init__(self, model, rows: np.ndarray, forwards: int):
        self.rows = torch.as_tensor(rows, device=model.embed_tokens.weight.device)
        self.left = forwards
        self.selections: list[torch.Tensor] = []
        self.outputs: list[torch.Tensor] = []
        attn = model.layers[0].self_attn
        self.hooks = [attn.indexer.register_forward_hook(self._selection), attn.register_forward_hook(self._output)]

    def _selection(self, _module, _args, out: torch.Tensor) -> None:
        if self.left > 0:
            self.selections.append(out[0, self.rows])

    def _output(self, _module, _args, out: torch.Tensor) -> None:
        if self.left > 0:
            self.outputs.append(out[0, self.rows].float())
            self.left -= 1

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks = []


def probe_gaps(selections: list[torch.Tensor], outputs: list[torch.Tensor],
               probed: list[tuple[torch.Tensor, torch.Tensor]]) -> tuple[float, float]:
    """``index_agree``: the least share, over every probed row, of the
    reference's selection that the program also selected; ``attn_gap``:
    the widest relative L2 gap between the program's attention output at a
    probed row and the reference's.  Each probed document's rows in turn."""
    agree, gap = 1.0, 0.0
    for sel, out, (ref_sel, ref_out) in zip(selections, outputs, probed):
        both = torch.cat((sel.to(ref_sel.device), ref_sel), dim=1).sort(dim=1).values
        shared = (both[:, 1:] == both[:, :-1]).sum(1).double() / ref_sel.shape[1]
        agree = min(agree, float(shared.min()))
        rel = torch.linalg.vector_norm(out.to(ref_out.device) - ref_out, dim=1) / torch.linalg.vector_norm(ref_out,
                                                                                                          dim=1)
        gap = max(gap, float(rel.max()))
    return agree, gap


def reference_run(cfg: dict, seed: int, device: torch.device, docs: list[str], probe: list | None = None,
                  fp8: bool = False) -> tuple[np.ndarray, list[tuple[torch.Tensor, torch.Tensor]]]:
    """The plain reference's f32 embeddings of ``docs`` (or the fp8
    control's), tokenized by the plain BPE encoder, and its probes of layer 0
    at the rows ``probe`` gives each document.  A probed document must reach
    past its last probed row."""
    bpe = ByteBPE(tokenizer_spec(cfg, word_list(seed)), bpe_files.BOS)
    ids = [bpe.encode(t, cfg["max_seq_length"]) for t in docs]
    for t, rows in zip(ids, probe or []):
        if rows is not None and len(t) <= int(rows[-1]):
            raise ValueError(f"a judged document of {len(t)} tokens does not reach its probed row {int(rows[-1])}")
    plain = ref.PlainDeepseekV32(cfg, seed, device, getattr(torch, cfg["dtype"]), fp8=fp8, probe=probe)
    return plain.embed(ids), plain.probed
