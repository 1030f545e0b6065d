"""BASELINE config 4's store for the config-4 cells: built by the program
from the seed, its queries the benchmark's own, and the judge that holds
the store and the answers to the benchmark's corpus."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import corpus
from perfbench.reference import judge
from perfbench.reference.topk import RunningTopK, int4_rows


def build_store(cfg: dict, seed: int, device: torch.device) -> dict:
    """The program's device build of the seeded corpus (its own 1-query
    oracle kept to the least it takes)."""
    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build

    built = synth_ivf_device_build(
        n=cfg["n"], d=cfg["d"], nlist=cfg["nlist"], n_clusters=cfg["n_clusters"],
        cluster_scale=cfg["cluster_scale"], chunk=cfg["chunk"], queries_b=1, gt_queries=1, k=cfg["k"],
        block_align=cfg["block_align"], seed=seed, kmeans_iters=cfg["kmeans_iters"], encoding=cfg["encoding"],
        refine=cfg["refine"], train_chunks=cfg["train_chunks"], device=device,
    )
    return built["state"]


def search_fn(cfg: dict):
    """The call the cells time: ``ivf_search_grouped_probe`` at the
    configuration's settings."""
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe, probe_fold

    def search(state: dict, xq: torch.Tensor, fold=probe_fold) -> tuple[torch.Tensor, torch.Tensor]:
        return ivf_search_grouped_probe(
            state, xq, cfg["k"], nprobe=cfg["nprobe"], metric=cfg["metric"], int8_queries=cfg["int8_queries"],
            query_chunk=cfg["query_chunk"], rescore=cfg["rescore"], fold=fold)

    return search


def sample_seed(seed: int, what: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), what])


def store_rows(state: dict, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` as the store holds them, reconstructed by the
    reference's own arithmetic: the list's centroid, plus the int8 residual
    times its scale, plus the int4 refinement (nibbles, low first) times its
    scale."""
    pos = state["ivf_inv_perm"][rows].long()
    out = state["ivf_vectors"][pos].float() * state["ivf_row_scales"][pos][:, None]
    starts = state["ivf_list_start"].long()
    lists = torch.searchsorted(starts, pos, right=True) - 1
    out += state["centroids"][lists].float()
    if "ivf_refine" in state:
        u = state["ivf_refine"][rows].view(torch.uint8).long()
        nib = torch.stack([u & 0xF, u >> 4], dim=-1).reshape(u.shape[0], -1)
        nib = torch.where(nib >= 8, nib - 16, nib).float()
        out += nib * state["ivf_refine_scales"][rows][:, None]
    return out


def build_check_rows(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sample_seed(seed, 3).choice(cfg["n"], cfg["check_rows"], replace=False)).to(device)


def corpus_pass(cfg: dict, seed: int, device: torch.device, q: torch.Tensor, need: torch.Tensor,
                control: bool = False) -> dict:
    """One pass over the regenerated corpus: the exact f32 top-k of ``q``,
    the corpus rows ``need`` (int64, any shape), and with ``control`` the
    int4 control's top-k and its rows ``need``."""
    centers = corpus.corpus_centers(seed, cfg["n_clusters"], cfg["d"], device)
    exact = RunningTopK(q, cfg["k"])
    ctl = RunningTopK(q, cfg["k"]) if control else None
    flat = need.reshape(-1)
    rows = torch.zeros((flat.shape[0], cfg["d"]), device=device)
    ctl_rows = torch.zeros_like(rows) if control else None
    chunk = cfg["chunk"]
    for c in range(cfg["n"] // chunk):
        x = corpus.gen_chunk(seed, c, centers, chunk, cfg["cluster_scale"])
        exact.add(c * chunk, x)
        sel = (flat // chunk) == c
        rows[sel] = x[flat[sel] - c * chunk]
        if control:
            x4 = int4_rows(x)
            ctl.add(c * chunk, x4)
            ctl_rows[sel] = x4[flat[sel] - c * chunk]
        del x
    out = {"exact": exact, "rows": rows.reshape(*need.shape, -1)}
    if control:
        out["ctl"], out["ctl_rows"] = ctl, ctl_rows.reshape(*need.shape, -1)
    return out


def judge_answers(cfg: dict, q: torch.Tensor, ret_ids: np.ndarray, ret_scores: np.ndarray,
                  exact_ids: np.ndarray, ret_rows: torch.Tensor, stored: torch.Tensor,
                  stored_exact: torch.Tensor) -> list[dict]:
    """recall@k against the exact f32 top-k, the widest score error of a
    returned id, and the widest error of a stored row."""
    lim = cfg["limits"]
    exact_ret = torch.einsum("qd,qkd->qk", q.double(), ret_rows.double()).cpu().numpy()
    return [
        judge.check("recall_at_10", judge.recall(ret_ids, exact_ids), lim["recall_at_10"], "min"),
        judge.check("score_err", judge.score_err(ret_ids, ret_scores, exact_ret), lim["score_err"], "max"),
        judge.check("row_err", judge.row_err(stored, stored_exact), lim["row_err"], "max"),
    ]


def judge_store(cfg: dict, seed: int, device: torch.device, q_np: np.ndarray, ret_ids: np.ndarray,
                ret_scores: np.ndarray, stored: torch.Tensor) -> list[dict]:
    """The program's answers ``ret_*`` to queries ``q_np`` and its stored
    rows ``stored`` (of ``build_check_rows``), against one corpus pass."""
    q = torch.from_numpy(q_np).to(device)
    check = build_check_rows(cfg, seed, device)
    ids = torch.from_numpy(np.clip(ret_ids, 0, None)).to(device)
    p = corpus_pass(cfg, seed, device, q, torch.cat([ids.reshape(-1), check]))
    n_ret = ids.numel()
    ret_rows = p["rows"][:n_ret].reshape(*ids.shape, -1)
    return judge_answers(cfg, q, ret_ids, ret_scores, p["exact"].ids.cpu().numpy(), ret_rows, stored,
                         p["rows"][n_ret:])


def control_numbers(cfg: dict, seed: int, device: torch.device, q_np: np.ndarray) -> list[dict]:
    """The control in the program's place: exact search over the corpus's
    rows rounded to int4, and those rows as its store; judged as the program is."""
    q = torch.from_numpy(q_np).to(device)
    check = build_check_rows(cfg, seed, device)
    p = corpus_pass(cfg, seed, device, q, check, control=True)
    ctl_ids = p["ctl"].ids
    again = corpus_pass(cfg, seed, device, q[:1], ctl_ids.reshape(-1))
    ret_rows = again["rows"].reshape(*ctl_ids.shape, -1)
    return judge_answers(cfg, q, ctl_ids.cpu().numpy(), p["ctl"].scores.cpu().numpy(),
                         p["exact"].ids.cpu().numpy(), ret_rows, p["ctl_rows"], p["rows"])
