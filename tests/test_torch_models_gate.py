"""The M9 gate: the pandas operators behind ``lotus_tpu.settings`` with the
port's models and store (``TorchSentenceEncoderRM``,
``TorchCrossEncoderReranker``, ``TorchVS``, all on the CPU) give the frames
the JAX classes with ``TpuVS`` give, on one pair of tiny checkpoint
directories: ``sem_index`` + ``sem_search``, ``sem_search(n_rerank=2)``
and ``sem_sim_join``; then the same on an XLM-RoBERTa pair (Unigram
tokenizer with a charsmap, RoBERTa positions, the classification head)."""

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("transformers")

from test_torch_checkpoints import seeded_vocab, write_bert  # noqa: E402
from torch_families import write_family  # noqa: E402

import lotus_tpu  # noqa: E402
from lotus_tpu.models import JaxCrossEncoderReranker, JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu.vector_store import TpuVS  # noqa: E402
from lotus_tpu_torch import TorchVS  # noqa: E402
from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM  # noqa: E402

VOCAB = seeded_vocab(2)


def _texts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    words = VOCAB[60:]
    return [" ".join(rng.choice(words, rng.integers(lo, hi + 1))) for _ in range(n)]


DOCS = _texts(3, 24, 4, 14)
QUERIES = _texts(4, 3, 2, 5)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    rm_dir, rr_dir = (str(tmp_path_factory.mktemp(name)) for name in ("rm", "rr"))
    write_bert(rm_dir, VOCAB, seed=7, init_range=0.2)
    write_bert(rr_dir, VOCAB, num_labels=1, seed=8, init_range=0.2)
    return rm_dir, rr_dir


def _search(tmp_path):
    df = pd.DataFrame({"text": DOCS}).sem_index("text", str(tmp_path / "idx"))
    return [df.sem_search("text", q, K=5, return_scores=True) for q in QUERIES]


def _rerank(tmp_path):
    df = pd.DataFrame({"text": DOCS}).sem_index("text", str(tmp_path / "idx"))
    return [df.sem_search("text", q, K=6, n_rerank=2) for q in QUERIES]


def _sim_join(tmp_path):
    right = pd.DataFrame({"text": DOCS}).sem_index("text", str(tmp_path / "idx"))
    return [pd.DataFrame({"query": QUERIES}).sem_sim_join(right, left_on="query", right_on="text", K=3)]


@pytest.fixture(scope="module")
def xlmr_checkpoints(tmp_path_factory):
    rm_dir, rr_dir = (str(tmp_path_factory.mktemp(name)) for name in ("xlmr_rm", "xlmr_rr"))
    write_family(rm_dir, "xlm-roberta", seed=7, init_range=0.2)
    write_family(rr_dir, "xlm-roberta", num_labels=1, seed=8, init_range=0.2)
    return rm_dir, rr_dir


def _frames_equal(rm_dir, rr_dir, tmp_path, scenario):
    stacks = {
        "ref": (JaxSentenceEncoderRM(model=rm_dir, max_batch_size=8), TpuVS(),
                JaxCrossEncoderReranker(model=rr_dir, max_batch_size=4)),
        "port": (TorchSentenceEncoderRM(model=rm_dir, max_batch_size=8, device="cpu"), TorchVS(device="cpu"),
                 TorchCrossEncoderReranker(model=rr_dir, max_batch_size=4, device="cpu")),
    }
    frames = {}
    for tag, (rm, vs, rr) in stacks.items():
        (tmp_path / tag).mkdir()
        with lotus_tpu.settings.context(rm=rm, vs=vs, reranker=rr, enable_cache=False):
            frames[tag] = scenario(tmp_path / tag)
    for got, want in zip(frames["port"], frames["ref"]):
        assert len(want) > 0
        pd.testing.assert_frame_equal(got, want, check_exact=False, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scenario", [_search, _rerank, _sim_join], ids=lambda f: f.__name__.lstrip("_"))
def test_frames_equal_the_jax_pair(checkpoints, tmp_path, scenario):
    _frames_equal(*checkpoints, tmp_path, scenario)


@pytest.mark.parametrize("scenario", [_search, _rerank, _sim_join], ids=lambda f: f.__name__.lstrip("_"))
def test_xlmr_frames_equal_the_jax_pair(xlmr_checkpoints, tmp_path, scenario):
    _frames_equal(*xlmr_checkpoints, tmp_path, scenario)
