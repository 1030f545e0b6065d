"""BigBird in the port (``lotus_tpu_torch/models/big_bird.py``) against the
JAX package's classes on tiny checkpoints (width 32, 2 layers, 2 heads,
block 64 and 3 random blocks as ``google/bigbird-roberta-base`` has them,
4096 positions), weights drawn wide (std 0.2):

- ``block_sparse`` through ``TorchSentenceEncoderRM`` and
  ``TorchCrossEncoderReranker`` equals ``JaxSentenceEncoderRM`` /
  ``JaxCrossEncoderReranker`` within 1e-5 at the 256-, 512- and 1024-token
  buckets (mean and CLS pooling, 1 and 2 labels), each batch mixing a long
  doc with short ones so whole blocks are masked;
- where the reference fails (buckets 16-128, fewer than 4 blocks, and a
  length that is not a multiple of the block), the port raises
  ``ValueError`` naming the length and the block size;
- the eval-mode pattern, from a dense attention written here: the first and
  last query blocks see every key, the second and second-last four key
  blocks, the middle ones key block 0, their band and the last block, and
  every "random" block is key block 0 again (the reference's planners
  return zeros under ``deterministic``);
- no switch to full attention: at 256 tokens torch's ``BigBirdModel`` runs
  full attention (it switches below 704), Flax and the port do not;
- ``original_full`` at every bucket from 16 to 1024 tokens."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from torch_families import seeded_texts, seeded_words, write_family  # noqa: E402

from lotus_tpu.models import JaxCrossEncoderReranker, JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM, load_tokenizer  # noqa: E402
from lotus_tpu_torch.models.big_bird import block_sparse_attention  # noqa: E402

SPARSE = dict(attention_type="block_sparse", block_size=64, num_random_blocks=3, max_position_embeddings=4096)
WORDS = seeded_words(4, 300)
QUERY = "hello world " + " ".join(WORDS[:3])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Block-sparse encoder, 1- and 2-label directories; an original_full
    encoder."""
    out = {}
    for tag, labels in (("rm", None), ("rr1", 1), ("rr2", 2)):
        out[tag] = str(tmp_path_factory.mktemp(f"bb-{tag}"))
        write_family(out[tag], "big_bird", num_labels=labels, seed=11 + (labels or 0), init_range=0.2, **SPARSE)
    out["full"] = str(tmp_path_factory.mktemp("bb-full"))
    write_family(out["full"], "big_bird", seed=14, init_range=0.2, max_position_embeddings=1024)
    return out


def text_of(tokenizer, tokens: int, seed: int) -> str:
    """A seeded text that encodes to ``tokens`` tokens or just under."""
    words = seeded_texts(seed, 1, WORDS, 4 * tokens, 4 * tokens)[0].split()
    lo, hi = 0, len(words)
    while lo < hi:  # the most words that fit
        mid = (lo + hi + 1) // 2
        if len(tokenizer.encode([" ".join(words[:mid])])[0]) <= tokens:
            lo = mid
        else:
            hi = mid - 1
    return " ".join(words[:lo])


def bucket_docs(d: str, bucket: int, seed: int) -> list[str]:
    """Two batches of 4 (the second padded with ""), each with a doc near
    ``bucket`` tokens and shorter ones beside it."""
    tok = load_tokenizer(d)
    return [text_of(tok, bucket - 3, seed), "a short doc", text_of(tok, bucket // 2 + 5, seed + 1), "",
            text_of(tok, bucket - 40, seed + 2), text_of(tok, 70, seed + 3)]


@pytest.mark.parametrize("bucket", [256, 512, 1024])
def test_block_sparse_embeddings_equal_jax(checkpoints, bucket):
    d = checkpoints["rm"]
    docs = bucket_docs(d, bucket, bucket)
    for pooling in ("mean", "cls"):
        kw = dict(max_batch_size=4, max_seq_length=1024, pooling=pooling)
        want = JaxSentenceEncoderRM(model=d, **kw)._embed(docs)
        port = TorchSentenceEncoderRM(model=d, device="cpu", **kw)
        got = port._embed(docs)
        assert max(len(t) for t in port.tokenizer.encode(docs, max_length=1024)) > bucket // 2
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert np.ptp(got) > 0.1


@pytest.mark.parametrize("num_labels", [1, 2])
@pytest.mark.parametrize("bucket", [256, 512])
def test_block_sparse_scores_equal_jax(checkpoints, bucket, num_labels):
    d = checkpoints[f"rr{num_labels}"]
    docs = bucket_docs(d, bucket - 20, 7 * bucket)
    want = JaxCrossEncoderReranker(model=d, max_batch_size=4, max_seq_length=1024).score_pairs(QUERY, docs)
    got = TorchCrossEncoderReranker(model=d, max_batch_size=4, max_seq_length=1024,
                                    device="cpu").score_pairs(QUERY, docs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.ptp(got) > 1e-3


@pytest.mark.parametrize("max_seq_length,length", [(512, 16), (512, 32), (512, 64), (512, 128), (300, 300)])
def test_block_sparse_raises_where_the_reference_raises(checkpoints, max_seq_length, length):
    """Buckets of 1-3 blocks fail in the reference (with a TypeError or a
    ZeroDivisionError deep in its reshapes), as does a length that is not a
    multiple of the block (``max_seq_length`` 300 caps the 512 bucket);
    the port raises ``ValueError`` naming the length and the block size."""
    d = checkpoints["rm"]
    docs = [text_of(load_tokenizer(d), min(length, 290) - 3, length)]
    with pytest.raises((TypeError, ValueError, ZeroDivisionError)):
        JaxSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=max_seq_length)._embed(docs)
    port = TorchSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=max_seq_length, device="cpu")
    with pytest.raises(ValueError, match=f"sequence length {length} with block_size 64"):
        port._embed(docs)


def dense_pattern(q, k, v, mask, block: int, n_rand: int) -> torch.Tensor:
    """The eval-mode pattern as plain attention, one query block at a time:
    its key blocks (a block may repeat: the random ones are block 0), the
    -10000 penalty on masked keys, masked query rows zeroed."""
    b, h, s, d = q.shape
    nb = s // block
    out = torch.zeros_like(q)
    for i in range(nb):
        if i in (0, nb - 1):
            blocks = list(range(nb))
        elif i == 1:
            blocks = [0, 1, 2, nb - 1] + [0] * n_rand
        elif i == nb - 2:
            blocks = [0, nb - 3, nb - 2, nb - 1] + [0] * n_rand
        else:
            blocks = [0, i - 1, i, i + 1] + [0] * n_rand + [nb - 1]
        cols = torch.cat([torch.arange(j * block, (j + 1) * block) for j in blocks])
        rows = slice(i * block, (i + 1) * block)
        scores = q[:, :, rows] @ k[:, :, cols].transpose(-1, -2) / d**0.5
        scores = scores + (1.0 - mask[:, None, None, cols]) * -10000.0
        out[:, :, rows] = torch.softmax(scores, -1) @ v[:, :, cols]
    return out * mask[:, None, :, None]


@pytest.mark.parametrize("nb", [4, 5, 8])
def test_block_sparse_pattern(nb):
    g = torch.Generator().manual_seed(nb)
    b, h, block, d = 3, 2, 8, 4
    q, k, v = (torch.randn((b, h, nb * block, d), generator=g, dtype=torch.float64) for _ in range(3))
    mask = torch.ones((b, nb * block), dtype=torch.float64)
    mask[1, 3 * block + 2 :] = 0  # whole blocks masked
    mask[2, : block // 2] = 0  # part of block 0, the "random" block, masked
    want = dense_pattern(q, k, v, mask, block, 3)
    torch.testing.assert_close(block_sparse_attention(q, k, v, mask, block, 3), want, rtol=1e-12, atol=1e-12)


def test_no_switch_to_full_attention(checkpoints):
    """At 256 tokens torch's ``BigBirdModel`` switches to full attention
    (below 704 tokens it does, with a warning); Flax does not, and the port
    follows Flax: its hidden states equal the Flax model's and differ from
    torch's."""
    d = checkpoints["rm"]
    tok = transformers.AutoTokenizer.from_pretrained(d)
    enc = tok([text_of(load_tokenizer(d), 250, 5)], padding="max_length", max_length=256, return_tensors="np")
    ids, mask = enc["input_ids"], enc["attention_mask"]
    flax = transformers.FlaxAutoModel.from_pretrained(d, from_pt=True)
    want = np.asarray(flax(input_ids=ids, attention_mask=mask, params=flax.params, train=False).last_hidden_state)
    port = TorchSentenceEncoderRM(model=d, device="cpu").encoder
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        full = transformers.AutoModel.from_pretrained(d).eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(full.last_hidden_state.numpy() - got).max() > 1e-3


def test_original_full_at_every_bucket(checkpoints):
    d = checkpoints["full"]
    tok = load_tokenizer(d)
    docs = [text_of(tok, n, n) for n in (12, 30, 60, 120, 250, 500, 1000)]
    rm_kw = dict(max_batch_size=1, max_seq_length=1024)
    want = JaxSentenceEncoderRM(model=d, **rm_kw)._embed(docs)
    port = TorchSentenceEncoderRM(model=d, device="cpu", **rm_kw)
    got = port._embed(docs)
    from lotus_tpu_torch.models.torch_rm import seq_bucket

    lengths = [len(t) for t in port.tokenizer.encode(docs, max_length=1024)]
    assert [seq_bucket(n, 1024) for n in lengths] == [16, 32, 64, 128, 256, 512, 1024]
    np.testing.assert_allclose(got, want, atol=1e-5)
