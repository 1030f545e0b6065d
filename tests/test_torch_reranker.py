"""``TorchCrossEncoderReranker`` against ``JaxCrossEncoderReranker`` on tiny
sequence-classification checkpoints whose weights are drawn wide enough
(std 0.2) that the logits spread: within 1e-5 for one and two labels, the
same order, and the reference's quirk mirrored: both pass no segment ids, so
every token type is 0, and both differ from the torch model called with the
pair's segment ids as sentence-transformers' ``CrossEncoder`` calls it."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_torch_checkpoints import write_bert  # noqa: E402

from lotus_tpu.models import JaxCrossEncoderReranker  # noqa: E402
from lotus_tpu_torch.models import TorchCrossEncoderReranker  # noqa: E402

DOCS = ["the cat sat on the mat", "hello world", "dogs", "a dog sat on a mat", "",
        " ".join(["hello cat"] * 12)]
QUERY = "cat on a mat"


@pytest.mark.parametrize("num_labels", [1, 2])
def test_scores_equal_jax_and_the_segment_quirk(tmp_path, num_labels):
    d = str(tmp_path)
    model = write_bert(d, num_labels=num_labels, seed=num_labels, init_range=0.2)
    # max_batch_size 4: a padded last batch.
    want = JaxCrossEncoderReranker(model=d, max_batch_size=4).score_pairs(QUERY, DOCS)
    port = TorchCrossEncoderReranker(model=d, max_batch_size=4, device="cpu")
    got = port.score_pairs(QUERY, DOCS)
    assert got.dtype == np.float32 and got.shape == (len(DOCS),)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.ptp(got) > 0.1  # the logits spread
    out = port(QUERY, DOCS, K=3)
    assert out.indices == [int(i) for i in np.argsort(-want, kind="stable")[:3]]

    tok = transformers.AutoTokenizer.from_pretrained(d)
    enc = tok([QUERY] * len(DOCS), DOCS, padding=True, return_tensors="pt")
    with torch.no_grad():
        logits = model(**enc).logits  # token_type_ids 1 on the doc segment
        zeroed = model(input_ids=enc["input_ids"], attention_mask=enc["attention_mask"]).logits
    pick = (lambda lg: lg[:, 0]) if num_labels == 1 else (lambda lg: lg[:, -1])
    np.testing.assert_allclose(pick(zeroed).numpy(), got, atol=1e-5)
    assert np.abs(pick(logits).numpy() - got).max() > 1e-2


def test_empty_and_device(tmp_path):
    write_bert(str(tmp_path), num_labels=1)
    port = TorchCrossEncoderReranker(model=str(tmp_path), device="cpu")
    assert port.score_pairs(QUERY, []).shape == (0,)
    assert port(QUERY, [], K=3).indices == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchCrossEncoderReranker(model=str(tmp_path))
