"""The port's BERT modules (``lotus_tpu_torch/models/bert.py``) against
Flax BERT: ``from_flax_params`` carries a ``FlaxBertModel``'s and a
``FlaxBertForSequenceClassification``'s parameters across, and the port's
forward gives their outputs within 1e-5."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_torch_checkpoints import sample_ids, write_bert  # noqa: E402

from lotus_tpu_torch.models import BertConfig, BertForSequenceClassification, BertModel, from_flax_params  # noqa: E402


@pytest.mark.parametrize("num_labels", [None, 1, 3])
def test_from_flax_params_gives_flax_outputs(tmp_path, num_labels):
    """The Flax model's ``last_hidden_state`` (or logits) from its own
    parameters equals the port's forward on ``from_flax_params`` of them."""
    import jax

    d = str(tmp_path / "ckpt")
    write_bert(d, num_labels=num_labels, seed=5, init_range=0.2)
    cls = transformers.FlaxBertModel if num_labels is None else transformers.FlaxBertForSequenceClassification
    flax = cls.from_pretrained(d, from_pt=True)
    params = jax.tree_util.tree_map(np.asarray, flax.params)
    cfg = BertConfig.from_dir(d)
    port = BertModel(cfg) if num_labels is None else BertForSequenceClassification(cfg)
    port.load_state_dict(from_flax_params(params, cfg))
    ids, mask = sample_ids(1)
    out = flax(input_ids=ids, attention_mask=mask, params=flax.params, train=False)
    want = np.asarray(out.last_hidden_state if num_labels is None else out.logits)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(KeyError, match="missing"):
        from_flax_params({k: v for k, v in params.get("bert", params).items() if k != "pooler"}, cfg)
