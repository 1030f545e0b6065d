"""``lotus_tpu_torch`` imports and searches with jax, pandas and lotus_tpu
blocked, as on a machine that has none of them."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_runs_without_jax_pandas_or_lotus_tpu(tmp_path):
    script = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "pandas", "pydantic", "lotus_tpu"):
            sys.modules[name] = None  # any import of them raises ImportError
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import lotus_tpu_torch
        from lotus_tpu_torch import TorchVS
        from lotus_tpu_torch import utils  # noqa: F401
        from lotus_tpu_torch.ops import autotune, bench_data, capacity, flat, flat_scan, ivf, ivf_probe, kmeans  # noqa: F401
        from lotus_tpu_torch import parallel  # noqa: F401

        rng = np.random.default_rng(0)
        emb = rng.standard_normal((2048, 16)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        vs = TorchVS(index_type="ivf", nlist=2, nprobe=2, device="cpu")
        vs.index([], emb, {str(tmp_path / "idx")!r})
        out = vs(emb[:3], 4)
        assert [row[0] for row in out.indices] == [0, 1, 2], out.indices
        # An unaligned store (64 rows a list): one query through the window probe.
        small = TorchVS(index_type="ivf", nlist=32, nprobe=4, device="cpu")
        small.index([], emb, {str(tmp_path / "small")!r})
        out = small(emb[5], 4)
        assert out.indices[0][0] == 5 and small.stats["routes"]["window_probe"] == 1, out.indices
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "pandas", "lotus_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_parallel_imports_and_searches_on_two_ranks(tmp_path):
    """``lotus_tpu_torch.parallel`` imports with jax blocked and one search
    runs on two gloo ranks started from the ``torchrun`` environment through
    ``init_runtime()`` (``tests/torch_ranks.py``, case ``import``)."""
    import numpy as np
    import torch_ranks

    torch_ranks.launch(str(tmp_path), ["import"], world=2, timeout=120)
    outs = [np.load(tmp_path / f"import.rank{r}.npz") for r in range(2)]
    assert all(int(o["world"]) == 2 for o in outs)
    np.testing.assert_array_equal(outs[0]["ids"], outs[1]["ids"])


def test_models_and_profiling_run_without_transformers(tmp_path):
    """``lotus_tpu_torch.models`` and ``lotus_tpu_torch.profiling`` import,
    embed one batch and rerank on the CPU from a ``model.safetensors``
    checkpoint with jax, pandas, lotus_tpu, transformers, tokenizers,
    safetensors and sentence_transformers blocked."""
    import pytest

    pytest.importorskip("transformers")
    from test_torch_checkpoints import write_bert

    write_bert(str(tmp_path / "rm"))
    write_bert(str(tmp_path / "rr"), num_labels=1)
    script = textwrap.dedent(
        f"""
        import sys
        blocked = ("jax", "jaxlib", "pandas", "pydantic", "lotus_tpu", "transformers", "tokenizers",
                   "safetensors", "sentence_transformers")
        for name in blocked:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        from lotus_tpu_torch import profiling
        from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM

        rm = TorchSentenceEncoderRM(model={str(tmp_path / "rm")!r}, max_batch_size=4, device="cpu")
        sink = {{}}
        with profiling.timed("embed", sink):
            emb = rm(["the cat sat on the mat", "hello world", "dogs"])
        assert emb.shape == (3, 32) and abs(float((emb ** 2).sum()) - 3.0) < 1e-4 and "embed" in sink
        rr = TorchCrossEncoderReranker(model={str(tmp_path / "rr")!r}, device="cpu")
        assert sorted(rr("cat", ["the cat", "a dog"], 2).indices) == [0, 1]
        bad = [m for m in sys.modules if m.split(".")[0] in blocked and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_families_run_without_hf_packages(tmp_path):
    """The families past BERT and their formats need none of the packages
    the card's machine lacks: with jax, pandas, lotus_tpu, transformers,
    tokenizers, sentencepiece, regex, msgpack, flax and safetensors blocked,
    an XLM-R checkpoint (``tokenizer.json``: Unigram with a charsmap), a
    RoBERTa one with only ``vocab.json`` + ``merges.txt``, a BERT one
    with only ``flax_model.msgpack``, and ALBERT (``NFKD``), RoFormer,
    BigBird (sentencepiece BPE) and RoBERTa-PreLayerNorm ones embed and
    rerank on the CPU as they do in this process."""
    import shutil

    import numpy as np
    import pytest

    transformers = pytest.importorskip("transformers")
    from test_torch_checkpoints import write_bert
    from torch_families import write_family

    from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM

    write_family(str(tmp_path / "xlmr"), "xlm-roberta", init_range=0.2)
    write_family(str(tmp_path / "xlmr_rr"), "xlm-roberta", num_labels=1, init_range=0.2)
    write_family(str(tmp_path / "roberta"), "roberta", init_range=0.2)
    families = ("albert", "roformer", "big_bird", "roberta-prelayernorm")
    for family in families:
        write_family(str(tmp_path / family), family, init_range=0.2)
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        os.remove(tmp_path / "roberta" / name)
    write_bert(str(tmp_path / "bert_pt"), init_range=0.2)
    transformers.FlaxAutoModel.from_pretrained(str(tmp_path / "bert_pt"), from_pt=True).save_pretrained(
        str(tmp_path / "bert_flax"))
    for name in ("vocab.txt", "tokenizer_config.json"):
        shutil.copy(tmp_path / "bert_pt" / name, tmp_path / "bert_flax" / name)
    docs = ["the cat sat on the mat", "Ｆｕｌｌ ①② café naïve 日本語 😀", "", "hello <mask> world"]
    names = ("xlmr", "roberta", "bert_flax", *families)
    want = {name: TorchSentenceEncoderRM(model=str(tmp_path / name), max_batch_size=4, device="cpu")(docs)
            for name in names}
    want["scores"] = TorchCrossEncoderReranker(model=str(tmp_path / "xlmr_rr"), device="cpu").score_pairs("cat", docs)
    np.savez(tmp_path / "want.npz", **want)
    script = textwrap.dedent(
        f"""
        import sys
        blocked = ("jax", "jaxlib", "pandas", "pydantic", "lotus_tpu", "transformers", "tokenizers",
                   "sentencepiece", "regex", "msgpack", "flax", "safetensors", "sentence_transformers")
        for name in blocked:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM

        want = np.load({str(tmp_path / "want.npz")!r})
        docs = {docs!r}
        for name in {names!r}:
            rm = TorchSentenceEncoderRM(model={str(tmp_path)!r} + "/" + name, max_batch_size=4, device="cpu")
            assert np.array_equal(rm(docs), want[name]), name
        rr = TorchCrossEncoderReranker(model={str(tmp_path / "xlmr_rr")!r}, device="cpu")
        assert np.array_equal(rr.score_pairs("cat", docs), want["scores"])
        bad = [m for m in sys.modules if m.split(".")[0] in blocked and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
