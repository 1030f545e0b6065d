"""The port's entry points run on the GPU unless the caller asks for the CPU.

Without a CUDA device, every entry point called with its default device
raises an error that names ``device="cpu"``, instead of carrying on on the
CPU.  The tests hide the GPU (``torch.cuda.is_available`` returns False), so
they hold on a machine with a card too.
"""

import numpy as np
import pytest
import torch

from lotus_tpu_torch import TorchVS
from lotus_tpu_torch.ops import ivf as tivf
from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build

_NO_GPU = 'no CUDA device; pass device="cpu"'


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    emb = np.random.default_rng(0).standard_normal((2048, 16)).astype(np.float32)
    idx = str(tmp_path_factory.mktemp("dev") / "idx")
    meta = {"kind": "ivf", "metric": "ip",
            **tivf.build_ivf(idx, emb, nlist=4, metric="ip", block_align=512, device="cpu")}
    return idx, meta, emb


def test_default_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match=_NO_GPU):
        tivf.default_device()


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_load_ivf_state_defaults_to_the_gpu(no_gpu, index_dir, dtype):
    idx, meta, _ = index_dir
    with pytest.raises(RuntimeError, match=_NO_GPU):
        tivf.load_ivf_state(idx, meta, dtype)
    state = tivf.load_ivf_state(idx, meta, dtype, device="cpu")  # asked for: runs
    assert state["ivf_vectors"].device.type == "cpu"


def test_build_ivf_defaults_to_the_gpu(no_gpu, index_dir, tmp_path):
    _, _, emb = index_dir
    with pytest.raises(RuntimeError, match=_NO_GPU):
        tivf.build_ivf(str(tmp_path / "b"), emb, nlist=4, metric="ip", block_align=512)


def test_synth_build_defaults_to_the_gpu(no_gpu):
    with pytest.raises(RuntimeError, match=_NO_GPU):
        synth_ivf_device_build(n=1 << 12, d=16, nlist=4, n_clusters=8, chunk=1 << 11, queries_b=8,
                               gt_queries=4)


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_torch_vs_defaults_to_the_gpu(no_gpu, index_type):
    with pytest.raises(RuntimeError, match=_NO_GPU):
        TorchVS(index_type=index_type)
    assert TorchVS(index_type=index_type, device="cpu").device.type == "cpu"


def test_unported_options_raise_before_the_device(no_gpu):
    """No option is left unported: mesh (ROADMAP M11) carries its rank's
    device, and the mesh builders meet the device check like any other
    entry point; recall_target meets it like any other store."""
    from lotus_tpu_torch.parallel import ShardMesh, default_mesh, serving_mesh

    for build in (default_mesh, serving_mesh):
        with pytest.raises(RuntimeError, match=_NO_GPU):
            build()
    assert TorchVS(mesh=ShardMesh(None, [0], 0, "cpu")).device.type == "cpu"
    with pytest.raises(RuntimeError, match=_NO_GPU):
        TorchVS(index_type="ivf", recall_target=0.9)
    assert TorchVS(index_type="ivf", recall_target=0.9, device="cpu").recall_target == 0.9
