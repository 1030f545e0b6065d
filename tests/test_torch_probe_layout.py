"""K5's plain PyTorch version (``ivf_probe.probe_layout_reference``) held
to the layout stage's definition (``torch_layout.numpy_layout``) in both of
its regimes, the (b, nlist) histogram and the argsort past
``HIST_MAX_CELLS``; and the wrapper on the CPU, which takes the plain
version and launches nothing.  K5 itself is held to the same cases on the
card (``test_torch_kernels_cuda.py``)."""

import pytest
import torch
from torch_layout import LAYOUT_CASES, assert_layout, numpy_layout, synth_layout

from lotus_tpu_torch.ops import ivf_probe as tprobe


@pytest.mark.parametrize("case,b,nlist,nprobe,d,extra", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_layout_reference_matches_definition(monkeypatch, case, b, nlist, nprobe, d, extra):
    # The queries' width only sets the rows copied: 64 keeps config 4's units small here.
    probe_lists, xq, list_size = synth_layout(11, b=b, nlist=nlist, nprobe=nprobe, d=min(d, 64),
                                              dtype=torch.int8, **extra)
    want = numpy_layout(probe_lists, xq, list_size)
    assert_layout(tprobe.probe_layout_reference(probe_lists, xq, list_size, 1024), want)
    launches = tprobe.probe_layout.launches
    assert_layout(tprobe.probe_layout(probe_lists, xq, list_size, 1024), want)
    assert tprobe.probe_layout.launches == launches
    monkeypatch.setattr(tprobe, "HIST_MAX_CELLS", 0)
    assert_layout(tprobe.probe_layout_reference(probe_lists, xq, list_size, 1024), want)
