"""Cases that need a card: each cell at the CPU tests' tiny size, run on
the card through the real kernels, traced.  Skipped without a card; on the
card, run ``python -m pytest -q perfbench/tests -m cuda``."""

from __future__ import annotations

import pytest

from perfbench import harness, run
from perfbench.tests.test_perfbench_cells import CELLS, SEED, tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    cell, cfg = tiny(name)
    result, checks = run.run_cell(name, SEED, 2.0, True, device=card, cell=cell, config=cfg)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    ops = " ".join(n for n, _ in result["breakdown"]["device_ops"])
    if cell["adapter"] in ("ivf_bulk", "text_join", "ids_search"):  # K1 on the config-4 path only
        assert ("probe_wgmma" in ops or "probe_cores" in ops) == (cell["adapter"] == "ivf_bulk")
    expected = {m["name"] for m in harness.metrics_of(name, "per_layer")}
    assert set(result["metrics"]) <= expected
