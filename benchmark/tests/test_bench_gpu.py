"""On the card: a tiny cell of each kind with the hand-written kernels, the
port against the plain reference, and a traced run's readings."""
import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import cells, make_tiny


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_tiny_cell_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, bench = make_tiny(str(tmp_path))
    for traced in (False, True):
        result, _ = run_cell(cell, 21, 0.5, traced, root=root, bench_dir=bench, device="cuda")
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
