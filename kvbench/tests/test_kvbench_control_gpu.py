"""On the card: for every cell, a run at the cell's own size and load
whose served tokens the harness's check passes, while it fails the
control (the reference with TF32 on, one step below the configuration's
float32) put in their place at the same prompts and tokens.

    python -m pytest -q kvbench/tests/test_kvbench_control_gpu.py

Marked ``gpu``: it skips without a CUDA card."""
import pytest

from kvbench import control, harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 11
WINDOW_S = float(BENCH["run_seconds"])  # as many compared tokens as a run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, card):
    files = harness.cell_files(BENCH, cell, False)
    files.metrics = []
    v = control.both(files, SEED, WINDOW_S, card)
    assert v["program"]["correct"] is True, v["program"]["compared"]
    assert v["control"]["correct"] is False, v["control"]["compared"]
