"""On the card, at each cell's own size: one call a distinct input of the
measured entry is ``correct``, and the TF32 control in its place is not.
Skips without a CUDA device (``-m cuda``; run from the repository root)."""

import pytest

from portbench import compare, harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["splat.clip16", "pool.streams8", "pool.clip16"])
def test_cell_correct_and_control_not(card, name):
    cell = harness.load_cell(name)
    pipe = harness.make_pipeline(cell, card)
    prog = harness.readings(cell, pipe, 2**31 + 11, card)
    assert prog["stream_calls_compared"] > 0
    assert compare.within(prog, cell.limits), prog
    ctl = harness.readings(cell, pipe, 2**31 + 11, card, control=True)
    assert not compare.within(ctl, cell.limits), ctl
