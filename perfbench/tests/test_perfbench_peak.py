"""``peak_gib`` reads what the program holds, not how many calls the
window made: what a list window keeps for the check leaves the card, so
a window of many calls peaks where a window of one call does."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench.tests._cells import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the peak is the card's allocator's")
    from repro_torch.kernels import build
    build.build()
    return "cuda"


@pytest.mark.torch_cuda
def test_perfbench_list_peak_does_not_grow_with_calls(card):
    spec = harness.cell_spec("list.g1")
    spec["traffic"] = dict(spec["traffic"], n=1 << 18)
    one = harness.run_cell(spec, 7, 0.0, False, time.time(), card)
    many = harness.run_cell(spec, 7, 3.0, False, time.time(), card)
    assert one["correct"] and many["correct"]
    assert one["attempted"] == 1 and many["attempted"] >= 4
    assert (many["device"]["memory_peak_bytes"]
            == one["device"]["memory_peak_bytes"])
