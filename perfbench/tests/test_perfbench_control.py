"""Each cell's control comes out not correct: the tree configuration's
(the reference summed in bfloat16) on the CPU at a small size, the list
configurations' (the program's float32 weight path) on the card, where
distances pass 2^24."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench.tests._cells import harness, tiny_spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a float32 distance rounds only "
                    "above 2^24 elements")
    from repro_torch.kernels import build
    build.build()
    return "cuda"


@pytest.mark.parametrize("locality", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_perfbench_tree_control_is_not_correct(locality, seed):
    spec = tiny_spec("tree.gnm")
    spec["traffic"] = dict(spec["traffic"], locality=locality)
    sound = harness.run_cell(spec, seed, 0.0, False, time.time(), "cpu",
                             warm=False)
    control = harness.run_cell(spec, seed, 0.0, False, time.time(), "cpu",
                               variant="Control", warm=False)
    assert sound["correct"] and not control["correct"]


@pytest.mark.torch_cuda
def test_perfbench_list_control_is_not_correct(card):
    spec = harness.cell_spec("list.g1")
    spec["traffic"] = dict(spec["traffic"], n=1 << 25)
    control = harness.run_cell(spec, 5, 0.0, False, time.time(), card,
                               variant="Control", warm=False)
    assert not control["correct"]
    assert control["checks"]["rank_mismatches"]["value"] > 0
