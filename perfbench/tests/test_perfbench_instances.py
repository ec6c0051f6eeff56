"""The benchmark's frozen generators equal the port's at the same seed."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import instances
from perfbench.paths import list as list_path, tree as tree_path
from perfbench.tests import _cells  # noqa: F401  (the port on the path)
from repro_torch.core.listrank import instances as port


@pytest.mark.parametrize("gamma,num_lists,seed", [
    (1.0, 1, 0), (1.0, 1, 3141592653), (0.5, 4, 7), (0.0, 1, 2**33 + 1)])
def test_perfbench_gen_list_equals_the_ports(gamma, num_lists, seed):
    got = instances.gen_list(5000, gamma, seed=seed, num_lists=num_lists)
    want = port.gen_list(5000, gamma, seed=seed, num_lists=num_lists)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("locality,num_trees,seed", [
    (False, 1, 0), (True, 1, 2718281828), (False, 6, 5), (True, 3, 2**40)])
def test_perfbench_gen_tree_parents_equals_the_ports(locality, num_trees,
                                                     seed):
    got = instances.gen_tree_parents(5000, seed=seed, locality=locality,
                                     num_trees=num_trees)
    want = port.gen_tree_parents(5000, seed=seed, locality=locality,
                                 num_trees=num_trees)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_perfbench_make_follows_the_traffic_file():
    """Each front door draws its own instance from its traffic file."""
    inst, units = list_path.make({"n": 64, "gamma": 1.0}, 9)
    assert units == 64 and np.array_equal(
        inst["succ"], instances.gen_list(64, 1.0, seed=9)[0])
    inst, units = list_path.make({"n": 64, "gamma": 0.5, "num_lists": 3},
                                 9)
    assert np.array_equal(
        inst["rank"], instances.gen_list(64, 0.5, seed=9, num_lists=3)[1])
    inst, units = tree_path.make({"n": 64, "locality": True}, 9)
    assert units == 64 and np.array_equal(
        inst["parent"], instances.gen_tree_parents(64, 9, True))
    with pytest.raises(KeyError):
        tree_path.make({"n": 64, "gamma": 1.0}, 9)
