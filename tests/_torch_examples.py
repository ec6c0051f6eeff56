"""Shared by the port's example tests (``tests/test_torch_examples*.py``):
the examples imported as modules and the reference's ruler
permutations for injecting into them."""
import importlib.util
import os

import numpy as np

from _torch_reference_perms import ReferencePerms
from repro_torch.core.listrank import perm_fn_from_numpy

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
P = 8


def load_example(name: str):
    """``examples/{name}.py`` imported as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_perms(seed: int = 0):
    """The reference's ruler permutations of a solve seeded ``seed`` at
    p = 8, as a solve in the reference's process draws them."""
    return perm_fn_from_numpy(ReferencePerms(seed, P, legacy=False))


def int_stats(stats) -> dict:
    return {k: int(v) for k, v in stats.items()
            if isinstance(v, (int, np.integer))}


def assert_same_array(got, want, what: str) -> None:
    """The same dtype, shape and bytes."""
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), what
    assert got.tobytes() == want.tobytes(), what
