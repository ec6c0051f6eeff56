"""The port's list examples against the reference's, on the CPU:
``examples/torch_quickstart.py`` (at n = 2^14, its ``--n``) and
``examples/torch_euler_tour.py`` (the reference's 4097-node tree).

The reference's solves run as its examples call them, on a jax mesh of 8
CPU devices in child processes (``_torch_reference_child.py``), from the
same numpy-seeded inputs. With the reference's ruler permutations
injected through the example's ``perm_fn`` every output array is bit
equal to the reference's and so is every integer counter the solve
reports (the printed ``rounds``, ``sub_size``, ``chase_msgs`` and
``rulers`` among them), and the auto-tuned level plan's ruler fractions
and r* are the reference's. With the port's own permutations, and with
``--kernels`` (the kernels' plain versions on the CPU), the outputs are
still the reference's.
"""
import numpy as np
import pytest

from _torch_examples import (P, assert_same_array, int_stats, load_example,
                             ref_perms)
from _torch_reference_child import run_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.listrank import instances

QUICK_N = 1 << 14
TOUR_NODES = 4097
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    succ, rank = instances.gen_list(QUICK_N, gamma=1.0, seed=0)
    s_t, r_t, arcs = instances.gen_euler_tour(TOUR_NODES, seed=3,
                                              locality=True)
    s_t, r_t = instances.pad_to_multiple(s_t, r_t, P)
    jobs = {"quickstart": ("quickstart_example", (succ, rank)),
            "euler_tour": ("euler_tour_example", (s_t, r_t, arcs))}
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), devices=P,
                         procs=2)


@pytest.fixture(scope="module")
def quickstart():
    return load_example("torch_quickstart")


@pytest.fixture(scope="module")
def euler_tour():
    return load_example("torch_euler_tour")


def test_quickstart_matches_reference_with_its_permutations(ref, quickstart,
                                                            capsys):
    got = quickstart.main(["--n", str(QUICK_N)] + CPU, perm_fn=ref_perms(0))
    want = ref["quickstart"]
    printed = capsys.readouterr().out
    assert "matches the sequential oracle" in printed
    for key in ("succ", "rank", "rank_auto"):
        assert_same_array(got[key], want[key], key)
    assert int_stats(got["stats"]) == want["stats"]
    assert int_stats(got["stats_auto"]) == want["stats_auto"]
    assert got["level_fracs"] == want["level_fracs"]
    assert got["r_star"] == want["r_star"]
    rounds, auto_rounds = (want[k]["rounds"] // P
                           for k in ("stats", "stats_auto"))
    assert f"chase rounds:    {rounds} " in printed
    assert f"subproblem size: {want['stats']['sub_size']} " in printed
    assert f"chase messages:  {want['stats']['chase_msgs']} " in printed
    assert (f"rounds {auto_rounds} vs {rounds} fixed, rulers "
            f"{want['stats_auto']['rulers']} vs {want['stats']['rulers']}"
            in printed)


@pytest.mark.parametrize("flags", [[], ["--kernels"]],
                         ids=["as_written", "kernels"])
def test_quickstart_outputs_match_reference(ref, quickstart, flags):
    got = quickstart.main(["--n", str(QUICK_N)] + CPU + flags)
    for key in ("succ", "rank", "rank_auto"):
        assert_same_array(got[key], ref["quickstart"][key], key)


def test_euler_tour_matches_reference_with_its_permutations(ref, euler_tour,
                                                            capsys):
    got = euler_tour.main(CPU, perm_fn=ref_perms(0))
    want = ref["euler_tour"]
    for key in ("rank", "depth", "size", "parent"):
        assert_same_array(got[key], want[key], key)
    assert int_stats(got["stats"]) == want["stats"]
    assert (f"list-ranking rounds: {want['stats']['rounds'] // P}, "
            f"messages: {want['stats']['chase_msgs']}"
            in capsys.readouterr().out)


@pytest.mark.parametrize("flags", [[], ["--kernels"]],
                         ids=["as_written", "kernels"])
def test_euler_tour_outputs_match_reference(ref, euler_tour, flags):
    got = euler_tour.main(CPU + flags)
    for key in ("rank", "depth", "size", "parent"):
        assert_same_array(got[key], ref["euler_tour"][key], key)

