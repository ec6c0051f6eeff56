"""The port's tree and graph examples against the reference's, on the
CPU: ``examples/torch_tree_stats.py`` (five trees of 93..2048 nodes, the
largest re-rooted) and ``examples/torch_connectivity.py`` (2^11 nodes,
2^12 edges, the reference's sizes).

The reference's front doors run as its examples call them, on a jax
mesh of 8 CPU devices in child processes (``_torch_reference_child.py``),
from the same numpy-seeded inputs. With the reference's ruler
permutations injected (``perm_fn``, ``perm_fn_for``) every output array
and every integer counter (``attempts``, ``rounds``, ``chase_msgs``,
``cc_rounds``, ``cc_msgs`` among them) equals the reference's; with the
port's own permutations, and with ``--kernels`` (their plain versions on
the CPU), the outputs still do.
"""
import pytest

from _torch_examples import (P, assert_same_array, int_stats, load_example,
                             ref_perms)
from _torch_reference_child import (GRAPH_ARRAYS, TREE_ARRAYS,
                                    run_reference)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.listrank import instances

CPU = ["--device", "cpu"]
N, E = 1 << 11, 1 << 12


@pytest.fixture(scope="module")
def tree_stats():
    return load_example("torch_tree_stats")


@pytest.fixture(scope="module")
def connectivity():
    return load_example("torch_connectivity")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, tree_stats, connectivity):
    parents = [instances.gen_tree_parents(n, seed=i, locality=bool(i % 2))
               for i, n in enumerate(tree_stats.SIZES)]
    cc_graphs = {fam: instances.gen_graph_edges(N, E, seed=42, **kw)
                 for fam, kw in connectivity.FAMILIES}
    edges = instances.gen_graph_edges(N, E, seed=7, locality=True,
                                      num_components=3)
    jobs = {"connectivity": ("connectivity_example", (cc_graphs, edges, N)),
            "tree_stats": ("tree_stats_example", (parents,))}
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), devices=P,
                         procs=2)


def assert_tree_arrays(got, want, names, what):
    for name in names:
        assert_same_array(getattr(got, name), want[name], f"{what} {name}")


def test_tree_stats_matches_reference_with_its_permutations(ref, tree_stats,
                                                            capsys):
    got = tree_stats.main(CPU, perm_fn=ref_perms(0))
    want = ref["tree_stats"]
    assert len(got["forest"]) == len(want["forest"])
    for i, (st, w) in enumerate(zip(got["forest"], want["forest"])):
        assert_tree_arrays(st, w, TREE_ARRAYS, f"tree {i}")
        assert int_stats(st.stats) == w["stats"]
    assert (got["big"], got["deepest"]) == (want["big"], want["deepest"])
    assert_same_array(got["rerooted"], want["rerooted"], "rerooted")
    solve = want["forest"][0]["stats"]
    assert (f"one batched solve: attempts={solve['attempts']}, chase "
            f"rounds={solve['rounds'] // P}, messages={solve['chase_msgs']}"
            in capsys.readouterr().out)


@pytest.mark.parametrize("flags", [[], ["--kernels"]],
                         ids=["as_written", "kernels"])
def test_tree_stats_outputs_match_reference(ref, tree_stats, flags):
    got = tree_stats.main(CPU + flags)
    for i, (st, w) in enumerate(zip(got["forest"], ref["tree_stats"]
                                    ["forest"])):
        assert_tree_arrays(st, w, TREE_ARRAYS, f"tree {i}")
    assert_same_array(got["rerooted"], ref["tree_stats"]["rerooted"],
                      "rerooted")


def test_connectivity_matches_reference_with_its_permutations(
        ref, connectivity, capsys):
    got = connectivity.main(CPU, perm_fn_for=ref_perms)
    want = ref["connectivity"]
    for fam, (labels, stats) in got["cc"].items():
        assert_same_array(labels, want["cc"][fam][0], fam)
        assert int_stats(stats) == want["cc"][fam][1]
    assert_tree_arrays(got["graph"], want["graph"], GRAPH_ARRAYS, "graph")
    assert int_stats(got["graph"].stats) == want["graph"]["stats"]
    assert_tree_arrays(got["tree"], want["tree"], TREE_ARRAYS, "forest")
    assert int_stats(got["tree"].stats) == want["tree"]["stats"]
    printed = capsys.readouterr().out
    for fam, (_, stats) in want["cc"].items():
        assert (f"in {stats['cc_rounds']} hooking rounds ({stats['cc_msgs']}"
                f" messages)" in printed)
    # the five ancestor queries read the reference's numbers
    g = want["graph"]
    for x in got["queried"]:
        lo = int(g["preorder"][x])
        hi = lo + int(g["subtree_size"][x]) - 1
        assert f"node {x}: subtree preorder interval [{lo}, {hi}]" in printed


@pytest.mark.parametrize("flags", [[], ["--kernels"]],
                         ids=["as_written", "kernels"])
def test_connectivity_outputs_match_reference(ref, connectivity, flags):
    got = connectivity.main(CPU + flags)
    want = ref["connectivity"]
    for fam, (labels, _) in got["cc"].items():
        assert_same_array(labels, want["cc"][fam][0], fam)
    assert_tree_arrays(got["graph"], want["graph"], GRAPH_ARRAYS, "graph")
    assert_tree_arrays(got["tree"], want["tree"], TREE_ARRAYS, "forest")
