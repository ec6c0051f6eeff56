"""The port's graphalg against the JAX package's, on the CPU at p = 8.

The reference runs on its simshard backend in child processes, three
jobs at once (``_torch_reference_child.py``), the port on its virtual-PE
transport with ``device="cpu"``; both from the same seeded
edge lists (``instances.gen_graph_edges``), kernel flags off. Every
output is integer and compared exactly:

- ``graph_stats``: components, forest parents, depth, subtree size, pre-
  and postorder, every graph counter (``cc_*``, ``tour_*``,
  ``stats_*``) and — with the reference's ruler permutations for
  ``seed`` and ``seed + 1`` injected — every solver counter;
- ``connected_components`` and ``spanning_forest`` on the GNM and RGG2D
  families, single- and multi-component, and on the degenerate inputs
  (empty edge list, a singleton, a single edge, isolated nodes);
- the per-round collective counts of the hooking, shortcut, tour and
  finalize rounds do not depend on the instance (the counting transport
  stands in for the reference's static jaxpr count);
- the composed one-attempt solve equals the staged front door's;
- the front doors run on CUDA unless ``device`` is given, and take a
  tracer and the telemetry plane.
"""
import jax
import numpy as np
import pytest
import torch

from _graph_oracles import check_spanning_forest
from _torch_reference_child import run_reference
from _torch_reference_perms import ReferencePerms
from _tree_oracles import dfs_stats
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import obs
from repro_torch.core import graphalg
from repro_torch.core.listrank import (ListRankConfig, api, instances,
                                       perm_fn_from_numpy, rank_list_seq,
                                       rank_list_with_stats, sim_mesh)

P = 8
CPU = "cpu"
ARRAYS = ("components", "parent", "depth", "subtree_size", "preorder",
          "postorder")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax():
    yield
    jax.clear_caches()


def ref_perms_for(seed):
    """The reference's ruler permutations of the solve seeded ``seed``,
    as an in-process reference solve draws them."""
    return perm_fn_from_numpy(ReferencePerms(seed, P, legacy=False))


def int_stats(stats):
    return {k: int(v) for k, v in stats.items()
            if isinstance(v, (int, np.integer))}


#: name -> (n, E, gen kwargs): GNM-like, RGG2D-like, multi-component
FAMILIES = [
    ("gnm", 48, 80, dict(locality=False)),
    ("rgg2d", 48, 80, dict(locality=True)),
    ("gnm_multi", 60, 70, dict(locality=False, num_components=4)),
    ("rgg2d_multi", 60, 70, dict(locality=True, num_components=3)),
    ("sparse_multi", 24, 12, dict(locality=False, num_components=12)),
]
DEGENERATE = {
    "empty": (np.zeros((0, 2), np.int64), 5),
    "singleton": (np.zeros((0, 2), np.int64), 1),
    "single_edge": (np.array([[3, 1]]), 5),
    "loops_and_duplicates": (np.array([[2, 2], [3, 1], [1, 3], [3, 1]]), 4),
    "isolated_nodes": (np.array([[5, 6]]), 8),
}


def family_edges(name):
    _, n, e, kw = next(f for f in FAMILIES if f[0] == name)
    return instances.gen_graph_edges(n, e, seed=len(name), **kw), n


STATS_CASES = ["gnm", "rgg2d_multi"]
DEGENERATE_CASES = ["empty", "singleton", "single_edge",
                    "loops_and_duplicates"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference result this file compares with, from three
    child processes at once."""
    jobs = {("graph_stats", name): ("graph_stats", family_edges(name))
            for name in STATS_CASES}
    jobs[("graph_stats", "isolated_nodes")] = (
        "graph_stats", DEGENERATE["isolated_nodes"])
    for name in DEGENERATE_CASES:
        jobs[("cc", name)] = ("connected_components", DEGENERATE[name])
    for name, *_ in FAMILIES:
        jobs[("cc", name)] = ("connected_components", family_edges(name))
    jobs["forest"] = ("spanning_forest", family_edges("gnm_multi"))
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), procs=3)


# --------------------------------------------------------------------------
# graph_stats end to end, counters included
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", STATS_CASES)
def test_graph_stats_matches_reference(ref, name):
    edges, n = family_edges(name)
    want = ref[("graph_stats", name)]
    got = graphalg.graph_stats(edges, n, sim_mesh(P), device=CPU,
                               perm_fn_for=ref_perms_for)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), want[k], err_msg=k)
    assert int_stats(got.stats) == want["stats"]
    assert got.stats["attempts"] == 1
    # the forest is a valid rooted spanning forest, and the statistics
    # are its DFS numbers
    assert check_spanning_forest(n, edges, got.parent, got.components) == []
    for a, b in zip((got.depth, got.subtree_size, got.preorder,
                     got.postorder), dfs_stats(got.parent)):
        np.testing.assert_array_equal(a, b)


def test_graph_stats_isolated_nodes_match_reference(ref):
    edges, n = DEGENERATE["isolated_nodes"]
    want = ref[("graph_stats", "isolated_nodes")]
    got = graphalg.graph_stats(edges, n, sim_mesh(P), device=CPU,
                               perm_fn_for=ref_perms_for)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), want[k], err_msg=k)
    assert int_stats(got.stats) == want["stats"]
    np.testing.assert_array_equal(got.subtree_size, [1, 1, 1, 1, 1, 2, 1, 1])
    np.testing.assert_array_equal(got.postorder, [0, 0, 0, 0, 0, 1, 0, 0])


@pytest.mark.parametrize("name", DEGENERATE_CASES)
def test_graph_stats_degenerate_inputs(ref, name):
    """The degenerate inputs against the reference's labels (the
    components prefix) and the DFS numbers of the emitted forest."""
    edges, n = DEGENERATE[name]
    labels_j, _ = ref[("cc", name)]
    gs = graphalg.graph_stats(edges, n, sim_mesh(P), device=CPU)
    np.testing.assert_array_equal(gs.components, labels_j)
    assert check_spanning_forest(n, edges, gs.parent, gs.components) == []
    for a, b in zip((gs.depth, gs.subtree_size, gs.preorder, gs.postorder),
                    dfs_stats(gs.parent)):
        np.testing.assert_array_equal(a, b)
    assert gs.stats["forest_edges"] == n - np.unique(labels_j).size


# --------------------------------------------------------------------------
# the prefixes: components and the spanning forest
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [f[0] for f in FAMILIES])
def test_connected_components_matches_reference(ref, name):
    edges, n = family_edges(name)
    want, st_j = ref[("cc", name)]
    got, st = graphalg.connected_components(edges, n, sim_mesh(P),
                                            device=CPU)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert int_stats(st) == st_j


def test_spanning_forest_matches_reference(ref):
    edges, n = family_edges("gnm_multi")
    p_j, l_j, st_j = ref["forest"]
    parent, labels, st = graphalg.spanning_forest(
        edges, n, sim_mesh(P), device=CPU, perm_fn_for=ref_perms_for)
    np.testing.assert_array_equal(parent, p_j)
    np.testing.assert_array_equal(labels, l_j)
    assert int_stats(st) == st_j


def test_kernel_flags_and_wire_paths_do_not_change_bits():
    edges, n = family_edges("rgg2d")
    ref = graphalg.graph_stats(edges, n, sim_mesh(P), device=CPU)
    for cfg in (ListRankConfig(use_pallas=True, use_pallas_pack=True),
                ListRankConfig(wire_packing=False)):
        got = graphalg.graph_stats(edges, n, sim_mesh(P), cfg=cfg,
                                   device=CPU)
        for k in ARRAYS:
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
        assert int_stats(got.stats) == int_stats(ref.stats)


def test_rejects_bad_edges():
    with pytest.raises(ValueError, match="out of range"):
        graphalg.connected_components(np.array([[0, 9]]), 4, sim_mesh(P),
                                      device=CPU)
    with pytest.raises(ValueError, match="\\(E, 2\\)"):
        graphalg.connected_components(np.zeros((3,), np.int64), 4,
                                      sim_mesh(P), device=CPU)


# --------------------------------------------------------------------------
# collectives per round do not depend on the instance
# --------------------------------------------------------------------------

def test_pipeline_collective_count_static():
    small = graphalg.pipeline_collective_footprint(
        instances.gen_graph_edges(32, 48, seed=1), 32, sim_mesh(P),
        device=CPU)
    large = graphalg.pipeline_collective_footprint(
        instances.gen_graph_edges(128, 256, seed=2, locality=True,
                                  num_components=2), 128, sim_mesh(P),
        device=CPU)
    for label in ("cc:hook", "cc:stats", "cc:end", "tour", "finalize"):
        # one dict per label: every round of the unit made the same calls
        assert isinstance(small[label], dict), (label, small[label])
        assert small[label] == large[label], label
    # a shortcut iteration is one gather pass (2 hops + the pending psum)
    # and the changed-count psum; its mailboxes are slack-sized, so an
    # iteration may add whole passes for the overflow, never anything else
    one = {"all_to_all": 2, "psum": 2}
    for fp in (small, large):
        jumps = fp["cc:jump"] if isinstance(fp["cc:jump"], tuple) \
            else (fp["cc:jump"],)
        assert one in jumps
        for c in jumps:
            extra = (c["all_to_all"] - 2) // 2
            assert c == {"all_to_all": 2 + 2 * extra, "psum": 2 + extra}
    # a hooking round: label gather (2 hops) + proposals + confirmations
    assert small["cc:hook"]["all_to_all"] == 4
    assert small["tour"]["all_to_all"] == 2
    # the solves' stages run the staged solve's schedule, twice
    stages = [k for k in small if k.startswith("solve")]
    assert stages == [f"solve{i}:{s}" for i in (1, 2) for s in (
        "prep", "descend@0", "descend@1", "base@2", "ascend@1", "ascend@0",
        "post")]
    cc_only = graphalg.pipeline_collective_footprint(
        instances.gen_graph_edges(32, 48, seed=1), 32, sim_mesh(P),
        mode="cc", device=CPU)
    assert "tour" not in cc_only and cc_only["cc:hook"] == small["cc:hook"]


# --------------------------------------------------------------------------
# the composed solve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [
    ListRankConfig(), ListRankConfig(avoid_reversal=False, srs_rounds=1),
    ListRankConfig(algorithm="doubling")], ids=["default", "reversal",
                                                "doubling"])
def test_composed_solve_equals_the_front_door(variant):
    succ, rank = instances.gen_list(2048, gamma=1.0, seed=5)
    mesh = sim_mesh(P)
    perm_fn = ref_perms_for(3)
    s_ref, r_ref, st_ref = rank_list_with_stats(
        succ, rank, mesh, cfg=variant, device=CPU, perm_fn=perm_fn)
    assert st_ref["attempts"] == 1
    plan = api.make_plan(mesh, ("pe",), variant, torch.device(CPU))
    m = succ.shape[0] // P
    tb = int(np.bincount((np.arange(succ.shape[0]) // m)[
        succ == np.arange(succ.shape[0])], minlength=P).max())
    specs = api.build_specs(variant, plan, m, succ.shape[0], tb)
    s, r, st = api._solve_sharded(
        torch.from_numpy(succ).reshape(P, m),
        torch.from_numpy(rank.astype(np.int32)).reshape(P, m), perm_fn,
        plan=plan, cfg=variant, specs=specs, m=m)
    np.testing.assert_array_equal(s.reshape(-1).numpy(), s_ref.numpy())
    np.testing.assert_array_equal(r.reshape(-1).numpy(), r_ref.numpy())
    np.testing.assert_array_equal(r.reshape(-1).numpy(),
                                  rank_list_seq(succ, rank)[1])
    assert {k: int(v) for k, v in st.items()} == {
        k: v for k, v in int_stats(st_ref).items() if k != "attempts"}


# --------------------------------------------------------------------------
# the front doors' device contract
# --------------------------------------------------------------------------

def test_front_doors_run_on_cuda_unless_told(monkeypatch):
    edges, n = family_edges("gnm")
    mesh = sim_mesh(P)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (graphalg.connected_components, graphalg.spanning_forest,
               graphalg.graph_stats):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(edges, n, mesh)
    # the tracer and the telemetry plane run, and change nothing
    plain = graphalg.connected_components(edges, n, mesh, device=CPU)
    tracer = obs.Tracer()
    labels, stats = graphalg.connected_components(
        edges, n, mesh, tracer=tracer, cfg=ListRankConfig(telemetry=True),
        device=CPU)
    np.testing.assert_array_equal(labels, plain[0])
    assert int_stats(stats) == int_stats(plain[1])
    (rec,) = stats["telemetry"]["stages"]
    assert rec["label"] == "graphalg:cc" and rec["tele"]["graph"]["rounds"]
    assert [sp.name for sp in tracer.spans] == ["graphalg:cc",
                                                "graphalg:cc#1"]
