"""The port's treealg against the JAX package's, on the CPU at p = 8.

The reference runs on its simshard backend
(``repro.core.listrank.sim_mesh(8)``) in child processes, three jobs
at once (``_torch_reference_child.py``), the port on its virtual-PE
transport with ``device="cpu"``; both from the same seeded parent
arrays, kernel flags off. Every output is integer and compared exactly:

- the device-built tour (successors, weights, ``tour_msgs``) equals the
  reference's tour construction and the host oracle, for both families at
  n in {1, 33, 257}, a forest, ±1 weights and a closed tour cut at a
  non-root;
- ``tree_stats``, ``node_depth``, ``subtree_size``, ``root_tree`` and
  ``solve_forest`` equal the reference's, and with the reference's
  ruler permutations injected so do the solver counters;
- the ``PACKED_ID_LIMIT`` guard and the bad-input checks raise as the
  reference's do (``tests/test_treealg.py``);
- a batched solve makes the collectives of one solve of the packed
  instance, one ``all_to_all`` per chase round as a single instance
  does (the counting transport stands in for the reference's jaxpr
  count);
- the front doors run on CUDA unless ``device`` is given, and take a
  tracer and the telemetry plane.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_reference_child import run_reference
from _torch_reference_perms import ReferencePerms
from _tree_oracles import dfs_stats
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.treealg import batch as batch_j
from repro_torch import obs
from repro_torch.core import treealg
from repro_torch.core.listrank import api
from repro_torch.core.listrank import (ListRankConfig, instances,
                                       perm_fn_from_numpy, rank_list_seq,
                                       rank_list_with_stats, sim_mesh)
from repro_torch.core.treealg import batch as batch_lib
from repro_torch.core.treealg import euler

P = 8
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _clear_jax():
    yield
    jax.clear_caches()


def ref_perms(seed=0):
    """The reference's ruler permutations as drawn by an in-process
    reference solve seeded ``seed``."""
    return perm_fn_from_numpy(ReferencePerms(seed, P, legacy=False))


def int_stats(stats):
    return {k: int(v) for k, v in stats.items()
            if isinstance(v, (int, np.integer))}


# --------------------------------------------------------------------------
# tour construction
# --------------------------------------------------------------------------

TOUR_CASES = [  # n, locality, num_trees, weighted, cut_at
    (1, False, 1, False, None),
    (1, True, 1, True, None),
    (33, False, 1, True, None),
    (33, True, 1, False, 17),
    (257, False, 5, True, None),
    (257, True, 1, False, 100),
]


def tour_parent(n, locality, num_trees):
    return instances.gen_tree_parents(n, seed=n, locality=locality,
                                      num_trees=num_trees)


FAMILIES = [  # name, n, seed, gen kwargs
    ("gnm", 200, 101, dict(locality=False)),
    ("rgg2d_forest", 512, 104, dict(locality=True, num_trees=4)),
]
#: further families, held against the DFS oracle (no reference solve)
ORACLE_FAMILIES = [
    ("rgg2d", 257, 102, dict(locality=True)),
    ("gnm_forest", 120, 103, dict(locality=False, num_trees=6)),
]
ROOT_TREE = (instances.gen_tree_parents(100, 3), 77)
FOREST = [instances.gen_tree_parents(n, seed=n) for n in (5, 16, 41, 64)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference result this file compares with, from three
    child processes at once."""
    jobs = {("build",) + case: ("build", (tour_parent(*case[:3]),
                                          case[3], case[4]))
            for case in TOUR_CASES}
    for name, n, seed, kw in FAMILIES:
        jobs[("tree_stats", name)] = ("tree_stats", (
            instances.gen_tree_parents(n, seed=seed, **kw),))
    jobs["root_tree"] = ("root_tree", ROOT_TREE)
    jobs["solve_forest"] = ("solve_forest", (FOREST,))
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), procs=3)


# --------------------------------------------------------------------------
# tour construction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,locality,num_trees,weighted,cut_at", TOUR_CASES)
def test_build_tour_matches_reference(ref, n, locality, num_trees, weighted,
                                      cut_at):
    parent = tour_parent(n, locality, num_trees)
    want = ref[("build", n, locality, num_trees, weighted, cut_at)]
    succ, w, n_pad = treealg.build_tour(parent, sim_mesh(P),
                                        weighted=weighted, cut_at=cut_at,
                                        device=CPU)
    assert n_pad == want["parent_pad"].shape[0]
    np.testing.assert_array_equal(succ.numpy(), want["succ"])
    np.testing.assert_array_equal(w.numpy(), want["w"])
    assert succ.dtype == w.dtype == torch.int32
    if cut_at is None:
        np.testing.assert_array_equal(succ.numpy()[:2 * n],
                                      treealg.oracle_tour(n, parent))
    # the construction's counters, from the attempt build_tour ran
    plan = api.make_plan(sim_mesh(P), ("pe",), ListRankConfig(),
                         torch.device(CPU))
    m, (cap1, cap2), closed = want["m"], want["caps"], want["closed"]
    _, _, st = euler._build_sharded(
        torch.from_numpy(want["parent_pad"].astype(np.int32)).reshape(P, m),
        cut_at if closed else -1, plan=plan, m=m, child_cap=cap1,
        reply_cap=cap2, weighted=weighted, closed=closed)
    assert {k: int(v[0]) for k, v in st.items()} == want["stats"]
    assert want["stats"]["tour_undelivered"] == 0
    assert plan.transport.counts["all_to_all"] == 2  # one per leg


@pytest.mark.parametrize("variant", ["unpacked", "pallas_pack"])
def test_build_tour_transport_variants(variant):
    """Both wire paths (and the kernel's CPU path) build the same tour."""
    cfg = (ListRankConfig(wire_packing=False) if variant == "unpacked"
           else ListRankConfig(use_pallas_pack=True))
    parent = instances.gen_tree_parents(60, 5)
    succ, _, _ = treealg.build_tour(parent, sim_mesh(P), cfg=cfg, device=CPU)
    np.testing.assert_array_equal(succ.numpy()[:120],
                                  treealg.oracle_tour(60, parent))


def test_build_tour_rejects_bad_input():
    mesh = sim_mesh(P)
    with pytest.raises(ValueError):
        treealg.build_tour(np.array([5, 0], np.int64), mesh, device=CPU)
    with pytest.raises(ValueError):
        treealg.build_tour(np.zeros(0, np.int64), mesh, device=CPU)
    with pytest.raises(ValueError, match="single-tree"):
        treealg.build_tour(np.array([0, 1, 1], np.int64), mesh, cut_at=2,
                           device=CPU)


# --------------------------------------------------------------------------
# tree statistics against the reference
# --------------------------------------------------------------------------

def _assert_tree_stats_equal(got, want):
    for k in ("parent", "root_of", "depth", "subtree_size", "preorder",
              "postorder"):
        np.testing.assert_array_equal(getattr(got, k), want[k], err_msg=k)


@pytest.mark.parametrize("name,n,seed,kw", FAMILIES)
def test_tree_stats_matches_reference(ref, name, n, seed, kw):
    parent = instances.gen_tree_parents(n, seed=seed, **kw)
    want = ref[("tree_stats", name)]
    got = treealg.tree_stats(parent, sim_mesh(P), device=CPU,
                             perm_fn=ref_perms())
    _assert_tree_stats_equal(got, want)
    assert int_stats(got.stats) == want["stats"]
    assert got.stats["attempts"] == 1
    # the single-solve fast paths give the same arrays (the reference's
    # own tests pin its fast paths to its tree_stats)
    np.testing.assert_array_equal(
        treealg.node_depth(parent, sim_mesh(P), device=CPU), want["depth"])
    np.testing.assert_array_equal(
        treealg.subtree_size(parent, sim_mesh(P), device=CPU),
        want["subtree_size"])


@pytest.mark.parametrize("name,n,seed,kw", ORACLE_FAMILIES)
def test_tree_stats_matches_dfs(name, n, seed, kw):
    parent = instances.gen_tree_parents(n, seed=seed, **kw)
    st = treealg.tree_stats(parent, sim_mesh(P), device=CPU)
    for got, want in zip((st.depth, st.subtree_size, st.preorder,
                          st.postorder), dfs_stats(parent)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        treealg.preorder(parent, sim_mesh(P), device=CPU), st.preorder)
    np.testing.assert_array_equal(
        treealg.postorder(parent, sim_mesh(P), device=CPU), st.postorder)


def test_root_tree_matches_reference(ref):
    parent, new_root = ROOT_TREE
    got = treealg.root_tree(parent, new_root, sim_mesh(P), device=CPU)
    np.testing.assert_array_equal(got, ref["root_tree"])
    assert got[new_root] == new_root


@pytest.mark.parametrize("n,new_root,seed", [(2, 1, 0), (40, 0, 2),
                                             (77, 38, 4)])
def test_root_tree_orients_the_same_edges(n, new_root, seed):
    parent = instances.gen_tree_parents(n, seed)
    newp = treealg.root_tree(parent, new_root, sim_mesh(P), device=CPU)
    assert newp[new_root] == new_root
    e_old = {frozenset((c, int(parent[c]))) for c in range(n)
             if parent[c] != c}
    e_new = {frozenset((c, int(newp[c]))) for c in range(n) if newp[c] != c}
    assert e_old == e_new
    depth = dfs_stats(newp)[0]
    assert (depth[np.arange(n) != new_root] > 0).all()


def test_solve_forest_matches_reference(ref):
    got = treealg.solve_forest(FOREST, sim_mesh(P), device=CPU,
                               perm_fn=ref_perms())
    want = ref["solve_forest"]
    for g, w in zip(got, want):
        _assert_tree_stats_equal(g, w)
    assert int_stats(got[0].stats) == want[0]["stats"]


# --------------------------------------------------------------------------
# guards and bad inputs (the reference's tests/test_treealg.py:185-220)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("parent", [[1, 0, 0], [1, 2, 0], [0, 2, 3, 1]])
def test_roots_and_sizes_rejects_cycles(parent):
    with pytest.raises(ValueError, match="cycle"):
        treealg.roots_and_sizes(np.asarray(parent, np.int64))


def test_batch_rejects_out_of_range_ids():
    good = instances.gen_list(16, 1.0, seed=0)
    bad_succ = np.array([0, 5], np.int32)  # 5 out of range for n=2
    with pytest.raises(ValueError, match="out of range"):
        treealg.pack_instances([good, (bad_succ, np.zeros(2, np.int32))])
    with pytest.raises(ValueError, match="out of range"):
        treealg.solve_forest([np.array([0, 2]), np.array([0, 0, 1])],
                             sim_mesh(P), device=CPU)


def test_pack_instances_int32_overflow_guard():
    big = np.broadcast_to(np.int32(0), (1 << 29,))
    zeros = np.broadcast_to(np.int32(0), (1 << 29,))
    with pytest.raises(ValueError, match="overflows the int32"):
        treealg.pack_instances([(big, zeros)] * 4)  # 2^31 ids
    limit = batch_lib.PACKED_ID_LIMIT
    assert limit == batch_j.PACKED_ID_LIMIT
    batch_lib._check_packed_size(limit, "t")  # fits
    with pytest.raises(ValueError, match="split the batch"):
        batch_lib._check_packed_size(limit + 1, "t")
    # solve_forest guards the *arc* id space (2x the packed nodes)
    with pytest.raises(ValueError, match="overflows the int32"):
        treealg.solve_forest([np.broadcast_to(np.int64(0), (1 << 30,))],
                             sim_mesh(P), device=CPU)


def test_pack_unpack_roundtrip():
    batch = [instances.gen_list(33, 1.0, seed=s, num_lists=2)
             for s in range(3)]
    succ, rank, offsets = treealg.pack_instances(batch)
    assert succ.shape[0] == 99 and offsets[-1] == 99
    for (s0, r0), (s1, r1) in zip(batch, treealg.unpack_results(
            succ, rank, offsets)):
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(r0, r1)


def test_is_ancestor_and_subtree_interval():
    parent = instances.gen_tree_parents(70, seed=13, num_trees=3)
    st = treealg.tree_stats(parent, sim_mesh(P), device=CPU)
    n = st.n_nodes
    ref = np.zeros((n, n), bool)
    for x in range(n):
        w = x
        while True:
            ref[w, x] = True
            if parent[w] == w:
                break
            w = int(parent[w])
    got = st.is_ancestor(np.arange(n)[:, None], np.arange(n)[None, :])
    np.testing.assert_array_equal(got, ref)
    lo, hi = st.subtree_interval(np.arange(n))
    for u in range(0, n, 7):
        inside = (st.root_of == st.root_of[u]) & \
            (st.preorder >= lo[u]) & (st.preorder <= hi[u])
        np.testing.assert_array_equal(inside, ref[u])


# --------------------------------------------------------------------------
# the batched front door: one solve, no extra collectives
# --------------------------------------------------------------------------

def test_rank_lists_is_one_solve_of_the_packed_instance(monkeypatch):
    batch = [instances.gen_list(256, 1.0, seed=s) for s in range(3)]
    batch.append(instances.gen_random_lists(256, num_lists=4, seed=7,
                                            weighted=True))
    calls = []
    real = batch_lib.rank_list_with_stats

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(batch_lib, "rank_list_with_stats", spy)
    results, stats = treealg.rank_lists_with_stats(
        batch, sim_mesh(P), device=CPU, stage_counters=True)
    assert len(calls) == 1, "batch must cost ONE solver invocation"
    for (s_in, r_in), (s_out, r_out) in zip(batch, results):
        s_ref, r_ref = rank_list_seq(s_in, r_in)
        np.testing.assert_array_equal(s_out, s_ref)
        np.testing.assert_array_equal(r_out, r_ref)

    succ, rank, _ = treealg.pack_instances(batch)
    _, _, single = rank_list_with_stats(succ, rank, sim_mesh(P), device=CPU,
                                        stage_counters=True)
    assert stats["stage_collectives"] == single["stage_collectives"]
    # per chase round one all_to_all (direct routing, packed wire), in the
    # batched solve as in a single instance of another size
    _, _, st1 = rank_list_with_stats(*instances.gen_list(1024, 1.0, seed=9),
                                       sim_mesh(P), device=CPU,
                                       stage_counters=True)
    for st in (stats, st1):
        coll = dict(st["stage_collectives"])
        chase = sum(dict(coll[f"descend@{k}"]).get("all_to_all", 0)
                    for k in range(2))
        assert chase == st["rounds"] // P > 0


def test_front_doors_run_on_cuda_unless_told(monkeypatch):
    parent = instances.gen_tree_parents(16, 1)
    mesh = sim_mesh(P)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: treealg.build_tour(parent, mesh),
                 lambda: treealg.tree_stats(parent, mesh),
                 lambda: treealg.root_tree(parent, 3, mesh),
                 lambda: treealg.solve_forest([parent], mesh),
                 lambda: treealg.rank_lists([(np.arange(8), np.zeros(8))],
                                            mesh)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the tracer and the telemetry plane run, and change nothing
    plain = treealg.tree_stats(parent, mesh, device=CPU)
    tracer = obs.Tracer()
    got = treealg.tree_stats(parent, mesh, tracer=tracer, device=CPU,
                             cfg=ListRankConfig(telemetry=True))
    for k in ("depth", "subtree_size", "preorder", "postorder"):
        np.testing.assert_array_equal(getattr(got, k), getattr(plain, k))
    assert int_stats(got.stats) == int_stats(plain.stats)
    (tour,) = tracer.find(name="build_tour")
    assert tour.args["telemetry"]["tele"]["graph"]["rounds"] > 0
    assert [s["label"] for s in got.stats["telemetry"]["stages"]] == list(
        got.stats["stage_log"])
