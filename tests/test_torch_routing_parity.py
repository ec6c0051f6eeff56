"""The routings no other port test holds against the reference, on a
three-axis mesh (2, 2, 4) ("node", "row", "col") at n = 512, on the CPU:

- topology-aware routing, ``topology(("col",), ("node", "row"))``: an
  intra-node hop over the minor axis, then one hop over the other two;
- ``auto_indirection=True``: the port's tuner chooses the reference's
  hops, and the solve under them is the reference's;
- pointer doubling over the three-hop grid.

With the reference's ruler permutations injected (drawn in the mode the
child's solve draws them), every output is bit equal to the reference's
and so is every integer counter. The reference's three solves run in a
pool of children (``_torch_reference_child.py``). Then, port only and
against the sequential oracle on the same mesh under the topology spec:
pointer doubling, the faithful reversal, the all-gather base and the
unpacked wire, each with the kernels' flags on and off.
"""
import numpy as np
import pytest
import torch

from _torch_examples import int_stats
from _torch_reference_child import run_reference
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.listrank import (IndirectionSpec, ListRankConfig,
                                       instances, perm_fn_from_numpy,
                                       rank_list_seq, rank_list_with_stats,
                                       sim_mesh, tuner)

N = 512
SHAPE, NAMES = (2, 2, 4), ("node", "row", "col")
TOPOLOGY = ("topology", ("col",), ("node", "row"))
#: {case: (ListRankConfig fields, indirection)}, the longest first
CASES = {"topology": ({}, TOPOLOGY),
         "auto_indirection": ({"auto_indirection": True}, None),
         "doubling_grid": ({"algorithm": "doubling"}, ("grid",))}


def _spec(ind):
    if ind is None:
        return None
    if ind[0] == "grid":
        return IndirectionSpec.grid(NAMES)
    return IndirectionSpec.topology(*ind[1:])


@pytest.fixture(scope="module")
def instance():
    return instances.gen_list(N, gamma=1.0, seed=1)


@pytest.fixture(scope="module")
def ref(instance, tmp_path_factory):
    succ, rank = instance
    jobs = {case: ("routing_solve", (succ, rank, SHAPE, NAMES) + CASES[case])
            for case in CASES}
    return run_reference(jobs, tmp_path_factory.mktemp("ref"),
                         procs=len(jobs))


@pytest.mark.parametrize("case", list(CASES))
def test_routing_matches_reference(case, instance, ref):
    succ, rank = instance
    fields, ind = CASES[case]
    s, r, stats = rank_list_with_stats(
        succ, rank, sim_mesh(SHAPE, NAMES), cfg=ListRankConfig(**fields),
        indirection=_spec(ind), device="cpu",
        perm_fn=perm_fn_from_numpy(ReferencePerms(0, 16, legacy=False)))
    want = ref[case]
    assert s.numpy().tobytes() == want["succ"].astype(np.int32).tobytes()
    assert r.numpy().dtype == want["rank"].dtype
    assert r.numpy().tobytes() == want["rank"].tobytes()
    assert int_stats(stats) == want["stats"]


def test_tuner_chooses_the_reference_hops(ref):
    got = tuner.choose_indirection(ListRankConfig(), NAMES, SHAPE, N)
    assert got.hops == ref["auto_indirection"]["chosen"]
    # on three axes the topology spec is its own path: two hops, the
    # second over two axes
    assert got == _spec(TOPOLOGY)
    # under it the auto solve is the explicit topology solve
    assert ref["auto_indirection"]["stats"] == ref["topology"]["stats"]


@pytest.mark.parametrize("variant", [
    {"algorithm": "doubling"},
    {"avoid_reversal": False},
    {"base_case": "allgather"},
    {"wire_packing": False, "srs_rounds": 2}],
    ids=["doubling", "reversal", "allgather_base", "unpacked"])
def test_topology_variants_match_oracle(variant):
    succ, rank = instances.gen_list(4096, gamma=0.5, seed=7)
    s_ref, r_ref = rank_list_seq(succ, rank)
    mesh, spec = sim_mesh(SHAPE, NAMES), _spec(TOPOLOGY)
    outs = []
    for on in (True, False):
        s, r, stats = rank_list_with_stats(
            succ, rank, mesh, cfg=ListRankConfig(**variant, use_pallas=on,
                                                 use_pallas_pack=on),
            indirection=spec, seed=3, device="cpu")
        np.testing.assert_array_equal(s.numpy(), s_ref)
        np.testing.assert_array_equal(r.numpy(), r_ref)
        assert all(stats[k] == 0 for k in ("dropped", "sub_overflow",
                                           "store_miss", "undelivered"))
        outs.append((s, r, int_stats(stats)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]
    if variant.get("avoid_reversal") is False:
        assert outs[0][2]["reversal_msgs"] > 0
