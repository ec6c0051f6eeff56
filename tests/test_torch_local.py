"""Local contraction and pointer doubling of the port against the
reference's, per PE and bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.listrank import instances as ref_instances
from repro.core.listrank import local as ref_local
from repro_torch.core.listrank import exchange, local, store, transport
from repro_torch.core.listrank.doubling import allgather_solve, doubling_solve
from repro_torch.core.listrank.sequential import rank_list_seq

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("gamma", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_contract_matches_reference_per_pe(gamma, dtype, use_pallas):
    p, m = 8, 64
    succ, _ = ref_instances.gen_list(p * m, gamma=gamma, seed=4, num_lists=5)
    rng = np.random.default_rng(1)
    rank = (rng.normal(size=p * m) if dtype == "float32"
            else rng.integers(-3, 9, p * m)).astype(dtype)
    rank[succ == np.arange(p * m)] = 0
    base = torch.arange(p, dtype=torch.int32) * m
    succ_c, rank_c, rep, aux = local.contract(
        torch.from_numpy(succ).reshape(p, m),
        torch.from_numpy(rank).reshape(p, m), base, m, use_pallas)
    for pe in range(p):
        sl = slice(pe * m, (pe + 1) * m)
        r = ref_local.contract(jnp.asarray(succ[sl]), jnp.asarray(rank[sl]),
                               jnp.int32(pe * m), m)
        ours = (succ_c[pe], rank_c[pe], rep[pe], aux["S"][pe], aux["D"][pe],
                aux["stop_is_term"][pe])
        theirs = (r[0], r[1], r[2], r[3]["S"], r[3]["D"],
                  r[3]["stop_is_term"])
        for a, b in zip(ours, theirs):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype
            assert a.numpy().tobytes() == b.tobytes()


def _dense_store(succ, rank, p, dev="cpu"):
    m = succ.shape[0] // p
    s = torch.from_numpy(succ).reshape(p, m)
    r = torch.from_numpy(rank).reshape(p, m)
    base = torch.arange(p, dtype=torch.int32) * m
    return store.make_dense_store(s, r, torch.ones_like(s, dtype=torch.bool),
                                  base), m


@pytest.mark.parametrize("solver", ["doubling", "allgather"])
def test_base_case_solvers_match_oracle(solver):
    p = 8
    succ, rank = ref_instances.gen_random_lists(512, num_lists=6, seed=2,
                                                weighted=True)
    st, m = _dense_store(succ, rank, p)
    plan = exchange.MeshPlan.from_mesh(transport.sim_mesh(p), ("pe",))
    if solver == "doubling":
        out, stats = doubling_solve(plan, st, lambda g: g // m, 64, 64, 40)
        assert stats["pd_converged"]
        assert int(stats["pd_undelivered"].sum()) == 0
    else:
        out, stats = allgather_solve(plan, st)
    s_ref, r_ref = rank_list_seq(succ, rank)
    np.testing.assert_array_equal(out.succ.reshape(-1).numpy(), s_ref)
    np.testing.assert_array_equal(out.rank.reshape(-1).numpy(), r_ref)


def test_sparse_slot_of_is_left_searchsorted():
    ids = torch.tensor([[2, 5, 9, 2 ** 31 - 1], [1, 3, 3, 7]],
                       dtype=torch.int32)
    st = store.Store(ids=ids, succ=ids, rank=ids,
                     valid=torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1]],
                                        dtype=torch.bool))
    q = torch.tensor([[5, 6, 2 ** 31 - 1, 0], [3, 7, 8, 1]],
                     dtype=torch.int32)
    slot, found = store.slot_of(st, q)
    ref = [np.clip(np.searchsorted(ids[i].numpy(), q[i].numpy(), "left"),
                   0, 3) for i in range(2)]
    np.testing.assert_array_equal(slot.numpy(), np.stack(ref))
    np.testing.assert_array_equal(found.numpy(), [[1, 0, 0, 0], [1, 1, 0, 1]])
