"""The large-p matrix of ``tests/test_simshard_matrix.py`` on the port.

The port's virtual transport (``sim_mesh``) runs the solver at p = 8, 64
and 256 in one process: the regimes where the tuner's decisions (per-level
r*, the SRS-versus-doubling switch, capacities that scale with the hop
size) change. Every (p, wire format, algorithm) cell solves the four
instance families of the reference's matrix and is held to the port's
sequential oracle. The JAX package's ``test_cost_model_r_star_differs_at_large_p``
is ported with the reference's ``tuner.level_plan`` fractions as the
expectation.

The cells at p = 256 are in ``tests/test_torch_simshard_matrix_256.py``:
``--dist loadfile`` schedules by file, so the two halves run on two
workers.
"""
import numpy as np
import pytest

from repro_torch.core.listrank import (ListRankConfig, instances,
                                       rank_list_seq, rank_list_with_stats,
                                       sim_mesh, tuner)
from repro_torch.core.listrank import api as api_lib
from repro_torch.core.listrank.exchange import MeshPlan

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = ListRankConfig(srs_rounds=1, local_contraction=False)
ALGORITHMS = ("srs", "doubling", "auto")


def families(n: int) -> dict:
    """All instance families at total size n (terminals self-looped), as
    the reference's matrix draws them."""
    fams = {}
    fams["list-g1"] = instances.gen_list(n, gamma=1.0, seed=11)
    fams["random-lists"] = instances.gen_random_lists(
        n, num_lists=9, seed=12, weighted=True)
    for name, loc in (("gnm-tour", False), ("rgg2d-tour", True)):
        s, r, _ = instances.gen_euler_tour(n // 2 + 1, seed=13, locality=loc)
        fams[name] = instances.pad_to_multiple(s, r, n)[:2]
    return fams


def check_cell(p: int, packed: bool, algorithm: str) -> None:
    """One cell of the matrix: every family at n = max(512, 4p) on
    ``sim_mesh(p)`` equal to the sequential oracle."""
    n = max(512, 4 * p)
    cfg = BASE.with_(wire_packing=packed, algorithm=algorithm)
    mesh = sim_mesh(p)
    for fam, (succ, rank) in families(n).items():
        s_ref, r_ref = rank_list_seq(succ, rank)
        s, r, stats = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                           term_bound=n // p, device="cpu")
        assert np.array_equal(np.asarray(s), s_ref), (fam, p, stats)
        assert np.array_equal(np.asarray(r), r_ref), (fam, p, stats)


@pytest.mark.matrix
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("packed", (True, False), ids=("packed", "unpacked"))
@pytest.mark.parametrize("p", (8, 64))
def test_large_p_matrix(p, packed, algorithm):
    check_cell(p, packed, algorithm)


def reference_level_plans(n: int) -> dict:
    """The reference's ``tuner.level_plan`` at p = 8 and 256 for the
    matrix's cost-model config: {p: [(frac, r_total), ...]}."""
    from repro.core.listrank import ListRankConfig as RefConfig
    from repro.core.listrank import tuner as ref_tuner
    cfg = RefConfig(srs_rounds=1, local_contraction=False,
                    ruler_fraction=None)
    return {p: [(lv.frac, lv.r_total) for lv in
                ref_tuner.level_plan(cfg, p, 1, n)] for p in (8, 256)}


@pytest.mark.matrix
def test_cost_model_r_star_differs_at_large_p():
    """``ruler_fraction=None`` runs a different per-level r* at p = 256
    than at p = 8 (``tuner.level_plan`` through the solve's specs): r*
    grows with p, and at this n the p = 256 plan saturates the 1/4 cap
    while p = 8 stays below it. Every level's fraction and ruler count
    equal the reference's."""
    n = 1 << 19
    cfg = BASE.with_(ruler_fraction=None)
    lp8 = tuner.level_plan(cfg, 8, 1, n)
    lp256 = tuner.level_plan(cfg, 256, 1, n)
    ref = reference_level_plans(n)
    assert [(lv.frac, lv.r_total) for lv in lp8] == ref[8]
    assert [(lv.frac, lv.r_total) for lv in lp256] == ref[256]
    assert lp8[0].frac != lp256[0].frac
    assert lp8[0].r_total < lp256[0].r_total

    succ, rank = instances.gen_list(n, gamma=1.0, seed=21)
    s_ref, r_ref = rank_list_seq(succ, rank)
    fracs = {}
    for p, lp in ((8, lp8), (256, lp256)):
        mesh = sim_mesh(p)
        plan = MeshPlan.from_mesh(mesh, ("pe",))
        specs = api_lib.build_specs(cfg, plan, n // p, n, term_bound=1)
        # the spec the solve will run with carries the plan's fraction
        assert specs[0].ruler_frac == pytest.approx(lp[0].frac)
        s, r, stats = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                           term_bound=1, device="cpu")
        assert np.array_equal(np.asarray(s), s_ref), (p, stats)
        assert np.array_equal(np.asarray(r), r_ref), (p, stats)
        fracs[p] = specs[0].ruler_frac
    assert fracs[8] != fracs[256]
