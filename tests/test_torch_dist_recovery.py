"""Supervision and fault injection under the ``torch.distributed``
transport: 2 gloo ranks of 4 PEs each (p = 8, the golden mesh shape),
the reference's ruler permutations injected, against the goldens, the
virtual transport and the JAX package:

- the reference's fault matrix (``tests/test_faultinject.py``, as
  ``tests/test_torch_faultinject.py`` runs it on one process): a forced
  overflow, a lost PE and a corrupted plane, each at a PE of either rank,
  and a preemption on every rank or on rank 1 alone, reproduce the
  golden records, stage logs and recovery accounting on both ranks;
- a world-2 boundary checkpoint equals the virtual transport's at the
  same boundary in keys, manifest meta and every byte, and there is one
  set of step directories;
- each transport resumes the other's checkpoint, the reference resumes
  the world-2 checkpoint, and the world-2 solve resumes the reference's,
  each to the golden record;
- a preemption on rank 1 alone stops both ranks at the same boundary;
- a checkpoint write that fails on rank 0, async or blocking, raises
  ``CheckpointWriteError`` on both ranks;
- the fingerprint each rank computes from its blocks is the same on both
  ranks and equals the reference's, for every golden case.

Every job has a timeout; a rank's failure fails the test.
"""
import os
import shutil

import numpy as np
import pytest

import _simshard_cases as cases_lib
from _torch_dist_rank import RankPool
from _torch_reference_child import run_reference
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.listrank import (FaultSpec, ListRankConfig,
                                       perm_fn_from_numpy,
                                       rank_list_with_stats, sim_mesh)
from repro_torch.runtime.fault_tolerance import (Preempted, SolveSupervisor,
                                                 SolveSupervisorConfig)

P = cases_lib.SHAPE[0]
WORLD = 2
#: a PE of each rank (rank r holds PEs [4r, 4r + 4))
PE_OF = {0: 1, 1: 6}
CASES = {name: (s, r, ListRankConfig(**{k: getattr(cfg, k) for k in (
    "srs_rounds", "local_contraction", "sub_capacity_slack")}))
    for name, s, r, cfg in cases_lib.golden_cases()}
SOLVE_S, SPAWN_S = 60, 120


@pytest.fixture(scope="module")
def pools():
    """The world-2 pool of gloo ranks, spawned on first use and again
    after a job that failed or timed out closed it."""
    made: dict[int, RankPool] = {}

    def get(world: int = WORLD) -> RankPool:
        if world not in made or made[world].closed:
            made[world] = RankPool(world, start_timeout=SPAWN_S)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


@pytest.fixture(scope="module")
def table():
    """The reference's permutations of every golden case (drawn by
    virtual solves of each)."""
    t = ReferencePerms(0, P)
    for s, r, cfg in CASES.values():
        rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, device="cpu",
                             perm_fn=perm_fn_from_numpy(t))
    return dict(t)


def supervised(pools, table, name, ckpt_dir, faults=(None, None)):
    """The world-2 supervised solve of golden case ``name`` on
    ``ckpt_dir``, ``faults[r]`` given to rank r: both ranks' results."""
    s, r, cfg = CASES[name]
    return pools().run("supervised", s, r, (P,), ("pe",), cfg, table,
                       str(ckpt_dir), list(faults), {}, timeout=SOLVE_S)


def virtual(table, name, ckpt_dir, inject=None):
    s, r, cfg = CASES[name]
    return rank_list_with_stats(
        s, r, sim_mesh(P), cfg=cfg, device="cpu",
        perm_fn=perm_fn_from_numpy(table),
        supervisor=SolveSupervisor(SolveSupervisorConfig(
            ckpt_dir=str(ckpt_dir))), inject=inject)


def record(out):
    return cases_lib.case_record(out["succ"], out["rank"], out["stats"])


def both(spec):
    return [[spec], [spec]]


# --------------------------------------------------------------------------
# the fault matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("owner", [0, 1])
def test_pe_loss_on_either_rank_restores_the_level_boundary(pools, table,
                                                            tmp_path, owner):
    outs = supervised(pools, table, "list-g1-s1", tmp_path, both(FaultSpec(
        "pe_loss", stage="base", pe=PE_OF[owner])))
    for out in outs:
        assert record(out) == cases_lib.load_golden("list-g1-s1")
        rec = out["stats"]["recovery"]
        assert (rec["restarts"], rec["resumed_from"]) == (1, 2)
        assert rec["injected"] == ("pe_loss:base@1",)
        assert out["stats"]["stage_log"] == (
            "prep", "descend@0", "base@1!InjectedFault", "base@1",
            "ascend@0", "post")


@pytest.mark.parametrize("owner", [0, 1])
def test_corruption_on_either_rank_is_caught_and_recovered(pools, table,
                                                           tmp_path, owner):
    outs = supervised(pools, table, "list-g1-s1", tmp_path, both(FaultSpec(
        "corrupt", stage="descend", level=0, pe=PE_OF[owner])))
    for out in outs:
        assert record(out) == cases_lib.load_golden("list-g1-s1")
        rec = out["stats"]["recovery"]
        assert (rec["restarts"], rec["resumed_from"]) == (1, 1)
        assert out["stats"]["stage_log"].count("descend@0!CorruptedState") \
            == 1 and out["stats"]["stage_log"].count("prep") == 1


@pytest.mark.parametrize("ranks", [(0, 1), (1,)], ids=["every", "rank1"])
@pytest.mark.parametrize("name,spec", [
    ("list-g1-s1", FaultSpec("overflow", stage="descend", level=0,
                             family="chase")),
    ("euler-forest-s4", FaultSpec("overflow", stage="base",
                                  family="gather"))], ids=["chase", "gather"])
def test_forced_overflow_escalates_on_every_rank(pools, table, tmp_path,
                                                 ranks, name, spec):
    """Given to one rank only, the overflow still escalates every rank's
    stage: the same attempts, escalation path and golden outputs."""
    faults = [[spec] if r in ranks else None for r in range(WORLD)]
    gold = cases_lib.load_golden(name)
    outs = supervised(pools, table, name, tmp_path, faults)
    label = f"{spec.stage}@{spec.level if spec.level is not None else 2}"
    for out in outs:
        rec = record(out)
        assert (rec["succ_sha256"], rec["rank_sha256"]) == (
            gold["succ_sha256"], gold["rank_sha256"])
        assert out["stats"]["attempts"] == 2
        assert out["stats"]["stage_log"].count(f"{label}!overflow") == 1
    assert outs[0]["stats"]["scales_log"] == outs[1]["stats"]["scales_log"]


@pytest.mark.parametrize("ranks", [(0, 1), (1,)], ids=["every", "rank1"])
def test_preemption_stops_both_ranks_at_one_boundary_and_resumes(
        pools, table, tmp_path, ranks):
    spec = FaultSpec("preempt", stage="descend", level=0)
    faults = [[spec] if r in ranks else None for r in range(WORLD)]
    outs = supervised(pools, table, "list-g1-s1", tmp_path, faults)
    for out in outs:
        assert out["preempted"] == 2
        assert out["recovery"]["preempted"] == 1
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]
    for out in supervised(pools, table, "list-g1-s1", tmp_path):
        assert record(out) == cases_lib.load_golden("list-g1-s1")
        assert out["stats"]["recovery"]["resumed_from"] == 2
        assert out["stats"]["stage_log"] == ("base@1", "ascend@0", "post")


@pytest.mark.parametrize("fail_call,preempt,step", [
    (1, False, 1), (3, True, 2)], ids=["async", "blocking"])
def test_a_failed_write_on_rank0_raises_on_both_ranks(pools, table,
                                                      tmp_path, fail_call,
                                                      preempt, step):
    """Rank 0 alone writes; when its write fails, both ranks raise
    ``CheckpointWriteError`` for that step: an async write's failure at
    the next boundary, a blocking write's (the preemption's, rank 0's
    third write) at once. Neither rank is left waiting in a collective."""
    spec = FaultSpec("preempt", stage="descend", level=0) if preempt \
        else None
    s, r, cfg = CASES["list-g1-s1"]
    outs = pools().run("failed_write", s, r, (P,), ("pe",), cfg, table,
                       str(tmp_path), [spec, spec], fail_call,
                       timeout=SOLVE_S)
    assert outs == [{"raised": "CheckpointWriteError", "step": step}] * WORLD


# --------------------------------------------------------------------------
# checkpoints against the virtual transport and the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross(pools, table, tmp_path_factory):
    """Checkpoints of list-g1-s1 preempted after descend@0 by the world-2
    solve, the virtual transport and the reference; the reference's
    resume of the world-2 one, and its fingerprints."""
    root = tmp_path_factory.mktemp("dist_cross")
    preempt = FaultSpec("preempt", stage="descend", level=0)
    supervised(pools, table, "list-g1-s1", root / "dist", both(preempt))
    with pytest.raises(Preempted):
        virtual(table, "list-g1-s1", root / "virtual", preempt)
    shutil.copytree(root / "dist", root / "dist_for_ref")
    out = run_reference({
        "fingerprints": ("fingerprints", ()),
        "preempt": ("preempted_solve", ("list-g1-s1", str(root / "ref"),
                                        "descend", 0)),
        "resume_dist": ("resumed_solve", ("list-g1-s1",
                                          str(root / "dist_for_ref")))},
        root, procs=3)
    return root, out


def test_world2_checkpoint_equals_the_virtual_transports(cross):
    import json
    root, _ = cross
    for step in (1, 2):
        d = f"step_{step:08d}"
        mine = json.loads((root / "dist" / d / "manifest.json").read_text())
        theirs = json.loads((root / "virtual" / d / "manifest.json"
                             ).read_text())
        assert mine["keys"] == theirs["keys"]
        assert mine["meta"] == theirs["meta"]
        with np.load(root / "dist" / d / "state.npz") as a, \
                np.load(root / "virtual" / d / "state.npz") as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (step, k)


def test_each_transport_resumes_the_others_checkpoint(pools, table, cross,
                                                      tmp_path):
    root, _ = cross
    gold = cases_lib.load_golden("list-g1-s1")
    shutil.copytree(root / "virtual", tmp_path / "v")
    for out in supervised(pools, table, "list-g1-s1", tmp_path / "v"):
        assert record(out) == gold
        assert out["stats"]["stage_log"] == ("base@1", "ascend@0", "post")
    shutil.copytree(root / "dist", tmp_path / "d")
    sf, rf, st = virtual(table, "list-g1-s1", tmp_path / "d")
    assert cases_lib.case_record(sf.numpy(), rf.numpy(), st) == gold
    assert st["recovery"]["resumed_from"] == 2


def test_reference_and_world2_resume_each_others_checkpoints(pools, table,
                                                             cross, tmp_path):
    root, out = cross
    gold = cases_lib.load_golden("list-g1-s1")
    assert out["resume_dist"]["record"] == gold
    assert out["resume_dist"]["recovery"]["resumed_from"] == 2
    assert out["preempt"] == 2
    shutil.copytree(root / "ref", tmp_path / "r")
    for got in supervised(pools, table, "list-g1-s1", tmp_path / "r"):
        assert record(got) == gold
        assert got["stats"]["recovery"]["resumed_from"] == 2
        assert got["stats"]["stage_log"] == ("base@1", "ascend@0", "post")


def test_fingerprint_is_the_references_on_both_ranks(pools, cross):
    _, out = cross
    for name, (s, r, cfg) in CASES.items():
        got = pools().run("fingerprint", s, r, (P,), ("pe",), cfg, 0,
                          timeout=SOLVE_S)
        assert got == [out["fingerprints"][name]] * WORLD, name
