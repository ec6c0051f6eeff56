"""The port's fault injection and recovery against the JAX package's
(``tests/test_faultinject.py``'s matrix), at the golden mesh shape
(p = 8) with the reference's ruler permutations injected, so every
recovery path reproduces the committed goldens (tests/golden/) byte for
byte, counters included. Beyond the reference's matrix:

- the port's and the reference's solve fingerprints are equal;
- a port checkpoint holds the reference's keys, shapes, dtypes, bytes and
  manifest meta at the same boundary;
- a checkpoint written by the reference resumes in the port, and one
  written by the port resumes in the reference, each to golden results;
- no stage writes into a committed boundary state.

The reference's solves run in child processes
(``tests/_torch_reference_child.py``), under the legacy PRNG the goldens
were made with.
"""
import os
import shutil
import signal
import types

import numpy as np
import pytest
import torch

from _simshard_cases import SHAPE, case_record, golden_cases, load_golden
from _torch_reference_child import run_reference
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import Checkpointer, CheckpointWriteError
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.core.listrank import (FaultSpec, ListRankConfig,
                                       SolveExhausted, perm_fn_from_numpy,
                                       rank_list_with_stats, resume, sim_mesh,
                                       tuner)
from repro_torch.core.listrank.store import Store
from repro_torch.runtime.fault_tolerance import (Preempted, SolveSupervisor,
                                                 SolveSupervisorConfig)

P = SHAPE[0]
PERMS = perm_fn_from_numpy(ReferencePerms(0, P))
CASES = {}
for _name, _s, _r, _cfg in golden_cases():
    CASES[_name] = (_s, _r, ListRankConfig(**{k: getattr(_cfg, k) for k in (
        "srs_rounds", "local_contraction", "sub_capacity_slack")}))


def solve(name, **kw):
    s, r, cfg = CASES[name]
    return rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, device="cpu",
                                perm_fn=PERMS, **kw)


def record(sf, rf, stats):
    return case_record(sf.numpy(), rf.numpy(), stats)


def sup(directory, **kw):
    return SolveSupervisor(SolveSupervisorConfig(ckpt_dir=str(directory),
                                                 **kw))


def counters_of(stats):
    return {k: v for k, v in sorted(stats.items())
            if isinstance(v, int) and k != "attempts"}


def escalated(cfg, level, stat):
    """The per-level scale vector after one escalation of ``stat`` at
    ``level`` — what an injected overflow there leaves behind."""
    base = tuner.normalize_level_scales(tuner.CapacityScales(),
                                        cfg.srs_rounds + 1)
    return tuner.escalate_levels(base, level, {stat: 1})


# --------------------------------------------------------------------------
# injected overflows: level resume + escalation, bit-identity
# --------------------------------------------------------------------------

def test_overflow_at_chase_level_resumes_and_matches():
    """Forced chase overflow at descend@0: the stage re-runs with only
    the chase family escalated; ranks match the golden and the counters
    match a straight solve from the escalated scales."""
    gold = load_golden("list-g1-s1")
    sf, rf, stats = solve("list-g1-s1", inject=FaultSpec(
        "overflow", stage="descend", level=0, family="chase"))
    rec = record(sf, rf, stats)
    assert rec["succ_sha256"] == gold["succ_sha256"]
    assert rec["rank_sha256"] == gold["rank_sha256"]
    assert stats["attempts"] == 2
    assert stats["scales_log"].split(";")[1].startswith("chase=2")
    assert stats["recovery"]["injected"] == ("overflow:chase:descend@0",)
    assert stats["stage_log"].count("descend@0!overflow") == 1
    assert stats["stage_log"].count("descend@0") == 1

    cfg = CASES["list-g1-s1"][2]
    sf2, rf2, stats2 = solve("list-g1-s1",
                             initial_scales=escalated(cfg, 0, "dropped"))
    assert torch.equal(sf, sf2) and torch.equal(rf, rf2)
    assert counters_of(stats) == counters_of(stats2)


def test_overflow_at_base_level_does_not_reexecute_chase_levels():
    """Forced gather overflow at the base level of a two-level
    recursion: only base@2 re-runs, the escalation is tagged with its
    level, and the result equals the straight escalated solve."""
    gold = load_golden("euler-forest-s4")
    sf, rf, stats = solve("euler-forest-s4", inject=FaultSpec(
        "overflow", stage="base", family="gather"))
    rec = record(sf, rf, stats)
    assert rec["succ_sha256"] == gold["succ_sha256"]
    assert rec["rank_sha256"] == gold["rank_sha256"]
    assert stats["attempts"] == 2
    assert stats["scales_log"].split(";")[1].endswith("@L2")
    log = stats["stage_log"]
    for label in ("prep", "descend@0", "descend@1", "ascend@1", "ascend@0",
                  "post"):
        assert log.count(label) == 1, (label, log)
    assert log.count("base@2!overflow") == 1 and log.count("base@2") == 1

    cfg = CASES["euler-forest-s4"][2]
    sf2, rf2, stats2 = solve("euler-forest-s4",
                             initial_scales=escalated(cfg, 2, "undelivered"))
    assert torch.equal(sf, sf2) and torch.equal(rf, rf2)
    assert counters_of(stats) == counters_of(stats2)


def test_exhaustion_error_is_structured():
    with pytest.raises(SolveExhausted) as ei:
        solve("escalate-s6", max_retries=1)
    e = ei.value
    assert e.attempts == 2
    assert len(e.scales_log) == 2
    assert e.scales_log[0] == "chase=1,sub=1,gather=1,graph=1"
    assert e.fatal.get("sub_overflow", 0) > 0
    assert "sub" in e.families
    assert e.stats["sub_overflow"] > 0
    assert "escalation path" in str(e)


# --------------------------------------------------------------------------
# crash (PE loss) + corruption: checkpoint restore, no re-execution
# --------------------------------------------------------------------------

def test_pe_loss_at_base_restores_from_level_boundary(tmp_path):
    """A PE loss at the base level restores from the descend@0 boundary:
    level 0 is not re-executed (stage log and per-stage collective
    counts), and the result is the golden record."""
    supervisor = sup(tmp_path)
    sf, rf, stats = solve("list-g1-s1", supervisor=supervisor,
                          inject=FaultSpec("pe_loss", stage="base"),
                          stage_counters=True)
    assert record(sf, rf, stats) == load_golden("list-g1-s1")
    rec = stats["recovery"]
    assert rec["restarts"] == 1
    assert rec["resumed_from"] == 2          # boundary after descend@0
    assert rec["injected"] == ("pe_loss:base@1",)
    log = stats["stage_log"]
    assert log.count("prep") == 1 and log.count("descend@0") == 1
    assert log.count("base@1!InjectedFault") == 1 and log.count("base@1") == 1
    labels = [lbl for lbl, _ in stats["stage_collectives"]]
    assert labels == ["prep", "descend@0", "base@1", "ascend@0", "post"]
    counts = dict(stats["stage_collectives"])
    assert dict(counts["descend@0"]).get("all_to_all", 0) > 0


def test_pe_loss_without_checkpoint_restarts_from_scratch():
    sf, rf, stats = solve("list-g1-s1",
                          inject=FaultSpec("pe_loss", stage="base"))
    assert record(sf, rf, stats) == load_golden("list-g1-s1")
    assert stats["recovery"]["restarts"] == 1
    assert stats["stage_log"].count("prep") == 2  # scratch restart


def test_corruption_detected_and_recovered(tmp_path):
    """A corrupted store plane after descend@0 is caught before it is
    checkpointed; the solve restores the prep boundary and re-runs the
    level cleanly."""
    supervisor = sup(tmp_path)
    sf, rf, stats = solve("list-g1-s1", supervisor=supervisor,
                          inject=FaultSpec("corrupt", stage="descend",
                                           level=0, pe=3, plane="succ"))
    assert record(sf, rf, stats) == load_golden("list-g1-s1")
    rec = stats["recovery"]
    assert rec["restarts"] == 1
    assert rec["resumed_from"] == 1          # boundary after prep
    assert rec["injected"] == ("corrupt:descend@0",)
    assert stats["stage_log"].count("descend@0!CorruptedState") == 1
    assert stats["stage_log"].count("prep") == 1


def test_validate_state_names_the_corrupted_slot():
    st = Store(ids=torch.zeros(P, 64, dtype=torch.int32),
               succ=torch.zeros(P, 64, dtype=torch.int32),
               rank=torch.zeros(P, 64, dtype=torch.int32),
               valid=torch.ones(P, 64, dtype=torch.bool), dense=True)
    resume.validate_state({"stores": (st,)}, 512)
    bad = resume._apply_corruption({"stores": (st,)},
                                   FaultSpec("corrupt", pe=3), types.SimpleNamespace(p=P))
    assert int(st.succ.abs().sum()) == 0     # written into a copy
    with pytest.raises(Exception, match="plane 'succ'.* at slot 192 "):
        resume.validate_state(bad, 512)


# --------------------------------------------------------------------------
# preemption: SIGTERM-clean exit + restore-on-restart
# --------------------------------------------------------------------------

def test_preemption_mid_solve_checkpoints_and_resumes(tmp_path):
    supervisor = sup(tmp_path)
    with pytest.raises(Preempted):
        solve("list-g1-s1", supervisor=supervisor,
              inject=FaultSpec("preempt", stage="descend", level=0))
    assert supervisor.stats["preempted"] == 1
    assert supervisor.ckpt.latest_step() == 2
    assert supervisor.latest_meta()["idx"] == 2

    resumed = sup(tmp_path)
    sf, rf, stats = solve("list-g1-s1", supervisor=resumed)
    assert record(sf, rf, stats) == load_golden("list-g1-s1")
    assert stats["recovery"]["resumed_from"] == 2
    assert stats["stage_log"] == ("base@1", "ascend@0", "post")


def test_sigterm_sets_preempt_flag_and_exits_cleanly(tmp_path):
    supervisor = sup(tmp_path)
    old = {sig: signal.getsignal(sig)
           for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        returned = supervisor.install_signal_handlers()
        assert returned == old
        os.kill(os.getpid(), signal.SIGTERM)
        assert supervisor.preempted
        with pytest.raises(Preempted):
            solve("list-g1-s1", supervisor=supervisor)
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)
    assert supervisor.ckpt.latest_step() is None


def test_supervisor_stats_threaded_into_host_stats(tmp_path):
    sf, rf, stats = solve("list-g1-s1", supervisor=sup(tmp_path))
    assert record(sf, rf, stats) == load_golden("list-g1-s1")
    rec = stats["recovery"]
    assert rec["checkpoints"] == 4           # one per interior boundary
    assert rec["restarts"] == 0 and rec["preempted"] == 0
    assert rec["resumed_from"] == -1 and rec["injected"] == ()


# --------------------------------------------------------------------------
# checkpointer hardening
# --------------------------------------------------------------------------

def test_async_write_failure_surfaces_with_step(tmp_path, monkeypatch):
    ckpt = Checkpointer(tmp_path / "c", keep=3, async_save=True)
    state = {"x": torch.arange(4)}
    ckpt.save(1, state)
    ckpt.wait()

    def boom(*a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(np, "savez", boom)
    ckpt.save(2, state)                      # background write will fail
    with pytest.raises(CheckpointWriteError) as ei:
        ckpt.save(3, state)                  # surfaces step 2's failure
    assert ei.value.step == 2
    assert "step 2" in str(ei.value)
    assert isinstance(ei.value.__cause__, OSError)
    monkeypatch.undo()
    ckpt.save(3, state, blocking=True)       # recoverable afterwards
    assert ckpt.latest_step() == 3


def test_gc_never_deletes_the_step_being_written(tmp_path):
    ckpt = Checkpointer(tmp_path / "c", keep=2, async_save=False)
    state = {"x": torch.arange(4)}
    ckpt.save(5, state)
    ckpt.save(6, state)
    ckpt.save(1, state)                      # older step than the kept set
    dirs = sorted(d.name for d in (tmp_path / "c").glob("step_*"))
    assert "step_00000001" in dirs           # protected, not gc'd
    got, _ = ckpt.restore(1, {"x": torch.empty(4, dtype=torch.int64,
                                               device="meta")})
    assert torch.equal(got["x"], torch.arange(4))


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("meteor")
    with pytest.raises(ValueError):
        FaultSpec("overflow", family="warp")
    f = FaultSpec("overflow", stage="descend", level=1, family="sub")
    assert f.level == 1


# --------------------------------------------------------------------------
# committed boundaries are never written into
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [
    None, FaultSpec("overflow", stage="base", family="gather"),
    FaultSpec("corrupt", stage="descend", level=1, pe=5),
    FaultSpec("pe_loss", stage="ascend", level=1)],
    ids=["straight", "overflow", "corrupt", "pe_loss"])
def test_boundary_bytes_unchanged_after_later_stages(tmp_path, monkeypatch,
                                                     fault):
    """Each committed boundary's tensors hold the bytes they held when
    the boundary was committed, after every later stage (and every
    retry, rewind and corruption) has run."""
    kept, layout = [], resume.global_layout

    def keeping(state):
        _, leaves, _ = flatten(state)
        if leaves[0].device.type != "meta":  # not a restore's template
            kept.append((leaves, [x.clone() for x in leaves]))
        return layout(state)

    monkeypatch.setattr(resume, "global_layout", keeping)
    sf, rf, stats = solve("euler-forest-s4", supervisor=sup(tmp_path),
                          inject=fault)
    gold = load_golden("euler-forest-s4")
    rec = record(sf, rf, stats)
    assert (rec["succ_sha256"], rec["rank_sha256"]) == (
        gold["succ_sha256"], gold["rank_sha256"])
    assert len(kept) >= 6
    for i, (live, copy) in enumerate(kept):
        for a, b in zip(live, copy):
            assert torch.equal(a, b), i


# --------------------------------------------------------------------------
# against the reference: fingerprints, layout, restore both ways
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """Preempted checkpoints of list-g1-s1 after descend@0 from both
    packages, and the reference's resume of the port's (in a child)."""
    root = tmp_path_factory.mktemp("cross")
    port_dir, ref_dir = root / "port", root / "ref"
    with pytest.raises(Preempted):
        solve("list-g1-s1", supervisor=sup(port_dir),
              inject=FaultSpec("preempt", stage="descend", level=0))
    shutil.copytree(port_dir, root / "port_for_ref")
    out = run_reference({
        "fingerprints": ("fingerprints", ()),
        "preempt": ("preempted_solve", ("list-g1-s1", str(ref_dir),
                                        "descend", 0)),
        "resume_port": ("resumed_solve", ("list-g1-s1",
                                          str(root / "port_for_ref")))},
        root, procs=3)
    return port_dir, ref_dir, out


def test_fingerprints_equal_the_reference(cross):
    _, _, out = cross
    for name, (s, r, cfg) in CASES.items():
        rank = r.astype(np.float32 if r.dtype.kind == "f" else np.int32)
        fp = resume.solve_fingerprint(
            torch.from_numpy(s.astype(np.int32)).reshape(P, -1),
            torch.from_numpy(rank).reshape(P, -1), s.shape[0], P, 0, cfg)
        assert fp == out["fingerprints"][name], name


def test_checkpoint_layout_equals_the_reference(cross):
    """Keys, shapes, dtypes and bytes of every leaf, and the manifest
    meta, at the boundary after descend@0."""
    port_dir, ref_dir, out = cross
    assert out["preempt"] == 2
    mine = Checkpointer(port_dir).manifest(2)
    theirs = Checkpointer(ref_dir).manifest(2)
    assert mine["keys"] == theirs["keys"]
    assert mine["meta"] == theirs["meta"]
    step = "step_00000002/state.npz"
    with np.load(port_dir / step) as a, np.load(ref_dir / step) as b:
        assert a.files == b.files
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_reference_checkpoint_resumes_in_the_port(cross, tmp_path):
    _, ref_dir, _ = cross
    shutil.copytree(ref_dir, tmp_path / "c")
    sf, rf, stats = solve("list-g1-s1", supervisor=sup(tmp_path / "c"))
    assert record(sf, rf, stats) == load_golden("list-g1-s1")
    assert stats["recovery"]["resumed_from"] == 2
    assert stats["stage_log"] == ("base@1", "ascend@0", "post")


def test_port_checkpoint_resumes_in_the_reference(cross):
    _, _, out = cross
    got = out["resume_port"]
    assert got["record"] == load_golden("list-g1-s1")
    assert got["recovery"]["resumed_from"] == 2
    assert got["stage_log"] == ("base@1", "ascend@0", "post")
