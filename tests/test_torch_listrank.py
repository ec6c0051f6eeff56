"""The port's whole solve (the staged main path) on the CPU.

- every configuration variant of the reference's single-mesh suite
  matches the sequential oracle at p=1 and p=8;
- the committed golden records (produced by the reference on an 8-PE
  mesh) are reproduced exactly — output hashes, attempts, escalation
  path and every counter — once the reference's ruler permutations are
  injected;
- an int and a float instance match the oracle at p in {8, 64};
- the front door's contract: CUDA by default, supervision, fault
  injection, the tracer and the telemetry plane run, ``backend="mesh"``
  refuses a SimMesh.
"""
import numpy as np
import pytest
import torch

import _simshard_cases as cases_lib
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import obs
from repro_torch.core.listrank import (FaultSpec, IndirectionSpec,
                                       ListRankConfig, instances,
                                       perm_fn_from_numpy, rank_list_seq,
                                       rank_list_with_stats, sim_mesh)
from repro_torch.runtime.fault_tolerance import (SolveSupervisor,
                                                 SolveSupervisorConfig)


BASE = ListRankConfig(srs_rounds=1, local_contraction=False)
VARIANTS = {
    "srs1": BASE,
    "srs2": BASE.with_(srs_rounds=2),
    "srs1_contract": BASE.with_(local_contraction=True),
    "srs2_contract": BASE.with_(srs_rounds=2, local_contraction=True),
    "reversal": BASE.with_(avoid_reversal=False),
    "doubling": BASE.with_(algorithm="doubling"),
    "doubling_contract": BASE.with_(algorithm="doubling",
                                    local_contraction=True),
    "allgather_base": BASE.with_(base_case="allgather"),
    "nodedup": BASE.with_(dedup_requests=False),
    "pallas_contract": BASE.with_(local_contraction=True, use_pallas=True),
    "unpacked": BASE.with_(wire_packing=False),
    "unpacked_srs2": BASE.with_(srs_rounds=2, local_contraction=True,
                                wire_packing=False),
    "pallas_pack": BASE.with_(use_pallas_pack=True),
    "auto_tuned": BASE.with_(ruler_fraction=None),
    "auto_tuned_srs2": BASE.with_(ruler_fraction=None, srs_rounds=2,
                                  local_contraction=True),
}


def _check(succ, rank, mesh, cfg, **kw):
    s_ref, r_ref = rank_list_seq(succ, rank)
    s, r, stats = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                       device="cpu", **kw)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(r.numpy(), r_ref)
    assert all(stats[k] == 0 for k in ("dropped", "sub_overflow",
                                       "store_miss", "undelivered"))
    return stats


@pytest.mark.parametrize("p", [1, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_match_oracle(variant, p):
    succ, rank = instances.gen_list(256, gamma=1.0, seed=3)
    _check(succ, rank, sim_mesh(p), VARIANTS[variant])


_CASES = cases_lib.golden_cases()


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_golden_records_reproduced(case):
    name, succ, rank, ref_cfg = case
    cfg = ListRankConfig(**{k: getattr(ref_cfg, k) for k in (
        "srs_rounds", "local_contraction", "sub_capacity_slack")})
    s, r, stats = rank_list_with_stats(
        succ, rank, sim_mesh(cases_lib.SHAPE, cases_lib.AXES), cfg=cfg,
        device="cpu",
        perm_fn=perm_fn_from_numpy(ReferencePerms(0, cases_lib.SHAPE[0])))
    rec = cases_lib.case_record(s.numpy(), r.numpy(), stats)
    golden = cases_lib.load_golden(name)
    assert rec == golden, {k: (rec[k], golden[k]) for k in rec
                           if rec[k] != golden[k]}


@pytest.mark.parametrize("p", [8, 64])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_int_and_float_instances_at_p(kind, p):
    succ, rank = instances.gen_random_lists(2048, num_lists=5, seed=p,
                                            weighted=True)
    if kind == "float":
        # integer-valued weights: exact in every summation order
        rng = np.random.default_rng(p)
        rank = rng.integers(0, 4, succ.shape[0]).astype(np.float32)
        rank[succ == np.arange(succ.shape[0])] = 0
    _check(succ, rank, sim_mesh(p), ListRankConfig(use_pallas=True,
                                                   use_pallas_pack=True))


def test_grid_indirection_and_kernel_flags_do_not_change_bits():
    succ, rank = instances.gen_list(2048, gamma=1.0, seed=9)
    mesh = sim_mesh((2, 4), ("row", "col"))
    ind = IndirectionSpec.grid(("row", "col"))
    outs = []
    for on in (True, False):
        cfg = ListRankConfig(use_pallas=on, use_pallas_pack=on)
        stats = _check(succ, rank, mesh, cfg, indirection=ind, seed=2)
        s, r, _ = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                       indirection=ind, seed=2, device="cpu")
        outs.append((s, r, {k: v for k, v in stats.items()
                            if isinstance(v, int)}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def test_stage_counters_count_collectives_per_stage():
    succ, rank = instances.gen_list(1024, gamma=1.0, seed=5)
    counts = {}
    for packed in (True, False):
        _, _, stats = rank_list_with_stats(
            succ, rank, sim_mesh(8), cfg=ListRankConfig(wire_packing=packed),
            device="cpu", stage_counters=True)
        coll = dict(stats["stage_collectives"])
        assert tuple(coll) == stats["stage_log"]
        counts[packed] = {k: dict(v) for k, v in coll.items()}
    for label, c in counts[True].items():
        # same rounds, so the same number of route calls; a packed hop is
        # one all_to_all, an unpacked one is one per leaf plus validity
        if c.get("all_to_all"):
            assert counts[False][label]["all_to_all"] > c["all_to_all"]
        assert counts[False][label].get("psum") == c.get("psum")


def test_front_door_contract(monkeypatch, tmp_path):
    succ, rank = instances.gen_list(64, gamma=1.0, seed=1)
    mesh = sim_mesh(4)
    # a SimMesh is no device mesh: backend="mesh" refuses it, as the
    # reference does (the torch.distributed transport runs on a DistMesh)
    with pytest.raises(ValueError, match="requires a real device mesh"):
        rank_list_with_stats(succ, rank, mesh, device="cpu",
                             cfg=ListRankConfig(backend="mesh"))
    # the tracer and the telemetry plane run, and change nothing
    s0, r0, st0 = rank_list_with_stats(succ, rank, mesh, device="cpu")
    tracer = obs.Tracer()
    s1, r1, st1 = rank_list_with_stats(
        succ, rank, mesh, device="cpu", tracer=tracer,
        cfg=ListRankConfig(telemetry=True))
    assert torch.equal(s0, s1) and torch.equal(r0, r1)
    assert {k: v for k, v in st0.items() if isinstance(v, int)} == \
        {k: v for k, v in st1.items() if isinstance(v, int)}
    assert [s["label"] for s in st1["telemetry"]["stages"]] == list(
        st1["stage_log"])
    assert [sp.name for sp in tracer.find(cat="stage")] == list(
        st1["stage_log"])
    assert "telemetry" not in st0
    # supervision and fault injection run
    supervisor = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=str(
        tmp_path)))
    _, _, stats = rank_list_with_stats(
        succ, rank, mesh, device="cpu", supervisor=supervisor,
        inject=FaultSpec("pe_loss", stage="base"))
    assert stats["recovery"]["injected"] == (
        f"pe_loss:base@{ListRankConfig().srs_rounds}",)
    assert stats["recovery"]["restarts"] == 1
    assert supervisor.ckpt.latest_step() is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rank_list_with_stats(succ, rank, mesh)
