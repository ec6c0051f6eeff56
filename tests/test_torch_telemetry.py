"""The port's telemetry plane (``ListRankConfig(telemetry=True)``,
``repro_torch.obs.telemetry``) on the CPU, against the JAX package's
(``tests/test_telemetry.py``'s suite, and the reference's records):

1. **telemetry changes nothing** — the 7 committed golden records
   (output hashes, attempts, escalation path, every counter) are
   reproduced with the tracer and telemetry on; the per-stage
   collectives are those of the telemetry-off solve; a checkpoint taken
   with telemetry on holds the same bytes as one taken with it off; the
   records do not depend on the kernel flags; and a stage's record
   reaches the host in one copy, with no other host read added;
2. **the records are the reference's** — every per-stage StageRecord
   (and the headroom report) of ``list-g1-s1`` and ``escalate-s6`` with
   the reference's permutations, of a ``tree_stats`` call (its tour's
   record too) and of a ``connected_components`` call equal the
   reference's JSON exactly, and so does the span tree (names,
   categories, nesting, fault instants) of a golden solve with a sub
   overflow, a lost PE and a corrupted plane, supervised and traced
   (the reference's solves run in the child processes of
   ``tests/_torch_reference_child.py``);
3. **the host half** (merge, aggregate, headroom, DKW back-test, skew
   rows) is exact on synthetic input and equal to the reference's on
   the same input.

Every comparison is exact (``==``) unless a line says otherwise.
"""
import json

import numpy as np
import pytest
import torch

from _graph_oracles import union_find_labels
from _simshard_cases import SHAPE, case_record, golden_cases, load_golden
from _torch_reference_child import run_reference
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import obs
from repro_torch.core import graphalg, treealg
from repro_torch.core.listrank import (FaultSpec, ListRankConfig, instances,
                                       perm_fn_from_numpy,
                                       rank_list_with_stats, resume, sim_mesh)
from repro_torch.obs import cost as cost_lib
from repro_torch.obs import telemetry as tele_lib
from repro_torch.runtime.fault_tolerance import (Preempted, SolveSupervisor,
                                                 SolveSupervisorConfig)

P = SHAPE[0]
CPU = "cpu"
PERMS = perm_fn_from_numpy(ReferencePerms(0, P))
CASES = {name: (s, r, ListRankConfig(**{k: getattr(cfg, k) for k in (
    "srs_rounds", "local_contraction", "sub_capacity_slack")}))
    for name, s, r, cfg in golden_cases()}
RECORD_CASES = ("list-g1-s1", "escalate-s6")
TREE = instances.gen_tree_parents(200, seed=101, locality=False)
GRAPH = (instances.gen_graph_edges(48, 80, seed=3, locality=False), 48)
#: the faulted, supervised golden solve of the span-tree comparison
FAULTS = (("overflow", "descend", 0, "sub"), ("pe_loss", "base", None,
                                              "chase"),
          ("corrupt", "ascend", 0, "chase"))


def faults_for(fault_spec):
    return [fault_spec(kind, stage=stage, level=level, family=fam)
            for kind, stage, level, fam in FAULTS]


def solve(name, telemetry=True, **kw):
    s, r, cfg = CASES[name]
    return rank_list_with_stats(s, r, sim_mesh(P),
                                cfg=cfg.with_(telemetry=telemetry),
                                device=CPU, perm_fn=PERMS, **kw)


def span_tree(tracer):
    return {"spans": [(s.name, s.cat, s.depth, s.parent)
                      for s in tracer.spans],
            "instants": [(s.name, s.cat, s.depth) for s in tracer.instants]}


def as_json(x):
    return json.loads(json.dumps(x))


def ints(stats):
    return {k: v for k, v in stats.items() if isinstance(v, int)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference record this file compares with, from three
    child processes at once."""
    jobs = {name: ("telemetry_solve", (name,)) for name in RECORD_CASES}
    jobs["tree"] = ("tree_telemetry", (TREE,))
    jobs["cc"] = ("graph_telemetry", ("cc",) + GRAPH)
    from repro.core.listrank import FaultSpec as RefFaultSpec
    tmp = tmp_path_factory.mktemp("ref")
    jobs["faulted"] = ("telemetry_solve", ("list-g1-s1", str(tmp / "ckpt"),
                                           faults_for(RefFaultSpec)))
    return run_reference(jobs, tmp, procs=3)


# --------------------------------------------------------------------------
# the device half
# --------------------------------------------------------------------------

def test_merge_semantics():
    """MAX_KEYS leaves merge by elementwise max, the rest add; None is
    the identity; keys are unioned and a one-sided leaf keeps its own
    shape and dtype."""
    a = {"fill_max": torch.tensor([0.25, 1.0]),
         "rounds": torch.tensor([2, 0], dtype=torch.int32),
         "sub": {"queue_hwm": torch.tensor([3, 1], dtype=torch.int32)}}
    b = {"fill_max": torch.tensor([0.75, 0.5]),
         "rounds": torch.tensor([1, 1], dtype=torch.int32),
         "hist": torch.ones((2, tele_lib.HIST_BINS), dtype=torch.int32)}
    m = tele_lib.merge(a, b)
    assert m["fill_max"].tolist() == [0.75, 1.0]
    assert m["rounds"].tolist() == [3, 1] and m["rounds"].dtype == torch.int32
    assert m["hist"] is b["hist"]
    assert m["sub"]["queue_hwm"] is a["sub"]["queue_hwm"]
    assert tele_lib.merge(None, a) is a and tele_lib.merge(a, None) is a
    z = tele_lib.stage_zero(2, 1, CPU)
    w = tele_lib.merge(z, {"chase": tele_lib.route_zero(2, 1, CPU),
                           "queue_hwm": torch.tensor([4, 0],
                                                     dtype=torch.int32)})
    assert set(w) == set(z) and w["queue_hwm"].tolist() == [4, 0]
    assert w["sub"] is z["sub"]


def test_stage_zero_shapes():
    tele = tele_lib.stage_zero(5, 3, CPU)
    assert set(tele) == set(tele_lib.STAGE_FAMILIES) | {"queue_hwm"}
    assert tele["queue_hwm"].shape == (5,)
    for fam in tele_lib.STAGE_FAMILIES:
        rec = tele[fam]
        assert rec["fill_max"].shape == (5, 3)
        assert rec["fill_max"].dtype == torch.float32
        assert rec["hist"].shape == (5, tele_lib.HIST_BINS)
        assert rec["hist"].dtype == torch.int32
        assert rec["rounds"].shape == (5,)


def test_route_wave_and_store_fill_arithmetic():
    """A fill over a static cap is the count times the float32
    reciprocal of the cap (the reference's compiled arithmetic), the
    skew a true float32 division; every int leaf is int32."""
    hops = [{"demand_max": torch.tensor([15, 3], dtype=torch.int32),
             "delivered": torch.tensor([7, 3], dtype=torch.int32),
             "total": torch.tensor([40, 0], dtype=torch.int32),
             "cap": 100, "s": 3}]
    hist = torch.zeros((2, tele_lib.HIST_BINS), dtype=torch.int32)
    w = tele_lib.route_wave(hops, hist)
    f32 = np.float32
    assert w["fill_max"][:, 0].tolist() == [
        float(f32(15) * (f32(1) / f32(100))), float(f32(3) * (f32(1) /
                                                               f32(100)))]
    assert w["fill_max"][0, 0].item() != float(f32(15) / f32(100))
    assert w["fill_mean_sum"][0, 0].item() == float(
        f32(7) * (f32(1) / f32(300)))
    assert w["dest_frac_max"][:, 0].tolist() == [float(f32(15) / f32(40)),
                                                 3.0]
    assert w["rounds"].tolist() == [1, 1]
    assert {v.dtype for k, v in w.items() if k in ("hist", "rounds")} == {
        torch.int32}
    rec = tele_lib.store_fill(2, 2, torch.tensor([150, 20],
                                                 dtype=torch.int32), 100)
    assert rec["fill_max"][:, 1].tolist() == [0.0, 0.0]
    assert rec["fill_mean_sum"][0, 0].item() == 1.0  # min(fill, 1)
    assert rec["fill_max"][0, 0].item() == float(f32(150) * (f32(1) /
                                                             f32(100)))


@pytest.mark.parametrize("s,cap", [(1, 4), (3, 2), (8, 5), (13, 3),
                                   (16, 1)])
def test_hop_sample_equals_the_rowwise_definition(s, cap):
    """The hop sample read off the sorted keys equals the reference's
    row-wise definition on the same bucket sort: the largest
    within-bucket rank + 1 over valid rows, the rows that fit, the valid
    rows, and the histogram of ``coord * HIST_BINS // s`` over valid
    rows."""
    from repro_torch.core.listrank import api, exchange
    g = torch.Generator().manual_seed(s)
    p, q = 4, 60
    coord = torch.randint(0, s, (p, q), generator=g, dtype=torch.int32)
    coord[0] = 0  # one PE's traffic all in bucket 0
    valid = torch.rand((p, q), generator=g) < 0.7
    valid[1] = False  # one PE with nothing to send
    plan = api.make_plan(sim_mesh(p), ("pe",), ListRankConfig(),
                         torch.device(CPU))
    _, _, _, fits, left, skey = exchange._bucket_indices(coord, valid, s,
                                                         cap)
    sample, hist = exchange._hop_sample(plan, skey, s, cap, True)
    _, _, pos, _ = exchange.sort_and_group(coord, valid, s)
    infit = fits | left
    nb = tele_lib.HIST_BINS
    assert sample["demand_max"].tolist() == torch.where(
        infit, pos + 1, 0).max(1).values.tolist()
    assert sample["delivered"].tolist() == fits.sum(1).tolist()
    assert sample["total"].tolist() == infit.sum(1).tolist()
    want = torch.zeros((p, nb), dtype=torch.int64)
    for i in range(p):
        for c in coord[i][valid[i]].tolist():
            want[i, c * nb // s] += 1
    assert hist.tolist() == want.tolist()
    assert {t.dtype for t in (sample["demand_max"], sample["delivered"],
                              sample["total"], hist)} == {torch.int32}


def test_to_host_is_one_copy_and_exact(monkeypatch):
    """A record reaches the host through one ``.cpu()`` of one int32
    tensor; float32 leaves come back bit for bit and the host half
    aggregates it as the reference aggregates the same numpy record."""
    from repro.obs import telemetry as ref_tele
    g = torch.Generator().manual_seed(0)
    tele = tele_lib.stage_zero(4, 2, CPU)
    tele["chase"]["fill_max"] = torch.rand((4, 2), generator=g) * 3
    tele["chase"]["fill_mean_sum"] = torch.rand((4, 2), generator=g)
    tele["gather"]["hist"] = torch.randint(0, 9, (4, tele_lib.HIST_BINS),
                                           generator=g, dtype=torch.int32)
    tele["chase"]["rounds"] = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    tele["queue_hwm"] = torch.tensor([5, 1, 9, 2], dtype=torch.int32)
    copies = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies.append(tuple(self.shape))
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    host = tele_lib.to_host(tele)
    monkeypatch.undo()
    assert len(copies) == 1
    numpy_tree = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.numpy())
                  for k, v in tele.items()}

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()

    assert same(host, numpy_tree)
    assert tele_lib.aggregate(host) == ref_tele.aggregate(numpy_tree)


# --------------------------------------------------------------------------
# the host half against the reference
# --------------------------------------------------------------------------

def _zero_json(depth):
    return tele_lib.json_tele(tele_lib.aggregate(tele_lib.to_host(
        tele_lib.stage_zero(1, depth, CPU))))


def test_utilization_always_finite():
    zero = _zero_json(2)
    assert tele_lib.utilization(zero) == {"util_max": 0.0, "util_mean": 0.0}
    busy = dict(zero)
    busy["chase"] = dict(zero["chase"], fill_max=[0.5, 1.25],
                         fill_mean_sum=[0.4, 0.8], rounds=2)
    util = tele_lib.utilization(busy)
    assert util["util_max"] == 1.25
    assert util["util_mean"] == pytest.approx((0.4 + 0.8) / 4, rel=1e-15)


def test_stage_record_roundtrip_and_headroom():
    from repro.obs import telemetry as ref_tele
    tele = _zero_json(1)
    tele["gather"] = dict(tele["gather"], fill_max=[0.5],
                          dest_frac_max=[0.2], rounds=3)
    tele["queue_hwm"] = 6
    rec = tele_lib.StageRecord(label="descend@0", kind="descend", level=0,
                               caps={"gather": (16,)}, queue_cap=24,
                               tele=tele)
    back = tele_lib.StageRecord.from_json(as_json(rec.to_json()))
    assert (back.label, back.level, back.caps, back.queue_cap) == \
        ("descend@0", 0, {"gather": (16,)}, 24)
    rows = tele_lib.headroom_rows([rec], final_scales="chase=1,gather=2")
    by_fam = {r["family"]: r for r in rows}
    assert set(by_fam) == {"gather", "queue"}
    g = by_fam["gather"]
    assert (g["cap"], g["fill_max"], g["scale"]) == (16, 0.5, 2.0)
    assert g["headroom"] == 0.5
    assert (by_fam["queue"]["cap"], by_fam["queue"]["fill_max"]) == (24,
                                                                      6 / 24)
    table = tele_lib.format_headroom_table(rows)
    assert "worst fill 0.500 of cap 16" in table
    assert tele_lib.format_headroom_table([]).startswith("(no telemetry")
    ref_rec = ref_tele.StageRecord(**{f: getattr(rec, f) for f in (
        "label", "kind", "level", "caps", "queue_cap", "tele")})
    assert rec.to_json() == ref_rec.to_json()
    assert rows == ref_tele.headroom_rows([ref_rec], "chase=1,gather=2")
    assert table == ref_tele.format_headroom_table(rows)


def test_parse_scales():
    assert tele_lib.parse_scales("chase=1,sub=2,gather=1.5,graph=1") == \
        {"chase": 1.0, "sub": 2.0, "gather": 1.5, "graph": 1.0}
    assert tele_lib.parse_scales("chase=1,sub=1;chase=2,sub=1")["chase"] == 2.0
    assert tele_lib.parse_scales("") == {}


def test_dkw_backtest_synthetic():
    from repro.obs import telemetry as ref_tele
    tele = _zero_json(2)
    tele["chase"] = dict(tele["chase"], dest_frac_max=[0.1, 0.9], rounds=1)
    rec = tele_lib.StageRecord(label="s", kind="descend", level=0,
                               caps={"chase": (8, 8)}, queue_cap=0,
                               tele=tele)
    rows = tele_lib.dkw_backtest([0.15, 0.15], sample_size=1024,
                                 hop_sizes=[8, 8], records=[rec])
    assert [r["hop"] for r in rows] == [0, 1]
    assert rows[0]["bound"] == 0.15 + tele_lib.dkw_margin(1024, 8)
    assert rows[0]["ok"] and not rows[1]["ok"]
    assert rows[1]["observed_frac"] == 0.9
    assert rows == ref_tele.dkw_backtest([0.15, 0.15], 1024, [8, 8], [rec])


def test_skew_rows_against_uniform_model():
    from repro.obs import cost as ref_cost
    tele = _zero_json(1)
    tele["gather"] = dict(tele["gather"], dest_frac_max=[0.5], rounds=1)
    rec = tele_lib.StageRecord(label="s", kind="descend", level=0,
                               caps={"gather": (16,)}, queue_cap=0,
                               tele=tele)
    for recs in ([rec], [rec.to_json()]):
        rows = obs.skew_rows((8,), recs)
        assert len(rows) == 1
        assert rows[0]["modeled_frac"] == 1 / 8
        assert rows[0]["observed_frac"] == 0.5
        assert rows[0]["skew"] == 4.0
        assert rows == ref_cost.skew_rows((8,), recs)
    assert obs.format_skew_table(rows, title="t") == \
        ref_cost.format_skew_table(rows, title="t")


# --------------------------------------------------------------------------
# contract 1: telemetry changes nothing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_goldens_reproduced_with_tracer_and_telemetry_on(name):
    """All 7 goldens — hashes, attempts, escalation path and every
    counter — with the tracer and telemetry on; the stages' collectives
    are the telemetry-off solve's."""
    tr = obs.Tracer()
    sf, rf, stats = solve(name, tracer=tr, stage_counters=True)
    tele = stats.pop("telemetry")
    assert case_record(sf.numpy(), rf.numpy(), stats) == load_golden(name)
    _, _, plain = solve(name, telemetry=False, stage_counters=True)
    assert stats["stage_collectives"] == plain["stage_collectives"]
    assert [s["label"] for s in tele["stages"]] == [
        lbl for lbl in stats["stage_log"] if "!" not in lbl]
    for srec in tele["stages"]:
        assert np.isfinite(srec["util_max"]) and np.isfinite(
            srec["util_mean"])
    assert len(list(tr.find(cat="stage-attempt"))) == len(stats["stage_log"])


@pytest.mark.parametrize("flags", [
    dict(use_pallas=True, use_pallas_pack=True),
    dict(wire_packing=False),
    dict(use_pallas_pack=True, wire_packing=True, srs_rounds=2)])
def test_records_independent_of_the_kernels(flags):
    """The records come from the bucket sort, never from the packed
    buffer: with the kernels' wrappers (their plain versions on the CPU)
    or the per-leaf exchange they are the same, as are the outputs."""
    s, r = instances.gen_list(1024, gamma=1.0, seed=4)
    base = ListRankConfig(telemetry=True, srs_rounds=flags.get(
        "srs_rounds", 1))
    outs = []
    for cfg in (base, base.with_(**flags)):
        sf, rf, st = rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg,
                                          device=CPU, seed=3)
        outs.append((sf, rf, ints(st), as_json(st["telemetry"])))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2:] == outs[1][2:]


def test_checkpoint_with_telemetry_equals_checkpoint_without(tmp_path):
    """Telemetry never enters a checkpoint: a preempted solve's boundary
    checkpoint holds the same arrays, byte for byte, and the same
    manifest with telemetry on and off — but for the solve fingerprint,
    which hashes the config (``telemetry`` included) as the reference's
    does, so a checkpoint resumes only into the same configuration."""
    saved = {}
    for on in (False, True):
        d = tmp_path / f"t{int(on)}"
        sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=str(d)))
        with pytest.raises(Preempted):
            solve("list-g1-s1", telemetry=on, supervisor=sup,
                  inject=FaultSpec("preempt", stage="descend", level=0))
        step = sup.ckpt.latest_step()
        manifest = sup.ckpt.manifest(step)
        manifest.pop("time")
        manifest["meta"].pop("fingerprint")
        with np.load(d / f"step_{step:08d}" / "state.npz") as data:
            arrays = {k: (data[k].dtype.str, data[k].shape,
                          data[k].tobytes()) for k in data.files}
        saved[on] = (step, manifest, arrays)
    assert saved[True] == saved[False]
    assert saved[True][2]


def test_telemetry_adds_one_host_copy_per_stage_and_no_other_read(
        monkeypatch):
    """Host reads of tensors (``int``, ``bool``, ``item``, ``tolist``,
    ``cpu``, ``numpy``) during a solve: telemetry adds exactly one
    ``.cpu()`` per committed stage — the record's harvest, then viewed
    by ``.numpy()`` on the host — and nothing else (on the card each
    device read is a synchronisation)."""
    reads = {}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **kw):
            reads[name] = reads.get(name, 0) + 1
            return orig(self, *a, **kw)
        return wrapper

    s, r = instances.gen_list(1024, gamma=1.0, seed=4)
    counted = {}
    for on in (False, True):
        reads.clear()
        with pytest.MonkeyPatch.context() as mp:
            for name in ("__int__", "__bool__", "item", "tolist", "cpu",
                         "numpy"):
                mp.setattr(torch.Tensor, name, counting(name))
            _, _, st = rank_list_with_stats(
                s, r, sim_mesh(P), device=CPU,
                cfg=ListRankConfig(telemetry=on, srs_rounds=2))
        counted[on] = dict(reads)
    n_stages = len(st["stage_log"])
    added = {k: counted[True].get(k, 0) - counted[False].get(k, 0)
             for k in set(counted[True]) | set(counted[False])}
    # the harvest: one copy, viewed as numpy on the host
    assert {k: v for k, v in added.items() if v} == {"cpu": n_stages,
                                                      "numpy": n_stages}


# --------------------------------------------------------------------------
# contract 2: the records are the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", RECORD_CASES)
def test_stage_records_equal_the_reference(ref, name):
    """Every committed stage's StageRecord and the headroom report equal
    the reference's JSON exactly (its escalations included)."""
    want = ref[name]
    tr = obs.Tracer()
    sf, rf, stats = solve(name, tracer=tr)
    assert case_record(sf.numpy(), rf.numpy(), stats) == want["record"]
    assert as_json(stats["telemetry"]) == want["telemetry"]
    assert stats["stage_log"] == want["stage_log"]
    assert span_tree(tr)["spans"] == want["trace"]["spans"]


def test_faulted_supervised_span_tree_equals_the_reference(ref, tmp_path):
    """Span names, categories, nesting and fault instants of a golden
    solve with an injected sub overflow, a lost PE and a corrupted
    plane, supervised and traced with telemetry on: the reference's."""
    want = ref["faulted"]
    s, r, cfg = CASES["list-g1-s1"]
    tr = obs.Tracer()
    sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=str(tmp_path)))
    sf, rf, stats = rank_list_with_stats(
        s, r, sim_mesh(P), cfg=cfg.with_(telemetry=True), device=CPU,
        perm_fn=PERMS, tracer=tr, supervisor=sup,
        inject=faults_for(FaultSpec))
    assert span_tree(tr) == want["trace"]
    assert stats["stage_log"] == want["stage_log"]
    assert case_record(sf.numpy(), rf.numpy(), stats) == want["record"]
    assert as_json(stats["telemetry"]) == want["telemetry"]


def test_tree_records_equal_the_reference(ref):
    """``tree_stats``: the tour span's graph-family StageRecord and the
    batched solve's stage records equal the reference's."""
    want = ref["tree"]
    tr = obs.Tracer()
    got = treealg.tree_stats(TREE, sim_mesh(P), tracer=tr, device=CPU,
                             cfg=ListRankConfig(telemetry=True),
                             perm_fn=perm_fn_from_numpy(
                                 ReferencePerms(0, P, legacy=False)))
    for k in ("depth", "subtree_size", "preorder", "postorder"):
        np.testing.assert_array_equal(getattr(got, k), want[k])
    (tour,) = tr.find(name="build_tour")
    assert as_json(tour.args["telemetry"]) == want["tour"]
    assert as_json(got.stats["telemetry"]) == want["telemetry"]
    assert span_tree(tr)["spans"] == want["trace"]["spans"]


def test_cc_records_equal_the_reference(ref):
    """``connected_components``: the pipeline's graph-family record and
    headroom rows equal the reference's."""
    want = ref["cc"]
    tr = obs.Tracer()
    labels, stats = graphalg.connected_components(
        *GRAPH, sim_mesh(P), tracer=tr, device=CPU,
        cfg=ListRankConfig(telemetry=True))
    np.testing.assert_array_equal(labels, want["labels"])
    assert ints(stats) == want["stats"]
    assert as_json(stats["telemetry"]) == want["telemetry"]
    assert span_tree(tr)["spans"] == want["trace"]["spans"]


# --------------------------------------------------------------------------
# telemetry explains the run
# --------------------------------------------------------------------------

def _family_instances(n):
    yield "list_g0.0", instances.gen_list(n, gamma=0.0, seed=1)
    yield "list_g0.5", instances.gen_list(n, gamma=0.5, seed=1)
    yield "list_g1.0", instances.gen_list(n, gamma=1.0, seed=1)
    for fam, loc in (("euler_local", True), ("euler_random", False)):
        s, r, _ = instances.gen_euler_tour(n // 2 + 1, seed=1, locality=loc)
        yield fam, instances.pad_to_multiple(s, r, 8)[:2]


def test_all_families_report_finite_utilization():
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True,
                         telemetry=True)
    sched = [st.label for st in resume.schedule_for(cfg)]
    for fam, (succ, rank) in _family_instances(512):
        _, _, stats = rank_list_with_stats(succ, rank, sim_mesh(P),
                                           cfg=cfg, seed=1, device=CPU)
        tele = stats["telemetry"]
        assert [s["label"] for s in tele["stages"]] == sched, fam
        assert all(np.isfinite(s["util_max"]) and np.isfinite(s["util_mean"])
                   for s in tele["stages"]), fam
        worst = max((r["fill_max"] for r in tele["headroom"]), default=0.0)
        if stats["attempts"] == 1:
            assert worst <= 1.0, (fam, worst)


def test_escalation_explained_in_scales_terms():
    succ, rank = instances.gen_list(512, gamma=1.0, seed=6)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True,
                         sub_capacity_slack=0.05, telemetry=True)
    _, _, stats = rank_list_with_stats(succ, rank, sim_mesh(P), cfg=cfg,
                                       seed=0, device=CPU)
    assert stats["attempts"] > 1
    scales = tele_lib.parse_scales(stats["scales_log"])
    escalated = [fam for fam, s in scales.items() if s > 1.0]
    assert escalated
    rows = stats["telemetry"]["headroom"]
    for fam in escalated:
        fam_rows = [r for r in rows if r["family"] == fam]
        assert fam_rows and all(r["scale"] > 1.0 for r in fam_rows)


def test_tracer_gets_utilization_annotations():
    succ, rank = instances.gen_list(512, gamma=1.0, seed=1)
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True,
                         telemetry=True)
    tr = obs.Tracer(meta={"name": "tele-test"})
    rank_list_with_stats(succ, rank, sim_mesh(P), cfg=cfg, seed=1,
                         tracer=tr, device=CPU)
    annotated = [s for s in tr.spans if "util_max" in s.args]
    assert len(annotated) == len(resume.schedule_for(cfg))
    assert all(np.isfinite(s.args["util_max"]) for s in annotated)
    assert {name for name, _, _ in tr.counters} == {
        "telemetry/util_max", "telemetry/util_mean", "telemetry/queue_hwm"}
    cs = [e for e in obs.chrome_trace(tr)["traceEvents"] if e["ph"] == "C"]
    assert cs and all(e["cat"] == "telemetry" for e in cs)
    assert tr.metrics.get("telemetry/stage_util_max").count == len(annotated)
    assert tr.metrics.get("obs/stage_wall_s").count == len(annotated)


def test_metrics_ingest_telemetry_and_dkw():
    succ, rank = instances.gen_list(512, gamma=1.0, seed=1)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True,
                         telemetry=True, capacity_estimation=True)
    tr = obs.Tracer()
    _, _, stats = rank_list_with_stats(succ, rank, sim_mesh(P), cfg=cfg,
                                       seed=1, device=CPU, tracer=tr)
    dkw = stats["telemetry"]["dkw"]
    assert [r["hop"] for r in dkw] == [0]
    assert 0.0 <= dkw[0]["observed_frac"] <= 1.0
    (est,) = tr.find(name="estimate_capacities")
    assert est.args["sample_size"] > 0
    by_name = {m.name: m for m in tr.metrics}
    assert by_name["solve/telemetry/stages"].value == len(
        stats["telemetry"]["stages"])
    worst = by_name["solve/telemetry/worst_fill"].value
    assert np.isfinite(worst) and worst >= 0
    assert by_name["solve/telemetry/stage_util_max"].count > 0
    assert "solve/telemetry/dkw_violations" in by_name
    (row,) = cost_lib.skew_rows((P,), stats["telemetry"]["stages"])
    assert row["observed_frac"] == dkw[0]["observed_frac"]


def test_graph_family_telemetry_cc_mode():
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True,
                         telemetry=True)
    edges = instances.gen_graph_edges(120, 180, seed=37, num_components=3)
    labels, st = graphalg.connected_components(edges, 120, sim_mesh(P),
                                               cfg=cfg, device=CPU)
    np.testing.assert_array_equal(labels, union_find_labels(120, edges))
    (rec,) = st["telemetry"]["stages"]
    assert rec["label"] == "graphalg:cc"
    assert int(rec["tele"]["graph"]["rounds"]) > 0
    assert np.isfinite(rec["util_max"])
    assert any(r["family"] == "graph" for r in st["telemetry"]["headroom"])


def test_telemetry_off_has_no_stats_key():
    succ, rank = instances.gen_list(256, gamma=1.0, seed=1)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True)
    _, _, stats = rank_list_with_stats(succ, rank, sim_mesh(P), cfg=cfg,
                                       seed=1, device=CPU)
    assert "telemetry" not in stats
