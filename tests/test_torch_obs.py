"""The port's flight recorder (``repro_torch.obs``) on the CPU, against
the JAX package's (``tests/test_obs.py``'s suite, and the reference's
own outputs where they can be compared):

- the span tree of a traced solve: every scheduled stage once, attempts
  nested under their stage, retries under the same stage span, the
  checkpoint spans of a supervised solve (the span tree of a faulted,
  supervised golden solve is held to the reference's in
  ``tests/test_torch_telemetry.py``, whose reference child processes run
  the same programs);
- no perturbation: with a tracer the goldens are reproduced and the
  per-stage collective counts are unchanged; with tracing off no Span is
  allocated;
- the run-time collective footprint (``CountingTransport.footprint``)
  counts what ``stage_collectives`` counts, and each attempt span's
  ``collective_count`` is its stage's total;
- the pure host halves equal the reference's on the same inputs:
  ``predict_footprint``, ``chrome_trace``, ``ingest_host_stats``,
  ``residual_rows``.

Every comparison is exact (``==``) unless a line says otherwise.
"""
import json

import numpy as np
import pytest
import torch

from _simshard_cases import SHAPE, case_record, golden_cases, load_golden
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import obs
from repro_torch.core import graphalg, treealg
from repro_torch.core.listrank import (FaultSpec, ListRankConfig,
                                       SolveExhausted, api, default_perm_fn,
                                       perm_fn_from_numpy, instances,
                                       rank_list_seq, rank_list_with_stats,
                                       resume, sim_mesh, tuner)
from repro_torch.core.listrank import transport as transport_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.runtime.fault_tolerance import (SolveSupervisor,
                                                 SolveSupervisorConfig)

P = SHAPE[0]
CPU = "cpu"
PERMS = perm_fn_from_numpy(ReferencePerms(0, P))
CASES = {name: (s, r, ListRankConfig(**{k: getattr(cfg, k) for k in (
    "srs_rounds", "local_contraction", "sub_capacity_slack")}))
    for name, s, r, cfg in golden_cases()}
def solve(name, **kw):
    s, r, cfg = CASES[name]
    return rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, device=CPU,
                                perm_fn=PERMS, **kw)


def small_case():
    s, r = instances.gen_list(256, gamma=1.0, seed=7)
    return s, r, ListRankConfig(srs_rounds=2, local_contraction=False)


def ints(stats):
    return {k: v for k, v in stats.items() if isinstance(v, int)}


# --------------------------------------------------------------------------
# span-tree well-formedness
# --------------------------------------------------------------------------

def test_clean_solve_covers_every_scheduled_stage_exactly_once():
    s, r, cfg = small_case()
    tr = obs.Tracer()
    sf, rf, _ = rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, seed=1,
                                     tracer=tr, device=CPU)
    s_ref, r_ref = rank_list_seq(s, r)
    np.testing.assert_array_equal(sf.numpy(), s_ref)
    np.testing.assert_array_equal(rf.numpy(), r_ref)

    labels = [st.label for st in resume.schedule_for(cfg)]
    assert labels == ["prep", "descend@0", "descend@1", "base@2",
                      "ascend@1", "ascend@0", "post"]
    stage_spans = list(tr.find(cat="stage"))
    assert [sp.name for sp in stage_spans] == labels
    (solve_span,) = tr.find(cat="solve")
    assert solve_span.parent == -1 and solve_span.args["outcome"] == "ok"
    assert solve_span.args["backend"] == "simshard"
    for sp in stage_spans:
        assert sp.parent == solve_span.index
        kids = tr.children(sp)
        assert [k.cat for k in kids] == ["stage-attempt"]
        assert kids[0].name == f"{sp.name}#1"
        assert kids[0].args["outcome"] == "committed"
        assert kids[0].args["wall_s"] >= 0
    for sp in tr.spans:
        assert sp.t1 is not None and sp.t1 >= sp.t0
        if sp.parent >= 0:
            par = tr.spans[sp.parent]
            assert par.t0 <= sp.t0 and sp.t1 <= par.t1 + 1e-9


def test_attempts_annotated_with_prediction_and_footprint():
    s, r, cfg = small_case()
    tr = obs.Tracer()
    _, _, stats = rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, seed=1,
                                       tracer=tr, device=CPU,
                                       stage_counters=True)
    counts = dict(stats["stage_collectives"])
    for att in tr.find(cat="stage-attempt"):
        assert np.isfinite(att.args["predicted_s"])
        assert att.args["predicted_s"] >= 0
        assert att.args["predicted_s"] == pytest.approx(
            att.args["predicted_startup_s"]
            + att.args["predicted_volume_s"], rel=1e-12)
        # the attempt's run-time count is its stage's stage_collectives
        assert att.args["collective_count"] == sum(
            c for _, c in counts[att.args["stage"]])
        assert att.args["payload_bytes"] == sum(
            v["bytes"] for v in att.args["footprint"].values())
    (solve_span,) = tr.find(cat="solve")
    assert solve_span.args["predicted_solve_s"] > 0
    rows = obs.residual_rows(tr)
    assert {row["stage"] for row in rows} == set(counts)
    assert all(np.isfinite(row["measured_s"]) for row in rows)
    table = obs.format_residual_table(rows)
    for row in rows:
        assert row["stage"] in table


def test_overflow_retry_nests_under_its_stage_span():
    tr = obs.Tracer()
    _, _, stats = solve("list-g1-s1", tracer=tr, inject=FaultSpec(
        "overflow", stage="descend", level=0, family="chase"))
    assert stats["attempts"] == 2
    (d0,) = tr.find(cat="stage", name="descend@0")
    kids = tr.children(d0)
    assert [k.name for k in kids] == ["descend@0#1", "descend@0#2"]
    assert kids[0].args["outcome"] == "overflow"
    assert kids[0].args["fatal"]["dropped"] > 0
    assert kids[1].args["outcome"] == "committed"
    assert kids[1].args["scales"].startswith("chase=2")
    for lbl in ("prep", "base@1", "ascend@0", "post"):
        (sp,) = tr.find(cat="stage", name=lbl)
        assert len(tr.children(sp)) == 1
    names = [i.name for i in tr.instants]
    assert "overflow:chase:descend@0" in names
    assert "escalate:descend@0" in names


def test_checkpoint_spans_appear_under_supervised_solve(tmp_path):
    tr = obs.Tracer()
    sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=str(tmp_path)))
    solve("list-g1-s1", supervisor=sup, tracer=tr)
    saves = list(tr.find(cat="checkpoint"))
    assert saves and all(sp.name.startswith("ckpt-save@") for sp in saves)
    assert saves[0].parent >= 0
    assert sup.tracer is tr


# --------------------------------------------------------------------------
# no perturbation: tracer on == tracer off
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("list-g1-s1", "escalate-s6"))
def test_golden_bytes_identical_with_tracing_on(name):
    tr = obs.Tracer()
    sf, rf, stats = solve(name, tracer=tr)
    assert case_record(sf.numpy(), rf.numpy(), stats) == load_golden(name)
    assert len(tr.spans) > 0


@pytest.mark.parametrize("p", (8, 256))
def test_stage_collective_counts_identical_tracer_on_off(p):
    s, r = instances.gen_list(8 * p, gamma=1.0, seed=9)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True)
    out = {}
    for tag, tr in (("off", None), ("on", obs.Tracer())):
        sf, rf, stats = rank_list_with_stats(
            s, r, sim_mesh(p), cfg=cfg, seed=1, stage_counters=True,
            tracer=tr, term_bound=1, device=CPU)
        out[tag] = (sf.numpy().tobytes(), rf.numpy().tobytes(),
                    stats["stage_collectives"], ints(stats))
    assert out["on"] == out["off"]
    assert any(dict(c).get("all_to_all", 0) > 0 for _, c in out["on"][2])


@pytest.mark.parametrize("p", (8, 256))
def test_composed_solve_counts_unaffected_by_active_tracer(p):
    """The composed one-attempt solve (the graph pipeline's) inside open
    tracer spans makes the same transport calls as with no tracer in
    scope — the port's run-time counterpart of the reference's jaxpr
    count of its mesh program."""
    n = 4 * p
    m = n // p
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True,
                         algorithm="srs")
    s, r = instances.gen_list(n, gamma=1.0, seed=3)

    def counts():
        plan = api.make_plan(sim_mesh(p), ("pe",), cfg, torch.device(CPU))
        specs = api.build_specs(cfg, plan, m, n, term_bound=m)
        api._solve_sharded(torch.from_numpy(s).reshape(p, m),
                           torch.from_numpy(r).reshape(p, m),
                           default_perm_fn(0), plan=plan, cfg=cfg,
                           specs=specs, m=m)
        return plan.transport.footprint()

    baseline = counts()
    tr = obs.Tracer()
    with tr.span("solve", cat="solve"):
        with tr.span("descend@0", cat="stage"):
            traced = counts()
    assert traced == baseline
    assert baseline["all_to_all"][0] > 0


def test_disabled_tracer_allocates_no_spans(monkeypatch):
    """With tracing off every instrumentation site goes through
    NULL_TRACER: no Span is constructed in the solve, graphalg or
    treealg paths, and NULL_TRACER hands out one shared span."""
    def boom(*a, **kw):
        raise AssertionError("Span allocated with tracing disabled")

    monkeypatch.setattr(trace_lib, "Span", boom)
    s, r, cfg = small_case()
    _, rf, _ = rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, seed=1,
                                    device=CPU)
    np.testing.assert_array_equal(rf.numpy(), rank_list_seq(s, r)[1])
    edges = instances.gen_graph_edges(24, 30, seed=3)
    graphalg.connected_components(edges, 24, sim_mesh(P), cfg=cfg,
                                  device=CPU)
    treealg.build_tour(instances.gen_tree_parents(16, 1), sim_mesh(P),
                       device=CPU)
    nt = trace_lib.NULL_TRACER
    assert nt.span("a") is nt.begin("b") is trace_lib.NULL_SPAN
    assert not nt.enabled and nt.spans == ()


# --------------------------------------------------------------------------
# front doors: graphalg / treealg spans
# --------------------------------------------------------------------------

def test_graphalg_frontdoor_traced():
    edges = instances.gen_graph_edges(48, 80, seed=3)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=False)
    tr = obs.Tracer()
    _, stats = graphalg.connected_components(edges, 48, sim_mesh(P),
                                             cfg=cfg, tracer=tr, device=CPU)
    (pipe,) = tr.find(cat="solve", name="graphalg:cc")
    assert pipe.args["outcome"] == "ok" and pipe.args["backend"] == "simshard"
    kids = tr.children(pipe)
    assert kids and kids[-1].args["outcome"] == "committed"
    assert kids[-1].args["predicted_s"] >= 0
    # the attempt's run-time footprint covers every unit it ran
    assert kids[-1].args["collective_count"] == sum(
        sum(c.values()) for _, c in stats["stage_collectives"])
    assert tr.metrics.get("graphalg/cc/cc_rounds").value > 0


def test_treealg_build_tour_traced():
    parent = np.array([0, 0, 0, 1, 1, 2, 5, 6], np.int32)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=False)
    tr = obs.Tracer()
    treealg.build_tour(parent, sim_mesh(P), cfg=cfg, tracer=tr, device=CPU)
    (tour,) = tr.find(cat="solve", name="build_tour")
    assert tour.args["outcome"] == "ok"
    assert tr.children(tour)[-1].args["outcome"] == "committed"


# --------------------------------------------------------------------------
# the run-time footprint
# --------------------------------------------------------------------------

def test_runtime_footprint_counts_equal_stage_collectives():
    """Each stage's run-time footprint (``footprint()``, annotated on its
    attempt span) counts its ``stage_collectives``; the bytes are each
    call's payload per PE."""
    for cfg in (ListRankConfig(srs_rounds=2, local_contraction=True),
                ListRankConfig(algorithm="doubling", wire_packing=False)):
        s, r = instances.gen_list(512, gamma=1.0, seed=7)
        tr = obs.Tracer()
        _, _, stats = rank_list_with_stats(
            s, r, sim_mesh(P), cfg=cfg, seed=1, device=CPU, tracer=tr,
            stage_counters=True)
        atts = list(tr.find(cat="stage-attempt"))
        assert [a.args["stage"] for a in atts] == [
            label for label, _ in stats["stage_collectives"]]
        for att, (_, coll) in zip(atts, stats["stage_collectives"]):
            assert {k: v["count"] for k, v in
                    att.args["footprint"].items()} == dict(coll)

    t = transport_lib.CountingTransport(transport_lib.VirtualTransport(
        ("pe",), (4,), torch.device(CPU)))
    t.all_to_all(torch.zeros((4, 3, 4, 5), dtype=torch.int32), ("pe",), 1)
    t.psum(torch.zeros(4, dtype=torch.int32))
    t.all_gather(torch.zeros((4, 6), dtype=torch.float32))
    assert t.footprint() == {"all_gather": (1, 24), "all_to_all": (1, 240),
                             "psum": (1, 4)}
    t.clear()
    assert t.footprint() == {} and not t.counts


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

def test_metrics_registry_schema():
    reg = obs.MetricsRegistry()
    c = reg.counter("msgs", help="messages")
    c.inc().inc(3)
    assert reg.counter("msgs").value == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("msgs")
    reg.gauge("depth").set(7)
    h = reg.histogram("wall")
    h.observe(1.0)
    h.observe(3.0)
    assert h.count == 2 and h.mean == 2.0 and h.min == 1.0 and h.max == 3.0
    reg.text("log").set("a;b")
    snap = reg.to_dict()
    assert snap["msgs"]["value"] == 4 and snap["wall"]["count"] == 2
    assert {m.kind for m in reg} == {"counter", "gauge", "histogram", "text"}
    json.dumps(snap)


def test_ingest_host_stats_equals_the_reference():
    """Ingesting the port's host_stats of a golden solve gives the
    reference registry's snapshot for the same stats — kinds, values
    and the help strings of srs.STAT_HELP / TELEMETRY_HELP."""
    from repro import obs as ref_obs
    _, _, stats = solve("list-g1-s1", stage_counters=True)
    s, r, cfg = CASES["list-g1-s1"]
    _, _, tstats = rank_list_with_stats(
        s, r, sim_mesh(P), cfg=cfg.with_(telemetry=True,
                                         capacity_estimation=True),
        device=CPU, perm_fn=PERMS)
    for st in (stats, tstats):
        got = obs.ingest_host_stats(obs.MetricsRegistry(), st).to_dict()
        want = ref_obs.ingest_host_stats(ref_obs.MetricsRegistry(),
                                         st).to_dict()
        assert got == want
        json.dumps(got)
    reg = obs.ingest_host_stats(obs.MetricsRegistry(), stats)
    assert reg.get("solve/rounds").kind == "counter"
    assert reg.get("solve/rounds").help
    assert reg.get("solve/max_queue").kind == "gauge"
    assert reg.get("solve/scales_log").kind == "text"
    assert reg.get("solve/stages_run").value == len(
        resume.schedule_for(cfg.with_(algorithm="srs")))


def test_json_safe_stats_handles_solver_stats_and_tensors():
    _, _, stats = solve("list-g1-s1")
    out = obs.json_safe_stats(stats)
    json.dumps(out)
    assert out["stage_log"] == list(stats["stage_log"])
    assert obs.json_safe(torch.float32) == "float32"
    assert obs.json_safe(torch.tensor([1, 2], dtype=torch.int32)) == [1, 2]
    assert obs.json_safe(torch.tensor(0.5)) == 0.5
    assert obs.json_safe(torch.tensor([3])) == 3  # as np.array([3]) is
    assert obs.json_safe({"t": (torch.tensor([True]), np.int32(4))}) == {
        "t": [True, 4]}


# --------------------------------------------------------------------------
# exporter
# --------------------------------------------------------------------------

def test_chrome_trace_roundtrip(tmp_path):
    tr = obs.Tracer(meta={"name": "roundtrip"})
    solve("list-g1-s1", tracer=tr, inject=FaultSpec(
        "overflow", stage="descend", level=0, family="chase"))
    path = tmp_path / "trace.json"
    obs.write_chrome_trace(tr, str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == len(tr.spans)
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    instants = [e for e in evs if e["ph"] == "i"]
    assert any(e["name"] == "overflow:chase:descend@0" for e in instants)
    assert all(e["s"] == "t" for e in instants)


def test_exporters_equal_the_reference_on_one_tracer():
    """``chrome_trace``, ``residual_rows`` and ``residual_summary`` of
    one recorded tracer (a traced golden solve with a retry and counter
    samples) are the reference exporters' output on the same tracer."""
    from repro import obs as ref_obs
    tr = obs.Tracer(meta={"name": "same"})
    solve("list-g1-s1", tracer=tr, inject=FaultSpec(
        "overflow", stage="descend", level=0, family="chase"))
    tr.counter("telemetry/util_max", 0.5)
    assert obs.chrome_trace(tr) == ref_obs.chrome_trace(tr)
    assert obs.residual_rows(tr) == ref_obs.residual_rows(tr)
    rows = obs.residual_rows(tr)
    assert obs.residual_summary(rows) == ref_obs.residual_summary(rows)
    assert obs.format_residual_table(rows) == \
        ref_obs.format_residual_table(rows)
    assert obs.span_tree_lines(tr) == ref_obs.span_tree_lines(tr)


def test_chrome_trace_null_tracer_and_empty_tree(tmp_path):
    for tracer in (trace_lib.NULL_TRACER, obs.Tracer()):
        back = json.loads(json.dumps(obs.chrome_trace(tracer)))
        assert isinstance(back["traceEvents"], list)
        assert back["traceEvents"][0]["ph"] == "M"
        assert back["displayTimeUnit"] == "ms"
        assert not [e for e in back["traceEvents"] if e["ph"] == "C"]
    tr = obs.Tracer(meta={"name": "edge"})
    with tr.span("solo", cat="stage"):
        pass
    path = tmp_path / "edge.json"
    obs.write_chrome_trace(tr, str(path))
    phs = [e["ph"] for e in json.loads(path.read_text())["traceEvents"]]
    assert "X" in phs and "C" not in phs


def test_counter_tracks_interleave_with_fault_instants():
    tr = obs.Tracer()
    with tr.span("solve", cat="solve"):
        tr.instant("fault:injected", cat="fault")
        tr.counter("telemetry/util_max", 0.25)
        tr.instant("fault:recovered", cat="fault")
        tr.counter("telemetry/util_max", 0.75)
        tr.counter("telemetry/queue_hwm", 12.0)
    evs = obs.chrome_trace(tr)["traceEvents"]
    cs = [e for e in evs if e["ph"] == "C"]
    instants = [e for e in evs if e["ph"] == "i"]
    assert len(cs) == 3 and len(instants) == 2
    assert [e["ts"] for e in cs] == sorted(e["ts"] for e in cs)
    assert {e["name"] for e in cs} == {"telemetry/util_max",
                                       "telemetry/queue_hwm"}
    (solve_ev,) = [e for e in evs if e["ph"] == "X"]
    for e in cs + instants:
        assert solve_ev["ts"] <= e["ts"] <= solve_ev["ts"] + solve_ev["dur"]


def test_null_tracer_counter_is_noop():
    trace_lib.NULL_TRACER.counter("telemetry/util_max", 1.0)
    assert trace_lib.NULL_TRACER.counters == ()


# --------------------------------------------------------------------------
# the §2.6 cost model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hops", [(8,), (2, 4), (4, 4, 2)])
def test_predict_footprint_equals_the_reference(hops):
    from repro.core.listrank import analysis as ref_analysis
    from repro.obs import cost as ref_cost
    from repro_torch.core.listrank import analysis
    from repro_torch.obs import cost
    fp = {"all_to_all": (37, 123456), "psum": (11, 44),
          "all_gather": (1, 4096)}
    p = int(np.prod(hops))
    for scale in (1.0, 1.0 / p):
        got = cost.predict_footprint(fp, p, hops, analysis.SUPERMUC, scale)
        want = ref_cost.predict_footprint(fp, p, hops, ref_analysis.SUPERMUC,
                                          scale)
        assert got == want
    assert cost.footprint_summary(fp) == ref_cost.footprint_summary(fp)
    assert cost.total_collectives(fp) == ref_cost.total_collectives(fp)


def test_predict_solve_equals_the_reference():
    from repro.core.listrank import analysis as ref_analysis
    from repro.obs import cost as ref_cost
    from repro_torch.obs import cost

    class Plan:  # the two attributes predict_solve reads of a MeshPlan
        p = 64

        class indirection:
            hops = (("a",), ("b",))

        @staticmethod
        def hop_size(hop):
            return 8

    for r_total in (None, 4096):
        got = cost.predict_solve(1 << 20, Plan, cost_machine(), r_total)
        want = ref_cost.predict_solve(1 << 20, Plan,
                                      ref_analysis.SUPERMUC, r_total)
        assert got == want and got > 0


def cost_machine():
    from repro_torch.core.listrank import analysis
    return analysis.SUPERMUC


def test_residual_summary_totals():
    s, r, cfg = small_case()
    tr = obs.Tracer()
    rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, seed=1, tracer=tr,
                         device=CPU)
    rows = obs.residual_rows(tr)
    summ = obs.residual_summary(rows)
    assert summ["stages"] == len(rows)
    assert summ["measured_s"] == pytest.approx(
        sum(row["measured_s"] for row in rows), rel=1e-12)
    assert summ["predicted_s"] == pytest.approx(
        sum(row["predicted_s"] for row in rows), rel=1e-12)


def test_exhaustion_error_renders_escalation_path():
    tr = obs.Tracer()
    with pytest.raises(SolveExhausted) as ei:
        solve("escalate-s6", max_retries=1, tracer=tr)
    msg = str(ei.value)
    assert "did not complete after 2 attempts" in msg
    assert f"attempt 1: {ei.value.scales_log[0]}" in msg
    assert ei.value.scales_log[0] == tuner.format_scales(
        tuner.CapacityScales())
    for key, count in ei.value.fatal.items():
        if count:
            assert f"{key}={count}" in msg
    # the failing stage span closes as exhausted, the solve span with
    # the exception's name
    assert any(sp.args.get("outcome") == "exhausted"
               for sp in tr.find(cat="stage"))
    (solve_span,) = tr.find(cat="solve")
    assert solve_span.args["outcome"] == "SolveExhausted"
