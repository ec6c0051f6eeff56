"""The port's host layer equals the reference's: config defaults, the
§2.6 tuner, capacity derivation (``build_specs``), instance generators,
the sequential oracle and the chase-message wire descriptor. Plus import
hygiene: the port never loads jax or the JAX package."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core.listrank import analysis as ref_analysis
from repro.core.listrank import api as ref_api
from repro.core.listrank import config as ref_config
from repro.core.listrank import exchange as ref_exchange
from repro.core.listrank import instances as ref_instances
from repro.core.listrank import sequential as ref_sequential
from repro.core.listrank import transport as ref_transport
from repro.core.listrank import tuner as ref_tuner
from repro_torch.core.listrank import analysis, api, config, instances
from repro_torch.core.listrank import exchange, sequential, transport, tuner

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_config_fields_and_defaults_match():
    ref, ours = ref_config.ListRankConfig(), config.ListRankConfig()
    a, b = _fields(ref), _fields(ours)
    assert a.keys() == b.keys()
    a_m, b_m = a.pop("machine"), b.pop("machine")
    assert a == b
    assert dataclasses.astuple(a_m) == dataclasses.astuple(b_m)


def _both_cfgs(**kw):
    return ref_config.ListRankConfig(**kw), config.ListRankConfig(**kw)


GRID = [(n, p, rounds, frac, est)
        for n in (512, 4096, 1 << 16)
        for p in (1, 8, 16)
        for rounds in (1, 2)
        for frac in (1.0 / 32.0, None)
        for est in (False, True)]


@pytest.mark.parametrize("n,p,rounds,frac,est", GRID)
def test_build_specs_match(n, p, rounds, frac, est):
    ref_cfg, cfg = _both_cfgs(srs_rounds=rounds, ruler_fraction=frac,
                              capacity_estimation=est)
    axes = ("row", "col") if p == 16 else ("pe",)
    shape = (4, 4) if p == 16 else (p,)
    ref_ind = ref_config.IndirectionSpec.grid(axes) if p == 16 else None
    ind = config.IndirectionSpec.grid(axes) if p == 16 else None
    ref_plan = ref_exchange.MeshPlan.from_mesh(
        ref_transport.sim_mesh(shape, axes), axes, ref_ind)
    plan = exchange.MeshPlan.from_mesh(transport.sim_mesh(shape, axes), axes,
                                       ind)
    succ, _ = ref_instances.gen_list(n, gamma=1.0, seed=n + p)
    m = n // p
    tb = 3
    ref_est = est_ = None
    if est:
        ref_est = ref_tuner.estimate_capacities(succ, ref_plan, m, ref_cfg,
                                                seed=4)
        est_ = tuner.estimate_capacities(succ, plan, m, cfg, seed=4)
        assert dataclasses.astuple(ref_est) == dataclasses.astuple(est_)
    for scales in ((1, 1, 1, 1), (2, 1, 4, 1)):
        ref_sc = ref_tuner.CapacityScales(*scales)
        sc = tuner.CapacityScales(*scales)
        a = ref_api.build_specs(ref_cfg, ref_plan, m, n, tb, ref_sc, ref_est)
        b = api.build_specs(cfg, plan, m, n, tb, sc, est_)
        assert [dataclasses.astuple(s) for s in a] == \
            [dataclasses.astuple(s) for s in b]


@pytest.mark.parametrize("n,p", [(1 << 12, 8), (1 << 20, 16), (1 << 24, 64)])
def test_tuner_decisions_match(n, p):
    for frac in (1.0 / 32.0, None):
        ref_cfg, cfg = _both_cfgs(ruler_fraction=frac, srs_rounds=2)
        for d in (1, 2):
            assert [dataclasses.astuple(x) for x in
                    ref_tuner.level_plan(ref_cfg, p, d, n)] == \
                [dataclasses.astuple(x) for x in tuner.level_plan(cfg, p, d, n)]
    ref_cfg, cfg = _both_cfgs(algorithm="auto")
    for m in (16, 1 << 10, 1 << 20):
        assert ref_tuner.choose_algorithm(ref_cfg, p, 1, m) == \
            tuner.choose_algorithm(cfg, p, 1, m)
    axes, sizes = ("row", "col"), (p // 4, 4)
    assert ref_tuner.choose_indirection(ref_cfg, axes, sizes, n).hops == \
        tuner.choose_indirection(cfg, axes, sizes, n).hops
    assert ref_analysis.r_star(n, p, 2, ref_analysis.SUPERMUC) == \
        analysis.r_star(n, p, 2, analysis.SUPERMUC)


def test_escalation_matches():
    stats_seq = [{"dropped": 1}, {"undelivered": 2}, {"undelivered": 1},
                 {"store_miss": 1}, {}, {"sub_overflow": 3, "dropped": 1}]
    r = (ref_tuner.CapacityScales(),) * 3
    o = (tuner.CapacityScales(),) * 3
    for i, st in enumerate(stats_seq):
        level = i % 3
        r = ref_tuner.escalate_levels(r, level, st)
        o = tuner.escalate_levels(o, level, st)
        assert [ref_tuner.format_scales(s) for s in r] == \
            [tuner.format_scales(s) for s in o]
        assert ref_tuner.format_scales(ref_tuner.escalate(r[0], st)) == \
            tuner.format_scales(tuner.escalate(o[0], st))


@pytest.mark.parametrize("seed", [0, 3])
def test_instances_byte_identical(seed):
    pairs = [
        (ref_instances.gen_list(777, 0.4, seed, num_lists=3),
         instances.gen_list(777, 0.4, seed, num_lists=3)),
        (ref_instances.gen_random_lists(500, 7, seed, weighted=True),
         instances.gen_random_lists(500, 7, seed, weighted=True)),
        (ref_instances.gen_euler_tour(100, seed, locality=True,
                                      weighted=True, num_trees=3),
         instances.gen_euler_tour(100, seed, locality=True, weighted=True,
                                  num_trees=3)),
        (ref_instances.gen_tree_parents(90, seed),
         instances.gen_tree_parents(90, seed)),
        (ref_instances.gen_graph_edges(60, 150, seed),
         instances.gen_graph_edges(60, 150, seed)),
    ]
    for a, b in pairs:
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    s, r = instances.gen_list(100, 1.0, seed)
    a = ref_sequential.rank_list_seq(s, r)
    b = sequential.rank_list_seq(s, r)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    assert ref_instances.locality_fraction(s, 4) == \
        instances.locality_fraction(s, 4)


def test_chase_wire_words_and_weight_dtypes_match():
    for dt in (np.int32, np.int64, np.float32, np.float64, np.int16):
        assert ref_api.canonical_weight_dtype(dt).name == \
            str(api.canonical_weight_dtype(dt)).removeprefix("torch.")
        assert ref_api.chase_wire_words(ref_api.canonical_weight_dtype(dt)) \
            == api.chase_wire_words(api.canonical_weight_dtype(dt)) == 5
    with pytest.raises(TypeError):
        api.canonical_weight_dtype(np.bool_)


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax and the JAX package out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.'))\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_and_port_sources_import_no_jax():
    files = [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
        (ROOT / "tools").glob("*.py"))
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
