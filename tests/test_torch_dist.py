"""The port's ``torch.distributed`` transport (``DistMesh``,
``DistTransport``) on the CPU with gloo, against the reference's mesh
records and the virtual-PE transport.

Rank processes come from ``tests/_torch_dist_rank.py`` (one pool of
spawned ranks per world size for the whole file, rendezvous through a
file in a temporary directory, a timeout on every job). The ranks import
neither jax nor the JAX package: this process draws the reference's
legacy-PRNG ruler permutations (``ReferencePerms``) and hands them over
as numpy arrays.

- the 7 committed golden records (the reference's 8-PE mesh runs:
  output hashes, attempts, escalation path, every counter) reproduce at
  world 2 (4 PEs a rank), three of them at world 4 (2 PEs a rank) and
  ``list-g1-s1`` at world 8, one PE a rank as on the reference's mesh;
- each collective equals the virtual transport's on the same whole
  input: hops within a rank and across ranks, unequal and empty split
  sizes, on 8 flat PEs and a (2, 4) grid (both hops in turn), bool,
  float and trailing-dim payloads, int32 ``psum`` that wraps, and
  ``psum_axes`` over each hop's axes (in a rank, across ranks, over a
  subgroup of them);
- the expert-parallel MoE layer under a ``DistMesh`` (2, 1) context
  equals the virtual transport's (2, 1) run bit for bit, with the same
  collectives, and every rank's gradients equal the virtual run's;
- per stage the collectives and their bytes per PE, the telemetry
  records and the headroom report equal the virtual transport's;
- a two-hop grid solve, ``tree_stats`` and ``graph_stats`` equal the
  virtual transport's outputs and counters, and so do ``root_tree``,
  ``solve_forest`` and ``spanning_forest``; the graph span reads
  ``backend="mesh"``;
- ``resolve_backend``'s cases, the meshes of ``launch/mesh.py``, and a
  supervised and an injected solve on a DistMesh.

Every comparison is exact.
"""
import numpy as np
import pytest

import _simshard_cases as cases_lib
from _torch_dist_rank import RankPool
from _torch_reference_perms import ReferencePerms
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core import graphalg, treealg
from repro_torch.core.listrank import (DistMesh, IndirectionSpec,
                                       ListRankConfig, instances,
                                       perm_fn_from_numpy,
                                       rank_list_with_stats, sim_mesh)
from repro_torch.core.listrank import transport as tl

CPU = "cpu"
P = cases_lib.SHAPE[0]
CASES = {name: (s, r, ListRankConfig(**{k: getattr(cfg, k) for k in (
    "srs_rounds", "local_contraction", "sub_capacity_slack")}))
    for name, s, r, cfg in cases_lib.golden_cases()}
GOLDEN_AT = [(2, name) for name in CASES] + [
    (4, "list-g1-s1"), (4, "euler-forest-s4"), (4, "escalate-s6"),
    (8, "list-g1-s1")]
#: per-job timeouts (seconds): a hang fails the test, not the run
SOLVE_S, SPAWN_S = 60, 120


@pytest.fixture(scope="module")
def pools():
    """One pool of gloo ranks per world size, spawned on first use and
    again after a job that failed or timed out closed it."""
    made: dict[int, RankPool] = {}

    def get(world: int) -> RankPool:
        if world not in made or made[world].closed:
            made[world] = RankPool(world, start_timeout=SPAWN_S)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


def virtual_solve(s, r, cfg, table, **kw):
    """The virtual-PE solve of the same case, filling ``table`` with the
    reference's permutations it draws."""
    so, ro, st = rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg,
                                      device=CPU,
                                      perm_fn=perm_fn_from_numpy(table), **kw)
    return so.numpy(), ro.numpy(), st


def dist_solve(pool, s, r, cfg, table, shape=(P,), axes=("pe",), **kw):
    return pool.run("solve", s, r, shape, axes, cfg, dict(table), kw,
                    timeout=SOLVE_S)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_ranks_import_neither_jax_nor_the_jax_package(pools, world):
    for got in pools(world).run("ready", timeout=SOLVE_S):
        assert got == {"jax": False, "repro": False}


@pytest.mark.parametrize("world,name", GOLDEN_AT,
                         ids=[f"w{w}-{n}" for w, n in GOLDEN_AT])
def test_golden_records_reproduced_across_ranks(pools, world, name):
    s, r, cfg = CASES[name]
    table = ReferencePerms(0, P)
    virtual_solve(s, r, cfg, table)  # draws the permutations it needs
    golden = cases_lib.load_golden(name)
    for rank, out in enumerate(dist_solve(pools(world), s, r, cfg, table)):
        rec = cases_lib.case_record(out["succ"], out["rank"], out["stats"])
        assert rec == golden, (rank, {k: (rec[k], golden[k]) for k in rec
                                      if rec[k] != golden[k]})


def _cases(p, hops, rng):
    """(op, args, whole (p, ...) input) per collective check."""
    out = []
    for hop, s in hops:
        # packed wire layout (p, W, s, cap), mailbox axis 1
        out.append(("all_to_all", (hop, 1),
                    rng.integers(-2**31, 2**31, (p, 3, s, 5), dtype=np.int32)))
        # unpacked leaves (p, s, cap, *trail), mailbox axis 0
        out.append(("all_to_all", (hop, 0),
                    rng.standard_normal((p, s, 4, 2)).astype(np.float32)))
        out.append(("all_to_all", (hop, 0), rng.random((p, s, 3)) < 0.5))
        # a sum over the hop's axes only: within a rank, across ranks, and
        # over a subgroup of the ranks
        out.append(("psum_axes", (hop,),
                    rng.standard_normal((p, 3, 2)).astype(np.float32)))
        out.append(("psum_axes", (hop,),
                    rng.integers(-2**31, 2**31, (p, 2), dtype=np.int32)))
    big = np.full((p, 3), 2**31 - 7, np.int32)   # the sum wraps
    big[:, 1] = rng.integers(-2**31, 2**31, p, dtype=np.int32)
    out += [("psum", (), big),
            ("psum", (), rng.standard_normal((p, 2)).astype(np.float32)),
            ("all_gather", (), rng.integers(0, 99, (p, 3, 2),
                                            dtype=np.int32)),
            ("all_gather", (), rng.random((p, 4)) < 0.5),
            ("gather_pes", (), rng.integers(0, 99, (p, 6), dtype=np.int32))]
    return out


MESHES = {"flat": ((8,), ("pe",), [(("pe",), 8)]),
          "grid": ((2, 4), ("row", "col"),
                   [(("col",), 4), (("row",), 2), (("row", "col"), 8)])}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_collectives_equal_the_virtual_transport(pools, world, mesh):
    import torch
    shape, axes, hops = MESHES[mesh]
    p = int(np.prod(shape))
    cases = _cases(p, hops, np.random.default_rng(world * 10 + len(shape)))
    virt = tl.CountingTransport(tl.VirtualTransport(axes, shape,
                                                    torch.device(CPU)))
    want = []
    for op, args, x in cases:
        xt = torch.from_numpy(x)
        y = getattr(virt, op)(xt, *args)
        want.append(y.numpy())
    k = p // world
    outs = pools(world).run("collectives", shape, axes, cases,
                            timeout=SOLVE_S)
    for rank, got in enumerate(outs):
        np.testing.assert_array_equal(got["ids"],
                                      np.arange(rank * k, (rank + 1) * k))
        for (op, args, _), w, g in zip(cases, want, got["outs"]):
            if op == "gather_pes":  # every PE's rows on every rank
                np.testing.assert_array_equal(g, w)
                continue
            np.testing.assert_array_equal(
                g.view(np.uint8) if g.dtype == np.bool_ else g,
                (w[rank * k:(rank + 1) * k].view(np.uint8)
                 if w.dtype == np.bool_ else w[rank * k:(rank + 1) * k]),
                err_msg=f"{op} {args}")
        # the same calls and bytes per PE; the host read is not counted
        assert got["footprint"] == virt.footprint()
    # the wrap is the reference's: int32, modulo 2^32
    tot = (2**31 - 7) * p % 2**32
    assert want[-5][0, 0] == (tot - 2**32 if tot >= 2**31 else tot)


def _attempt_spans(spans):
    return [(name, {k: a[k] for k in ("stage", "collective_count",
                                      "payload_bytes", "footprint",
                                      "predicted_s", "outcome")})
            for name, cat, a in spans if cat == "stage-attempt"]


def test_stage_collectives_and_bytes_equal_the_virtual_transport(pools):
    from repro_torch import obs
    s, r, cfg = CASES["escalate-s6"]
    table = ReferencePerms(0, P)
    tracer = obs.Tracer()
    _, _, st = virtual_solve(s, r, cfg, table, stage_counters=True,
                             tracer=tracer)
    want = _attempt_spans([(sp.name, sp.cat, sp.args)
                           for sp in tracer.spans])
    # the escalation's re-runs are attempts of their own
    assert [a["outcome"] for _, a in want].count("overflow") == 2
    for out in dist_solve(pools(2), s, r, cfg, table, stage_counters=True,
                          tracer=True):
        assert out["stats"]["stage_collectives"] == st["stage_collectives"]
        assert _attempt_spans(out["spans"]) == want
        (solve,) = [a for _, cat, a in out["spans"] if cat == "solve"]
        assert solve["backend"] == "mesh"


def test_telemetry_records_and_headroom_equal_the_virtual_transport(pools):
    s, r, cfg = CASES["list-g1-s1"]
    cfg = cfg.with_(telemetry=True)
    table = ReferencePerms(0, P)
    _, _, st = virtual_solve(s, r, cfg, table)
    for out in dist_solve(pools(2), s, r, cfg, table):
        assert out["stats"]["telemetry"] == st["telemetry"]


def test_grid_solve_equals_the_virtual_transport(pools):
    succ, rank = instances.gen_list(2048, gamma=1.0, seed=4)
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True)
    ind = IndirectionSpec.grid(("row", "col"))
    s0, r0, st0 = rank_list_with_stats(
        succ, rank, sim_mesh((2, 4), ("row", "col")), cfg=cfg,
        indirection=ind, device=CPU, stage_counters=True)
    for out in pools(4).run("solve", succ, rank, (2, 4), ("row", "col"),
                            cfg, None, {"indirection": ind,
                                        "stage_counters": True},
                            timeout=SOLVE_S):
        np.testing.assert_array_equal(out["succ"], s0.numpy())
        np.testing.assert_array_equal(out["rank"], r0.numpy())
        assert {k: v for k, v in out["stats"].items() if isinstance(v, int)
                } == {k: v for k, v in st0.items() if isinstance(v, int)}
        assert out["stats"]["stage_collectives"] == st0["stage_collectives"]


def test_tree_and_graph_front_doors_equal_the_virtual_transport(pools):
    parent = instances.gen_tree_parents(200, seed=101, locality=False)
    n_nodes = 48
    edges = instances.gen_graph_edges(n_nodes, 80, seed=3, locality=False)
    cfg = ListRankConfig()
    ts = treealg.tree_stats(parent, sim_mesh(P), cfg=cfg, seed=0,
                            device=CPU)
    gs = graphalg.graph_stats(edges, n_nodes, sim_mesh(P), cfg=cfg, seed=0,
                              device=CPU)
    ints = {k: v for k, v in gs.stats.items() if isinstance(v, int)}
    rooted = treealg.root_tree(parent, 7, sim_mesh(P), cfg=cfg, seed=0,
                               device=CPU)
    forest = treealg.solve_forest([parent[:50], parent[:50]], sim_mesh(P),
                                  cfg=cfg, seed=0, device=CPU)
    spanning = graphalg.spanning_forest(edges, n_nodes, sim_mesh(P),
                                        cfg=cfg, seed=0, device=CPU)[:2]
    for out in pools(2).run("tree_graph", parent, edges, n_nodes, (P,),
                            ("pe",), cfg, 0, timeout=SOLVE_S):
        for k, v in out["tree"].items():
            np.testing.assert_array_equal(v, getattr(ts, k), err_msg=k)
        for k, v in out["graph"].items():
            np.testing.assert_array_equal(v, getattr(gs, k), err_msg=k)
        assert {k: v for k, v in out["tree_stats"].items()
                if isinstance(v, int)} == {
            k: v for k, v in ts.stats.items() if isinstance(v, int)}
        assert {k: v for k, v in out["graph_stats"].items()
                if isinstance(v, int)} == ints
        assert out["graph_stats"]["stage_collectives"] == \
            gs.stats["stage_collectives"]
        assert out["graph_span_backend"] == "mesh"
        np.testing.assert_array_equal(out["root_tree"], rooted)
        for got, want in zip(out["forest_depth"], forest):
            np.testing.assert_array_equal(got, want.depth)
        for got, want in zip(out["spanning_forest"], spanning):
            np.testing.assert_array_equal(got, want)


def test_resolve_backend_cases():
    dm = DistMesh(axis_names=("pe",), axis_sizes=(8,), world=2, rank=1)
    assert dm.pes_per_rank == 4
    assert tl.resolve_backend("auto", dm, ("pe",)) == ("mesh", dm)
    assert tl.resolve_backend("mesh", dm, ("pe",)) == ("mesh", dm)
    assert tl.resolve_backend("simshard", dm, ("pe",)) == (
        "simshard", sim_mesh(8))
    with pytest.raises(ValueError, match="requires a real device mesh"):
        tl.resolve_backend("mesh", sim_mesh(8), ("pe",))
    assert tl.backend_name(dm) == "mesh"
    assert tl.backend_name(sim_mesh(8)) == "simshard"
    with pytest.raises(ValueError, match="do not split"):
        DistMesh(axis_names=("pe",), axis_sizes=(6,), world=4, rank=0)


def test_supervisor_inject_refused_and_launch_meshes(pools, tmp_path):
    """Supervision and fault injection on a DistMesh, which were refused
    until the distributed transport's checkpoints were ported, solve
    (``tests/test_torch_dist_recovery.py`` holds the fault matrix); the
    meshes of ``launch/mesh.py`` over the group."""
    from repro_torch.core.listrank import rank_list_seq
    succ, rank = instances.gen_list(64, gamma=1.0, seed=1)
    want = rank_list_seq(succ, rank)
    for out in pools(2).run("recovery_and_meshes", (P,), ("pe",),
                            str(tmp_path), timeout=SOLVE_S):
        for what in ("supervisor", "inject"):
            s, r, log = out[what]
            np.testing.assert_array_equal(s, want[0])
            np.testing.assert_array_equal(r, want[1])
        assert out["inject"][2][:2] == ("prep!InjectedFault", "prep")
        assert out["meshes"] == {"listrank": ((("pe",), (2,)), 1),
                                 "listrank_k4": ((("pe",), (8,)), 4),
                                 "host": ((("data", "model"), (2, 1)), 1)}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_moe_ep_equals_the_virtual_transport(pools, arch):
    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.runtime import context
    cfg = configs.get_config(arch, smoke=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), CPU)

    def first(t):
        return ({k: first(v) for k, v in t.items()} if isinstance(t, dict)
                else t[0].numpy())
    ffn = first(params["layers"]["ffn"])
    x = np.random.default_rng(3).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)
    shape, axes = (2, 1), ("data", "model")
    outs = pools(2).run("moe_ep", arch, ffn, x, shape, axes,
                        cfg.capacity_factor, timeout=SOLVE_S)
    want = L.moe_ffn  # the same dispatcher, on the virtual transport
    p = {k: ({kk: torch.from_numpy(vv).requires_grad_()
              for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v).requires_grad_())
         for k, v in ffn.items()}
    xt = torch.from_numpy(x).requires_grad_()
    with context.use_mesh(sim_mesh(shape, axes)) as ctx:
        y, aux = want(p, xt, cfg)
        counts = dict(ctx.transport(CPU).counts)
        leaves = {"x": xt, **{k: v for k, v in p.items()
                              if not isinstance(v, dict)},
                  **{f"shared.{k}": v for k, v in p.get("shared", {}).items()}}
        # the aux term too: each rank's loss seeds it once a mesh
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    list(leaves.values()))
    for out in outs:
        np.testing.assert_array_equal(out["y"], y.detach().numpy())
        assert out["aux"] == float(aux.detach())
        assert out["counts"] == counts
    for out in outs:  # every rank holds the whole gradient
        for name, g in zip(leaves, grads):
            np.testing.assert_allclose(out["grads"][name], g.numpy(),
                                       atol=2e-5, rtol=1e-4, err_msg=name)
