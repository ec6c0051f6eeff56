"""Rank processes for the ``torch.distributed`` transport's tests.

:class:`RankPool` spawns ``world`` processes once (``spawn`` start
method, ``init_method="file://..."`` in a temporary directory, so no TCP
port is involved) and runs jobs in all of them: every rank gets the same
job and arguments, as an SPMD program's ranks do, and the pool returns
each rank's result, or raises with a rank's traceback, or raises
``TimeoutError`` (and closes the pool) when a job outlasts its timeout.

This module is what the ranks import: torch, numpy and ``repro_torch``
only, never jax or the JAX package. Inputs (instances, the reference's
ruler permutations) arrive as numpy arrays from the parent.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_lib
import shutil
import sys
import tempfile
import time
import traceback

#: seconds a rank waits in one collective before gloo gives up (a rank
#: that raised leaves its peers waiting)
COLLECTIVE_TIMEOUT_S = 120


class RankPool:
    """``world`` rank processes of one process group, kept across jobs."""

    def __init__(self, world: int, backend: str = "gloo",
                 device: str = "cpu", start_timeout: float = 120.0):
        self.world = world
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="rankpool")
        init = "file://" + os.path.join(self._tmp, "store")
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_serve, args=(r, world, backend, device, init,
                                 self._jobs[r], self._results), daemon=True)
            for r in range(world)]
        for pr in self._procs:
            pr.start()
        self.closed = False
        self.run("ready", timeout=start_timeout)

    def run(self, job: str, *args, timeout: float = 60.0) -> list:
        """Run ``job`` (a function of this module's ``JOBS``) with
        ``args`` on every rank; each rank's result, in rank order."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        for q in self._jobs:
            q.put((job, args))
        got: dict = {}
        deadline = time.monotonic() + timeout
        while len(got) < self.world:
            try:
                rank, ok, out = self._results.get(timeout=0.5)
            except queue_lib.Empty:
                dead = {r: pr.exitcode for r, pr in enumerate(self._procs)
                        if pr.exitcode is not None}
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise TimeoutError(
                        f"job {job!r}: ranks exited {dead}" if dead else
                        f"job {job!r}: no result from ranks "
                        f"{sorted(set(range(self.world)) - set(got))} "
                        f"within {timeout} s")
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"job {job!r} failed on rank {rank}:\n"
                                   f"{out}")
            got[rank] = out
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop every rank (a clean exit if they are idle, else killed)
        and remove the rendezvous directory."""
        if self.closed:
            return
        self.closed = True
        for q in self._jobs:
            q.put(None)
        for pr in self._procs:
            pr.join(timeout=10)
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=10)
        shutil.rmtree(self._tmp, ignore_errors=True)


def _serve(rank, world, backend, device, init, jobs, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        while True:
            item = jobs.get()
            if item is None:
                break
            name, args = item
            try:
                results.put((rank, True, JOBS[name](device, *args)))
            except Exception:  # reported to the parent, which fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# jobs (run on every rank; ``device`` is the pool's)
# --------------------------------------------------------------------------

def _ready(device):
    return {"jax": "jax" in sys.modules,
            "repro": any(m == "repro" or m.startswith("repro.")
                         for m in sys.modules)}


def _mesh(shape, axis_names):
    from repro_torch.core.listrank import dist_mesh
    return dist_mesh(tuple(shape), tuple(axis_names))


def _host_stats(stats: dict) -> dict:
    """The picklable part of a front door's stats."""
    keep = {}
    for k, v in stats.items():
        if isinstance(v, (int, float, str, tuple, list, dict)):
            keep[k] = v
    return keep


def _perm_fn(table):
    from repro_torch.core.listrank import perm_fn_from_numpy
    return perm_fn_from_numpy(table) if table is not None else None


def _solve(device, succ, rank, shape, axis_names, cfg, table, kw):
    """``rank_list_with_stats`` over the process group; the whole outputs
    and the stats, with the kernels' launch counts."""
    from repro_torch.core.listrank import rank_list_with_stats
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    lc_ops.LAUNCHES = mp_ops.LAUNCHES = 0
    kw = dict(kw)
    tracer = None
    if kw.pop("tracer", False):
        from repro_torch import obs
        tracer = obs.Tracer()
    s, r, st = rank_list_with_stats(
        succ, rank, _mesh(shape, axis_names), cfg=cfg, device=device,
        perm_fn=_perm_fn(table), tracer=tracer, **kw)
    out = {"succ": s.cpu().numpy(), "rank": r.cpu().numpy(),
           "stats": _host_stats(st),
           "launches": {"local_chase": lc_ops.LAUNCHES,
                        "mailbox_pack": mp_ops.LAUNCHES}}
    if tracer is not None:
        out["spans"] = [(sp.name, sp.cat, dict(sp.args))
                        for sp in tracer.spans]
    return out


def _recovery_and_meshes(device, shape, axis_names, ckpt_dir):
    """A supervised solve and an injected one over the process group
    (whole outputs; the stage logs), and the meshes ``launch/mesh.py``
    makes over the group."""
    from repro_torch.core.listrank import (FaultSpec, instances,
                                           rank_list_with_stats)
    from repro_torch.runtime.fault_tolerance import (SolveSupervisor,
                                                     SolveSupervisorConfig)
    succ, rank = instances.gen_list(64, gamma=1.0, seed=1)
    mesh = _mesh(shape, axis_names)
    out = {}
    for what, kw in (
            ("supervisor", {"supervisor": SolveSupervisor(
                SolveSupervisorConfig(ckpt_dir=ckpt_dir))}),
            ("inject", {"inject": FaultSpec("pe_loss", stage="prep")})):
        s, r, st = rank_list_with_stats(succ, rank, mesh, device=device,
                                        **kw)
        out[what] = (s.cpu().numpy(), r.cpu().numpy(), st["stage_log"])
    from repro_torch.launch import mesh as mesh_lib
    out["meshes"] = {
        name: ((m.axis_names, m.axis_sizes), m.pes_per_rank)
        for name, m in (("listrank", mesh_lib.make_listrank_mesh()),
                        ("listrank_k4", mesh_lib.make_listrank_mesh(4)),
                        ("host", mesh_lib.make_host_mesh()))}
    return out


def _collectives(device, shape, axis_names, cases):
    """Each collective of ``DistTransport`` on this rank's block of the
    whole (p, ...) inputs: ``cases`` is a list of (op, args, x) with op
    one of ``all_to_all`` (args: hop, axis), ``psum``, ``all_gather``,
    ``gather_pes``, ``psum_axes`` (args: axes); returns this rank's
    outputs, and the counting
    wrapper's counts and bytes per PE."""
    import torch
    from repro_torch.core.listrank import transport as tl
    mesh = _mesh(shape, axis_names)
    tr = tl.CountingTransport(tl.DistTransport.for_mesh(
        mesh, mesh.axis_names, device))
    k, first = tr.p_local, tr.first_pe
    outs = []
    for op, args, x in cases:
        xl = torch.from_numpy(x[first:first + k]).to(device)
        if op == "all_to_all":
            y = tr.all_to_all(xl, tuple(args[0]), args[1])
        else:
            y = getattr(tr, op)(xl, *args)
        outs.append(y.cpu().numpy())
    return {"outs": outs, "ids": tr.axis_index().cpu().numpy(),
            "footprint": tr.footprint()}


def _tree_graph(device, parent, edges, n_nodes, shape, axis_names, cfg,
                seed):
    """``tree_stats``, ``root_tree``, ``solve_forest``, ``graph_stats``
    (traced) and ``spanning_forest`` over the process group."""
    from repro_torch import obs
    from repro_torch.core import graphalg, treealg
    mesh = _mesh(shape, axis_names)
    ts = treealg.tree_stats(parent, mesh, cfg=cfg, seed=seed, device=device)
    tracer = obs.Tracer()
    gs = graphalg.graph_stats(edges, n_nodes, mesh, cfg=cfg, seed=seed,
                              device=device, tracer=tracer)
    tree = {k: getattr(ts, k) for k in ("depth", "subtree_size", "preorder",
                                        "postorder", "root_of")}
    graph = {k: getattr(gs, k) for k in ("components", "parent", "depth",
                                         "subtree_size", "preorder",
                                         "postorder")}
    (span,) = tracer.find(cat="solve")
    rooted = treealg.root_tree(parent, 7, mesh, cfg=cfg, seed=seed,
                               device=device)
    forest = treealg.solve_forest([parent[:50], parent[:50]], mesh,
                                  cfg=cfg, seed=seed, device=device)
    span_parent, labels, _ = graphalg.spanning_forest(
        edges, n_nodes, mesh, cfg=cfg, seed=seed, device=device)
    return {"tree": tree, "tree_stats": _host_stats(ts.stats),
            "root_tree": rooted, "forest_depth": [f.depth for f in forest],
            "spanning_forest": (span_parent, labels),
            "graph": graph, "graph_stats": _host_stats(gs.stats),
            "graph_span_backend": span.args.get("backend")}


def _moe_ep(device, arch, ffn, x, shape, axis_names, capacity_factor):
    """One SMOKE MoE layer (``ffn``: its parameters as numpy arrays) on
    ``x`` under a mesh context over the process group: the output, the
    aux loss, the gradients of ``sum(y * y) + aux`` on this rank, and
    the transport's collectives."""
    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.runtime import context
    cfg = configs.get_config(arch, smoke=True).with_(
        capacity_factor=capacity_factor)

    def tensors(t):
        return ({k: tensors(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(t).to(device).requires_grad_())
    p = tensors(ffn)
    xt = torch.from_numpy(x).to(device).requires_grad_()
    with context.use_mesh(_mesh(shape, axis_names)) as ctx:
        y, aux = L.moe_ffn(p, xt, cfg)
        counts = dict(ctx.transport(device).counts)
        leaves = {"x": xt, **{k: v for k, v in p.items()
                              if not isinstance(v, dict)},
                  **{f"shared.{k}": v for k, v in p.get("shared", {}).items()}}
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    list(leaves.values()))
    return {"y": y.detach().cpu().numpy(), "aux": float(aux.detach()),
            "grads": {k: g.cpu().numpy() for k, g in zip(leaves, grads)},
            "counts": counts}


def _supervised(device, succ, rank, shape, axis_names, cfg, table, ckpt_dir,
                faults, kw):
    """``rank_list_with_stats`` under a ``SolveSupervisor`` on
    ``ckpt_dir`` (the same directory on every rank), with this rank's
    ``faults`` (``faults[rank]``: a list of FaultSpecs, or None): the
    whole outputs and the stats, or, when the solve was preempted, the
    step it stopped at and the supervisor's stats."""
    import torch.distributed as dist
    from repro_torch.core.listrank import rank_list_with_stats
    from repro_torch.runtime.fault_tolerance import (Preempted,
                                                     SolveSupervisor,
                                                     SolveSupervisorConfig)
    sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=ckpt_dir))
    mine = faults[dist.get_rank()]
    try:
        s, r, st = rank_list_with_stats(
            succ, rank, _mesh(shape, axis_names), cfg=cfg, device=device,
            perm_fn=_perm_fn(table), supervisor=sup, inject=mine, **kw)
    except Preempted:
        return {"preempted": sup.ckpt.latest_step(),
                "recovery": dict(sup.stats)}
    return {"succ": s.cpu().numpy(), "rank": r.cpu().numpy(),
            "stats": _host_stats(st), "records": dict(sup.ckpt.records)}


def _failed_write(device, succ, rank, shape, axis_names, cfg, table,
                  ckpt_dir, faults, fail_call):
    """:func:`_supervised`'s solve with rank 0's ``fail_call``-th
    checkpoint write failing: the exception the solve raised on this rank
    (its type name and, for a ``CheckpointWriteError``, its step)."""
    import torch.distributed as dist
    from repro_torch.core.listrank import rank_list_with_stats
    from repro_torch.runtime.fault_tolerance import (SolveSupervisor,
                                                     SolveSupervisorConfig)
    sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=ckpt_dir))
    real, calls = sup.ckpt._write, []

    def write(step, *args):
        calls.append(step)
        if len(calls) == fail_call:
            raise OSError(f"no space left writing step {step}")
        return real(step, *args)
    if dist.get_rank() == 0:
        sup.ckpt._write = write
    try:
        rank_list_with_stats(
            succ, rank, _mesh(shape, axis_names), cfg=cfg, device=device,
            perm_fn=_perm_fn(table), supervisor=sup,
            inject=faults[dist.get_rank()])
    except Exception as e:
        return {"raised": type(e).__name__, "step": getattr(e, "step", None)}
    return {"raised": None}


def _fingerprint(device, succ, rank, shape, axis_names, cfg, seed):
    """The solve fingerprint a supervised solve over the process group
    computes on this rank (its blocks gathered in global order)."""
    import numpy as np
    from repro_torch.core.listrank import api, resume
    mesh = _mesh(shape, axis_names)
    plan = api.make_plan(mesh, tuple(axis_names), cfg, device, None)
    wdt = np.float32 if rank.dtype.kind == "f" else np.int32
    succ_d = api.local_block(plan, succ.astype(np.int32), device)
    rank_d = api.local_block(plan, rank.astype(wdt), device)
    return resume.solve_fingerprint(
        *resume._whole_instance(succ_d, rank_d, plan), succ.shape[0],
        plan.p, seed, cfg)


def _compressed_psum(device, x, error, shape, axis_names, axes):
    """``compression.compressed_psum`` of this rank's rows of the whole
    (p, ...) ``x`` and ``error`` over the process group's PEs (over the
    mesh ``axes`` only, when given): this rank's (reduced, new_error)."""
    import torch
    from repro_torch.core.listrank import transport as tl
    from repro_torch.runtime import compression
    tr = tl.DistTransport.for_mesh(_mesh(shape, axis_names), axis_names,
                                   device)
    rows = slice(tr.first_pe, tr.first_pe + tr.p_local)
    red, new = compression.compressed_psum(
        torch.from_numpy(x[rows]).to(device), tr,
        torch.from_numpy(error[rows]).to(device), axes)
    return red.cpu().numpy(), new.cpu().numpy()


def _train_launcher(device, argv, fail_rank, fail_call):
    """``launch/train.py`` with ``argv`` on every rank (under the
    group's host mesh), ``train_step`` failing on rank ``fail_rank`` at
    its ``fail_call``-th call (None: never): the history, the optimizer
    step each ``train_step`` call started from, and the checkpoint
    directories at the end."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_launch
    real = train_launch.train_steps.train_step
    calls = []

    def step(params, opt, *a, **kw):
        calls.append(int(opt["step"]))
        if dist.get_rank() == fail_rank and len(calls) == fail_call:
            raise RuntimeError("a failed step on one rank")
        return real(params, opt, *a, **kw)
    train_launch.train_steps.train_step = step
    try:
        history = train_launch.main(list(argv) + ["--device", device])
    finally:
        train_launch.train_steps.train_step = real
    ckpt = argv[argv.index("--ckpt-dir") + 1]
    return {"history": history, "calls": calls,
            "dirs": sorted(os.listdir(ckpt))}


JOBS = {"ready": _ready, "solve": _solve,
        "recovery_and_meshes": _recovery_and_meshes,
        "collectives": _collectives, "tree_graph": _tree_graph,
        "moe_ep": _moe_ep, "supervised": _supervised,
        "failed_write": _failed_write,
        "fingerprint": _fingerprint, "compressed_psum": _compressed_psum,
        "train_launcher": _train_launcher}
