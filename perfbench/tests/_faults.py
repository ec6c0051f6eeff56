"""The faults the benchmark's check must catch, each planted in the
program under the harness. Each patches the port's modules in the
process that calls it and returns a callable that undoes the patch; a
spawned rank calls it before it joins the group."""
from __future__ import annotations

import numpy as np
import torch


def _patch(obj, name, value, undo: list):
    undo.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _undoer(undo):
    def run():
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    return run


def _solve_patch(wrap):
    """Patch the list front door wherever the paths reach it."""
    from repro_torch.core.listrank import api
    from repro_torch.core.treealg import batch
    undo: list = []
    fake = wrap(api.rank_list_with_stats)
    _patch(api, "rank_list_with_stats", fake, undo)
    _patch(batch, "rank_list_with_stats", fake, undo)
    return _undoer(undo)


def unchanged():
    """A solve that returns its state unchanged: its input."""
    def wrap(real):
        def fake(succ, rank, mesh, **kw):
            s, r, stats = real(succ, rank, mesh, **kw)
            return (torch.as_tensor(np.asarray(succ)).to(s),
                    torch.as_tensor(np.asarray(rank)).to(r), stats)
        return fake
    return _solve_patch(wrap)


def altered():
    """One answer altered where it is produced: one element's rank."""
    def wrap(real):
        def fake(succ, rank, mesh, **kw):
            s, r, stats = real(succ, rank, mesh, **kw)
            r = r.clone()
            r[r.shape[0] // 3] += 1
            return s, r, stats
        return fake
    return _solve_patch(wrap)


def half_batch():
    """Half of the batch left out: the batched solve ranks the first of
    its instances and hands that answer out for all."""
    from repro_torch.core.treealg import batch
    undo: list = []
    real = batch.rank_lists_with_stats

    def fake(instances, mesh, **kw):
        half = list(instances)[:max(1, len(instances) // 2)]
        results, stats = real(half, mesh, **kw)
        return [results[i % len(results)]
                for i in range(len(instances))], stats
    _patch(batch, "rank_lists_with_stats", fake, undo)
    return _undoer(undo)


def no_exchange():
    """The exchange left out: the virtual PEs' all_to_all returns what
    each PE sent, and between ranks nothing arrives."""
    import torch.distributed as dist
    from repro_torch.core.listrank import transport
    undo: list = []
    _patch(transport.VirtualTransport, "all_to_all",
           lambda self, x, hop, axis: x, undo)

    def silent(output, input, *args, **kw):
        output.zero_()
    _patch(dist, "all_to_all_single", silent, undo)
    return _undoer(undo)


#: the faults each configuration's cells can have
FAULTS = {
    "list-srs-p16": (unchanged, no_exchange, altered),
    "tree-euler-p16": (unchanged, half_batch, no_exchange, altered),
    "list-srs-p16-nccl4": (unchanged, no_exchange, altered),
}
