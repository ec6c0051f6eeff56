"""The list front door: ``rank_list_with_stats`` on one instance.

The instance is List(n, gamma) of the traffic file (``n``, ``gamma``,
``num_lists``), drawn from the seed by the frozen ``gen_list``. A call
returns every element's terminal and rank as tensors on the card (whole
on every rank of a ``dist_mesh``). What a window keeps of a call is the
outputs at a sample of elements drawn from the seed, gathered on the
card and copied to the host, so that the card holds no more for the
check after ten calls than after one; its last call is kept whole. The
check holds both to plain pointer doubling
(``perfbench/reference/listrank.py``) and counts the elements whose
terminal or rank differ; the limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import instances
from perfbench.reference import listrank as reference

#: the front door's unit of work
UNIT = "elements"


def make(traffic: dict, seed: int):
    """The traffic file's list drawn from ``seed``: ({"succ", "rank"}
    as int32 arrays, the number of elements a call ranks)."""
    succ, rank = instances.gen_list(traffic["n"], traffic["gamma"],
                                    seed=seed,
                                    num_lists=traffic.get("num_lists", 1))
    return {"succ": succ, "rank": rank}, traffic["n"]


def solver_config(config: dict):
    """The port's ``ListRankConfig`` with the configuration's settings
    over its defaults."""
    from repro_torch.core.listrank import ListRankConfig
    return ListRankConfig(**config.get("solver", {}))


class Program:
    """The system under test, as a user calls it."""

    def __init__(self, inst: dict, mesh, config: dict, device,
                 weight_dtype=np.int32):
        self.succ = inst["succ"]
        self.rank = inst["rank"].astype(weight_dtype)
        self.mesh, self.device = mesh, device
        self.cfg = solver_config(config)

    def call(self, tracer=None):
        """((terminal, rank), solver stats) of one call."""
        from repro_torch.core.listrank import api
        succ, rank, stats = api.rank_list_with_stats(
            self.succ, self.rank, self.mesh, cfg=self.cfg,
            device=self.device, tracer=tracer)
        return (succ, rank), stats


class Control(Program):
    """The control (control.py): the program's own float32 weight path,
    the unit weights passed as float32, so a distance above 2^24 rounds
    where the configuration states exact int32 distances."""

    def __init__(self, inst: dict, mesh, config: dict, device):
        super().__init__(inst, mesh, config, device, weight_dtype=np.float32)


def sample_index(n: int, size: int, rng, device) -> torch.Tensor:
    """``size`` distinct elements of ``n`` drawn from ``rng``, sorted."""
    idx = np.sort(rng.choice(n, size=min(size, n), replace=False))
    return torch.from_numpy(idx).to(device)


def sample(out, idx):
    """The outputs at ``idx``, on the host."""
    succ, rank = out
    return succ.index_select(0, idx).cpu(), rank.index_select(0, idx).cpu()


def check(inst: dict, kept: list, last, idx, device) -> dict:
    """{name: (number, limit)}: elements whose terminal or rank differ
    from the reference's, over every kept sample and the last call."""
    succ = torch.from_numpy(inst["succ"]).to(device)
    weight = torch.from_numpy(inst["rank"]).to(device)
    term, dist = reference.rank_list(succ, weight)
    del succ, weight
    bad_term = bad_rank = 0
    if kept:
        term_at, dist_at = term[idx].cpu(), dist[idx].cpu()
    for s, r in kept:
        bad_term += int((s.to(torch.int64) != term_at).sum())
        bad_rank += int((r.to(torch.int64) != dist_at).sum())
    if last is not None:
        s, r = last
        bad_term += int((s.to(torch.int64) != term).sum())
        bad_rank += int((r.to(torch.int64) != dist).sum())
    return {"terminal_mismatches": (bad_term, 0),
            "rank_mismatches": (bad_rank, 0)}
