"""The tree front door: ``treealg.tree_stats`` on one rooted tree.

The instance is a random rooted tree of the traffic file (``n``,
``locality``, ``num_trees``), drawn from the seed by the frozen
``gen_tree_parents``. A call builds the tree's Euler tour on the card, ranks both weightings
in one batched solve and returns each node's root, depth, subtree size,
preorder and postorder as host arrays. A window keeps every call's
arrays whole; the check holds each call's to the plain reference
(``perfbench/reference/treestats.py``, from the parent array alone) and
counts the nodes whose statistic differs; the limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import instances
from perfbench.paths.list import solver_config
from perfbench.reference import treestats as reference

#: the front door's unit of work
UNIT = "nodes"
#: the reference's statistics under the program's names
FIELDS = {"root": "root_of", "depth": "depth", "size": "subtree_size",
          "preorder": "preorder", "postorder": "postorder"}


def make(traffic: dict, seed: int):
    """The traffic file's tree drawn from ``seed``: ({"parent": int64
    array}, the number of nodes a call computes)."""
    parent = instances.gen_tree_parents(
        traffic["n"], seed=seed, locality=traffic["locality"],
        num_trees=traffic.get("num_trees", 1))
    return {"parent": parent}, traffic["n"]


class Program:
    """The system under test, as a user calls it."""

    def __init__(self, inst: dict, mesh, config: dict, device):
        self.parent = inst["parent"]
        self.mesh, self.device = mesh, device
        self.cfg = solver_config(config)

    def call(self, tracer=None):
        """({statistic: host array}, solver stats) of one call."""
        from repro_torch.core import treealg
        ts = treealg.tree_stats(self.parent, self.mesh, cfg=self.cfg,
                                device=self.device, tracer=tracer)
        return {k: getattr(ts, f) for k, f in FIELDS.items()}, ts.stats


class Control:
    """The control (control.py): the plain reference in the program's
    place, summed in ``dtype``: bfloat16, since float32, the step below
    the configuration's int32 distances, is exact below 2^24 and a tree
    of 2^22 nodes has 2^23 tour arcs."""

    def __init__(self, inst: dict, mesh, config: dict, device,
                 dtype=torch.bfloat16):
        self.parent, self.device, self.dtype = inst["parent"], device, dtype

    def call(self, tracer=None):
        parent = torch.from_numpy(self.parent).to(self.device)
        out = reference.tree_stats(parent, dtype=self.dtype)
        return {k: v.to(torch.int64).cpu().numpy()
                for k, v in out.items()}, {}


def sample_index(n: int, size: int, rng, device):
    """Every node is kept: the outputs are host arrays already."""
    return None


def sample(out, idx):
    return out


def check(inst: dict, kept: list, last, idx, device) -> dict:
    """{name: (number, limit)}: nodes whose statistic differs from the
    reference's, summed over every call of the window."""
    parent = torch.from_numpy(inst["parent"]).to(device)
    ref = {k: v.cpu().numpy() for k, v in
           reference.tree_stats(parent).items()}
    bad = dict.fromkeys(FIELDS, 0)
    for out in kept:
        for k in FIELDS:
            bad[k] += int(np.count_nonzero(
                np.asarray(out[k], np.int64) != ref[k]))
    return {f"{k}_mismatches": (v, 0) for k, v in bad.items()}
