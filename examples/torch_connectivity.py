"""Distributed connectivity and spanning forests on the PyTorch port: the
graphalg front door (the port of ``examples/connectivity.py``).

  PYTHONPATH=src python examples/torch_connectivity.py [--kernels] \\
      [--device cpu]

Generates multi-component random graphs of 2^11 nodes and 2^12 edges
(GNM-like and RGG2D-like), runs ``connected_components`` and the
end-to-end ``graph_stats`` pipeline (hooking rounds -> unrooted Euler
tour -> two list-ranking solves -> closed-form statistics) over 8
virtual PEs, verifies the components
against a host union-find and the emitted forest against ``tree_stats``,
and answers ancestor queries from the pre/postorder numbers without any
further communication. ``--kernels`` turns on the ``local_chase`` and
``mailbox_pack`` kernels (the reference's defaults leave both off). Runs
on the CUDA device unless ``--device`` says otherwise.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import graphalg, treealg  # noqa: E402
from repro_torch.core.listrank import (ListRankConfig,  # noqa: E402
                                       instances, sim_mesh)
from repro_torch.device import resolve_device  # noqa: E402

#: the two component-labelling families: (name, gen_graph_edges kwargs)
FAMILIES = (("gnm", dict(locality=False, num_components=6)),
            ("rgg2d", dict(locality=True, num_components=4)))
#: nodes, edges; virtual PEs (the reference example's 8 host devices)
N, E, P = 1 << 11, 1 << 12, 8


def union_find(n, edges) -> np.ndarray:
    """Min-id component labels of ``edges`` over ``n`` nodes."""
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(v) for v in range(n)])


def main(argv=None, perm_fn_for=None) -> dict:
    """Run the demo; returns each family's labels and stats, the
    ``GraphStats``, the ``TreeStats`` of its forest and the queried nodes.
    ``perm_fn_for(seed)`` supplies the ruler permutations of the solve
    seeded ``seed`` (the graph pipeline's solves draw seeds 0 and 1,
    ``tree_stats`` 0; the port's own when None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="launch local_chase and mailbox_pack")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = sim_mesh(P)
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True,
                         use_pallas=args.kernels,
                         use_pallas_pack=args.kernels)
    n, e = N, E
    out = {"cc": {}}
    for fam, kw in FAMILIES:
        edges = instances.gen_graph_edges(n, e, seed=42, **kw)
        labels, st = graphalg.connected_components(
            edges, n, mesh, cfg=cfg, device=device, perm_fn_for=perm_fn_for)
        labels = np.asarray(labels)
        assert np.array_equal(labels, union_find(n, edges)), fam
        print(f"{fam}: n={n} E={e} -> {np.unique(labels).size} components "
              f"in {st['cc_rounds']} hooking rounds "
              f"({st['cc_msgs']} messages), verified vs union-find")
        out["cc"][fam] = (labels, st)

    # end to end: edges -> rooted forest -> Euler tour -> statistics
    edges = instances.gen_graph_edges(n, e, seed=7, locality=True,
                                      num_components=3)
    gs = graphalg.graph_stats(edges, n, mesh, cfg=cfg, device=device,
                              perm_fn_for=perm_fn_for)
    print(f"graph_stats: {gs.n_components} components, "
          f"max depth {gs.depth.max()}, attempts={gs.stats['attempts']}")

    # the emitted forest is a first-class treealg input
    st = treealg.tree_stats(gs.parent, mesh, cfg=cfg, device=device,
                            perm_fn=perm_fn_for and perm_fn_for(0))
    assert np.array_equal(st.depth, gs.depth)
    assert np.array_equal(st.preorder, gs.preorder)
    print("treealg.tree_stats on the emitted forest: identical statistics")

    # ancestor queries are closed-form over pre/postorder — no solves
    queried = np.random.default_rng(0).integers(0, n, 5)
    for x in queried:
        lo, hi = gs.subtree_interval(int(x))
        anc = gs.is_ancestor(gs.parent[x], x)
        print(f"  node {x}: subtree preorder interval [{lo}, {hi}], "
              f"parent-is-ancestor={bool(anc)}")
        assert bool(anc)
    print("connectivity example OK")
    out.update(graph=gs, tree=st, queried=queried)
    return out


if __name__ == "__main__":
    main()
