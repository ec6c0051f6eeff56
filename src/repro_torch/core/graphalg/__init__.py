"""Distributed graph algorithms on top of the list-ranking engine — the
port of ``repro.core.graphalg``: distributed connectivity and spanning
forests via hooking + pointer-jumping rounds on the coalesced exchange
layer, then the unrooted-Euler-tour rooting technique (list ranking
again) to orient the forest and read off every tree statistic.

- :mod:`~repro_torch.core.graphalg.cc` — hooking rounds: min-label
  hooking onto component roots, winner-edge recording, pointer jumping,
- :mod:`~repro_torch.core.graphalg.forest` — Euler tours of unrooted
  forests in the edge-sharded arc layout (orientation falls out of the
  rank),
- :mod:`~repro_torch.core.graphalg.frontdoor` — ``connected_components``,
  ``spanning_forest`` and the end-to-end ``graph_stats`` (edges in,
  per-node depth/subtree/pre/postorder out) with the closed-form
  ``is_ancestor``/interval query layer.
"""
from repro_torch.core.graphalg.cc import (GRAPH_FATAL_KEYS, GraphCaps,
                                          derive_caps, endpoint_histogram)
from repro_torch.core.graphalg.frontdoor import (
    GraphStats, connected_components, graph_stats,
    pipeline_collective_footprint, spanning_forest)

__all__ = [
    "GRAPH_FATAL_KEYS", "GraphCaps", "derive_caps", "endpoint_histogram",
    "GraphStats", "connected_components", "graph_stats",
    "pipeline_collective_footprint", "spanning_forest",
]
