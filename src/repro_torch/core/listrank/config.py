"""Configuration for the distributed list-ranking algorithms."""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

from repro_torch.core.listrank.analysis import SUPERMUC, MachineModel


@dataclasses.dataclass(frozen=True)
class IndirectionSpec:
    """How messages are routed across the PE mesh (paper §2.4).

    ``hops`` is an ordered tuple of mesh-axis groups. Each hop fixes the
    destination coordinate along its axis group via one ``all_to_all``.

    - direct delivery: a single hop over all PE axes,
    - 2D-grid indirection: ``(("col",), ("row",))`` — first to the right
      column, then along the column to the right row,
    - topology-aware indirection: intra-node axis first, then the
      inter-node axis (paper: ``P_{i,u} -> P_{i,v} -> P_{j,v}``).
    """

    hops: tuple[tuple[str, ...], ...]

    @staticmethod
    def direct(pe_axes: Sequence[str]) -> "IndirectionSpec":
        return IndirectionSpec(hops=(tuple(pe_axes),))

    @staticmethod
    def grid(pe_axes: Sequence[str]) -> "IndirectionSpec":
        """One hop per mesh axis, last-axis (fastest-varying) first.

        With PE id flattened row-major over ``pe_axes``, hopping over the
        minor axis first is the paper's column-then-row routing.
        """
        return IndirectionSpec(hops=tuple((a,) for a in reversed(pe_axes)))

    @staticmethod
    def topology(intra_axes: Sequence[str], inter_axes: Sequence[str]) -> "IndirectionSpec":
        """Intra-node hop first (fast links), then inter-node (paper §2.4)."""
        return IndirectionSpec(hops=(tuple(intra_axes), tuple(inter_axes)))

    @property
    def depth(self) -> int:
        return len(self.hops)


@dataclasses.dataclass(frozen=True)
class ListRankConfig:
    """Tuning knobs for :func:`repro_torch.core.listrank.api.rank_list`.

    Defaults follow the paper's production configuration: sparse ruling
    set with spawning, local contraction enabled, reversal avoided via
    the terminal->initial postprocessing (§2.5), pointer doubling as the
    base case after ``srs_rounds`` rounds of SRS.
    """

    #: ``"auto"`` resolves via the Corollary-1 regime check
    #: (tuner.choose_algorithm): SRS when n/p clears
    #: analysis.efficiency_threshold, plain pointer doubling below it.
    algorithm: Literal["srs", "doubling", "auto"] = "srs"
    #: number of recursive SRS rounds before the base case (paper uses 2).
    srs_rounds: int = 2
    base_case: Literal["doubling", "allgather"] = "doubling"

    #: rulers per PE as a fraction of the (effective) local input size.
    #: ``None`` derives per-level r* from the cost model
    #: (tuner.level_plan on top of analysis.r_star).
    ruler_fraction: float | None = 1.0 / 32.0
    #: machine constants (alpha/beta) for every cost-model decision.
    machine: MachineModel = SUPERMUC
    #: when no explicit IndirectionSpec is passed to rank_list, let the
    #: cost model pick direct vs grid vs topology-aware routing
    #: (tuner.choose_indirection). False keeps the direct default.
    auto_indirection: bool = False
    #: hard floor on the per-PE ruler count.
    min_rulers_per_pe: int = 4

    #: exploit locality by contracting PE-local sublists first (§2.3).
    local_contraction: bool = True
    #: avoid the explicit list reversal via §2.5 postprocessing. When
    #: False, runs the faithful Algorithm 1 with reversal preprocessing.
    avoid_reversal: bool = True
    #: deduplicate remote-gather requests per PE (§2.5 aggregation).
    dedup_requests: bool = True

    #: capacity slack over the expected per-peer message load.
    capacity_slack: float = 2.0
    #: floor for the per-peer mailbox capacity.
    min_capacity: int = 8
    #: outgoing-queue capacity as multiple of expected in-flight load.
    queue_slack: float = 4.0
    #: spawn-scan window per round (candidates examined per death batch).
    spawn_window: int = 64

    #: safety bound on chase rounds (multiplier over the n/r estimate).
    max_round_slack: float = 8.0
    #: bound on outer restarts (coverage safeguard for forward chasing).
    max_restarts: int = 4
    #: sub-problem capacity slack over the r*ln(n/r) expectation.
    sub_capacity_slack: float = 2.0

    #: sampled-splitter capacity estimation (tuner.estimate_capacities):
    #: derive per-hop mailbox slack from a host-side sample of the
    #: instance's destination distribution instead of the static
    #: ``capacity_slack`` guess. Off by default — the static derivation
    #: is the pinned golden behavior.
    capacity_estimation: bool = False
    #: sample size for the capacity pre-pass.
    estimation_sample: int = 2048

    #: transport backend (repro_torch.core.listrank.transport):
    #: ``"auto"`` follows the mesh object passed to the front door (a
    #: ``transport.SimMesh`` selects the virtual-PE transport);
    #: ``"simshard"`` forces virtual PEs; ``"mesh"`` is the
    #: ``torch.distributed`` transport over a ``transport.DistMesh``
    #: (``dist_mesh``); it raises ValueError for a SimMesh and TypeError
    #: for any other mesh object (``transport.resolve_backend``).
    backend: Literal["auto", "mesh", "simshard"] = "auto"

    #: run local contraction's pointer doubling through the hand-written
    #: ``local_chase`` CUDA kernel (the plain torch loop otherwise).
    use_pallas: bool = False

    #: pack all payload leaves of a message batch into one (W, Q) int32
    #: wire matrix so every routing hop is exactly one ``all_to_all``
    #: (see DESIGN.md). Off => legacy one-collective-per-leaf exchange;
    #: both paths are bit-identical.
    wire_packing: bool = True
    #: route the wire pack + bucket scatter through the hand-written
    #: ``mailbox_pack`` CUDA kernel (the plain torch scatter otherwise).
    use_pallas_pack: bool = False

    #: device-side telemetry plane (repro_torch.obs.telemetry): every
    #: routing site also records per-PE mailbox fill, destination skew
    #: and queue high-water marks, merged on the device per stage and
    #: copied to the host once per stage into ``stats["telemetry"]``.
    #: Outputs, counters and collectives are identical with it off.
    telemetry: bool = False

    def with_(self, **kw) -> "ListRankConfig":
        return dataclasses.replace(self, **kw)
