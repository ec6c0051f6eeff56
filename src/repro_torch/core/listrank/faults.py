"""Deterministic fault injection for the level-resumable solver.

The staged solve (:mod:`repro_torch.core.listrank.resume`) consults a
:class:`FaultInjector` around every stage it executes; each
:class:`FaultSpec` names one fault to fire at one (stage kind, level)
boundary. Faults are *host-driven*: they never perturb the per-PE
stage bodies, so a recovered solve replays the exact same device
computation as a straight-through solve — which is what lets the
recovery tests pin byte-identity against the committed goldens.

Injection taxonomy (DESIGN.md §11):

- ``overflow``: the solve treats the named capacity family as fatally
  overflowed after the stage, without touching device state — the
  escalate-and-resume path runs exactly as it would for a real
  overflow, but the re-run (with larger caps) reproduces the clean
  counters byte-for-byte.
- ``pe_loss``: an exception raised before the stage executes (a crashed
  rank); the solve restores from the latest checkpoint, or restarts
  from scratch when there is none.
- ``corrupt``: a recognizable sentinel scribbled over one PE's plane of
  a boundary store (a corrupted mailbox/successor plane); caught by the
  solve's host-side invariant validation, then recovered like a crash.
- ``preempt``: sets the supervisor's preemption flag (as SIGTERM/SIGINT
  would); the solve writes a blocking checkpoint and raises
  ``Preempted``.

Each spec fires exactly once (the first time its filter matches) and is
then retired, so the recovery re-run of the same stage proceeds clean.

Under the ``torch.distributed`` transport every rank consults its own
injector at the same (stage, level) boundaries, and the stage loop
agrees what fired over the ranks: a ``pe_loss`` or ``corrupt`` acts on
the rank that owns ``spec.pe`` (the PE is lost there, the plane is
scribbled there), an ``overflow`` or ``preempt`` on any rank that fires
it, and every rank then recovers alike. So a fault at a PE of another
rank, or a preemption on one rank only, recovers as it does on one
process.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

#: the sentinel ``corrupt`` scribbles into an int32 plane — far outside
#: any valid global id, so state validation cannot miss it.
CORRUPT_SENTINEL = -0x5EED5EED


class InjectedFault(RuntimeError):
    """Raised by ``pe_loss`` injection (stands in for a crashed PE)."""


class CorruptedState(RuntimeError):
    """Raised when boundary-state validation finds an invariant
    violation (e.g. an injected corrupted plane)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault to inject at one stage boundary.

    ``stage`` filters by stage kind (``"prep"``, ``"descend"``,
    ``"base"``, ``"ascend"``, ``"pd"``, ``"post"``; None matches any),
    ``level`` by recursion level (None matches any). ``family`` names
    the capacity family for ``overflow``; ``pe`` and ``plane`` locate
    the scribble for ``corrupt``.
    """
    kind: str                    # overflow | pe_loss | corrupt | preempt
    stage: str | None = None
    level: int | None = None
    family: str = "chase"
    pe: int = 0
    plane: str = "succ"

    def __post_init__(self):
        if self.kind not in ("overflow", "pe_loss", "corrupt", "preempt"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "overflow" and self.family not in (
                "chase", "sub", "gather"):
            raise ValueError(f"unknown capacity family {self.family!r}")


class FaultInjector:
    """Matches pending :class:`FaultSpec` entries against stage
    boundaries; every spec fires at most once."""

    def __init__(self, specs: Sequence[FaultSpec] | FaultSpec):
        if isinstance(specs, FaultSpec):
            specs = (specs,)
        self._pending = list(specs)
        self.fired: list[FaultSpec] = []

    def _take(self, kind: str, stage: str, level: int) -> FaultSpec | None:
        for f in self._pending:
            if f.kind != kind:
                continue
            if f.stage is not None and f.stage != stage:
                continue
            if f.level is not None and f.level != level:
                continue
            self._pending.remove(f)
            self.fired.append(f)
            return f
        return None

    @property
    def pending(self) -> tuple[FaultSpec, ...]:
        return tuple(self._pending)

    def pe_loss_before(self, stage: str, level: int) -> FaultSpec | None:
        """The ``pe_loss`` that matches, if any: the stage loop raises
        :class:`InjectedFault` for it before the stage runs (on every
        rank, once the rank that owns ``spec.pe`` has lost it)."""
        return self._take("pe_loss", stage, level)

    def overflow_after(self, stage: str, level: int) -> str | None:
        """The capacity family to treat as fatally overflowed, if any."""
        f = self._take("overflow", stage, level)
        return f.family if f is not None else None

    def corrupt_after(self, stage: str, level: int) -> FaultSpec | None:
        return self._take("corrupt", stage, level)

    def preempt_after(self, stage: str, level: int) -> bool:
        return self._take("preempt", stage, level) is not None
