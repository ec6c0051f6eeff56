"""Scalability cost model (paper §2.6) and parameter selection.

The paper models a d-level indirect all-to-all with at most h words per
PE as  T_all2all(p,h,d) = alpha*d*p^(1/d) + beta*d*h  and derives

  T(n,p,r) = O( d*beta*n/p + alpha*d*p^(1/d) * n/r
                + alpha*d*p^(1/d)*log p + beta*d*r*log^2(p)/p )

with the optimum  r* = Theta( sqrt(alpha*n*p^(1+1/d)/beta) / log p ).

The model is consumed by :mod:`repro_torch.core.listrank.tuner` for (a) the
per-level ruler counts when ``ListRankConfig.ruler_fraction is None``
plus indirection/algorithm selection, (b) the benchmark harness's
modeled communication times (this container measures a single CPU, so
wall-clock alpha effects are modeled from counted messages with
machine constants), and (c) the EXPERIMENTS.md validation of the
paper's round/subproblem predictions.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """alpha/beta in seconds (per message startup / per 8-byte word)."""
    alpha: float
    beta: float
    name: str = "generic"


#: OmniPath-like cluster (SuperMUC-NG thin nodes; paper's platform).
SUPERMUC = MachineModel(alpha=2.0e-6, beta=8.0 / 100e9 * 8, name="supermuc-ng")
#: intra-node (shared memory / NVLink-class) for topology-aware hops.
INTRA_NODE = MachineModel(alpha=4.0e-7, beta=8.0 / 200e9, name="intra-node")


def t_all2all(p: int, h: float, d: int, m: MachineModel) -> float:
    """Paper's model for one d-level indirect all-to-all, h words/PE."""
    return m.alpha * d * p ** (1.0 / d) + m.beta * d * h


def r_star(n: int, p: int, d: int, m: MachineModel) -> int:
    """Optimal total ruler count (Observation 1)."""
    logp = max(math.log2(max(p, 2)), 1.0)
    r = math.sqrt(m.alpha * n * p ** (1.0 + 1.0 / d) / m.beta) / logp
    return max(p, min(int(r), n))


def t_model(n: int, p: int, r: int, d: int, m: MachineModel,
            n_prime: float | None = None) -> float:
    """Predicted SRS running time T(n,p,r) with a PD base case."""
    logp = max(math.log2(max(p, 2)), 1.0)
    if n_prime is None:
        n_prime = expected_subproblem(n, r)
    t_chase = d * m.beta * n / p + m.alpha * d * p ** (1.0 / d) * (n / max(r, 1))
    t_base = math.log2(max(n_prime, 2)) * (
        m.alpha * d * p ** (1.0 / d) + m.beta * d * n_prime / p)
    return t_chase + t_base


def t_hops(n: int, p: int, r: int, hop_sizes: "tuple[int, ...]",
           hop_machines: "tuple[MachineModel, ...]") -> float:
    """Generalization of :func:`t_model` to an explicit hop decomposition
    with per-hop machine constants (topology-aware indirection routes
    its first hop over intra-node links, which have a different alpha).

    One routing round costs ``sum_h alpha_h * hop_size(h)`` in startups
    (each hop is a dense all_to_all over its peer group) and every
    message crosses every hop, so the volume coefficient is
    ``sum_h beta_h``. Used by ``tuner.choose_indirection``.
    """
    logp = max(math.log2(max(p, 2)), 1.0)
    startup = sum(m.alpha * s for s, m in zip(hop_sizes, hop_machines))
    beta_eff = sum(m.beta for m in hop_machines)
    rounds = n / max(r, 1) + logp
    n_prime = expected_subproblem(n, r)
    t_chase = beta_eff * n / p + startup * rounds
    t_base = math.log2(max(n_prime, 2)) * (startup + beta_eff * n_prime / p)
    return t_chase + t_base


def expected_subproblem(n: int, r: int) -> float:
    """E[#rulers] with spawning ~= r * ln(n/r) (Sibeyn; paper §2.2)."""
    if r <= 0 or r >= n:
        return float(n)
    return r * max(math.log(n / r), 1.0)


def expected_rounds(n: int, r: int) -> float:
    """Chase rounds ~= n/r + 1 w.h.p. for r >> p log p (paper §2.2)."""
    return n / max(r, 1) + 1.0


def efficiency_threshold(p: int, d: int, m: MachineModel) -> float:
    """Corollary 1: the algorithm is efficient once
    n/p >> (alpha/beta) * p^(1/d) * log^2 p."""
    logp = max(math.log2(max(p, 2)), 1.0)
    return (m.alpha / m.beta) * p ** (1.0 / d) * logp ** 2
