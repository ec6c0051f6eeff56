"""Device-side telemetry plane: occupancy/skew counters + headroom.

The port's counterpart of the JAX package's ``repro.obs.telemetry``.
The flight recorder (:mod:`.trace`) times a stage from the host but
cannot see *inside* it. This module is the other half: when
``ListRankConfig.telemetry=True``, every routing site emits a small
telemetry record of per-PE tensors, merged on the device across the
stage's rounds:

- per-hop mailbox **fill fractions** — ``fill_max`` is the hottest
  bucket's *demand* over the cap (can exceed 1.0: that is exactly an
  overflow explained before it becomes a fatal counter),
  ``fill_mean_sum / rounds`` the mean delivered fill;
- per-hop **destination skew** — the hottest bucket's fraction of the
  wave's traffic (``dest_frac_max``), directly comparable to
  ``tuner.estimate_capacities``' sampled ``max_frac`` and its DKW
  margin;
- a coarse ``HIST_BINS``-bucket destination histogram over the hop-0
  coordinate, and queue-depth high-water marks.

Every leaf carries the port's leading PE axis (``fill_max`` is
``(p, depth)`` float32, ``hist`` ``(p, HIST_BINS)`` int32, ``rounds`` and
``queue_hwm`` ``(p,)`` int32) and is computed from the bucket sort the
routing already did — never from the packed send buffer, so the records
do not depend on whether ``mailbox_pack`` ran. Nothing is reduced over
PEs on the device: no transport call is added, the cross-PE *spread*
survives, and a record reaches the host in one copy per stage
(:func:`to_host`), where the host half aggregates it.

The fill fractions take the reference's operands and grouping and its
compiled arithmetic: XLA rewrites a division by a constant into a
multiplication by the constant's float32 reciprocal, so a fill over a
static cap is ``demand * f32(1 / cap)`` here too, and the skew (over a
run-time total) a true division. Merged in the reference's order, the
per-stage :class:`StageRecord` equals the reference's exactly.

The host half (:func:`aggregate`, :class:`StageRecord`,
:func:`headroom_rows`, :func:`format_headroom_table`,
:func:`dkw_backtest`) renders the capacity headroom report — observed
max fill / cap, per family per level — cross-referenced against the
solver's escalation log so every capacity escalation is explained in
``scales_log`` terms.

Only torch/numpy imports here: this module is imported by the exchange
layer and must not cycle back into ``repro_torch.core.listrank``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

#: coarse destination-histogram resolution (hop-0 coordinate buckets).
HIST_BINS = 8

#: telemetry leaves merged by max (high-water marks / worst observed);
#: every other leaf is additive.
MAX_KEYS = frozenset({"fill_max", "dest_frac_max", "queue_hwm"})

#: the capacity families a stage can route under — the same names as
#: ``tuner.CapacityScales`` fields ("graph" covers the graphalg /
#: treealg front-door hooking/tour capacities).
STAGE_FAMILIES = ("chase", "sub", "gather", "graph")

TELEMETRY_HELP = {
    "fill_max": "hottest mailbox bucket demand / compiled cap (HWM; >1 explains an overflow)",
    "fill_mean": "mean delivered mailbox fill fraction per routing wave",
    "dest_frac_max": "hottest destination bucket's fraction of a wave's traffic (HWM)",
    "hist": "coarse destination histogram over the hop-0 coordinate",
    "rounds": "routing waves accumulated into this telemetry record",
    "queue_hwm": "outgoing-queue depth high-water mark (entries)",
    "util_max": "max mailbox fill fraction across hops/families of the stage",
    "util_mean": "mean delivered mailbox fill fraction of the stage",
}


# --------------------------------------------------------------------------
# device half: zeros, merge, and the per-wave records (per-PE tensors)
# --------------------------------------------------------------------------

def route_zero(p: int, depth: int, device):
    """Zero telemetry record of one routing family over a ``depth``-hop
    indirection, per PE."""
    f32 = torch.zeros((p, depth), dtype=torch.float32, device=device)
    return {
        "fill_max": f32,
        "fill_mean_sum": f32,
        "dest_frac_max": f32,
        "hist": torch.zeros((p, HIST_BINS), dtype=torch.int32,
                            device=device),
        "rounds": torch.zeros(p, dtype=torch.int32, device=device),
    }


def stage_zero(p: int, depth: int, device):
    """Zero per-stage telemetry: one route record per capacity family
    plus the queue high-water mark. Uniform across stage kinds so every
    stage reports the same record structure."""
    tele = {fam: route_zero(p, depth, device) for fam in STAGE_FAMILIES}
    tele["queue_hwm"] = torch.zeros(p, dtype=torch.int32, device=device)
    return tele


def merge(a, b):
    """Merge two telemetry records leafwise: :data:`MAX_KEYS` leaves
    take the elementwise max (high-water marks), everything else adds.
    ``None`` is the identity; keys are unioned (a partial increment
    merges into a full ``stage_zero`` record, and a key one side lacks
    keeps the other side's leaf as it is)."""
    if a is None:
        return b
    if b is None:
        return a
    out = {}
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k), b.get(k)
        if va is None:
            out[k] = vb
        elif vb is None:
            out[k] = va
        elif isinstance(va, dict):
            out[k] = merge(va, vb)
        elif k in MAX_KEYS:
            out[k] = torch.maximum(va, vb)
        else:
            out[k] = va + vb
    return out


def _recip(cap: int) -> float:
    """The float32 reciprocal of ``max(cap, 1)``, as a host scalar that
    float32 holds exactly: multiplying by it is one float32 rounding on
    either device, as in the reference's compiled program."""
    return float(np.float32(1.0) / np.float32(max(int(cap), 1)))


def _over(count, cap: int):
    """``count`` (int32) over the static ``cap`` in float32, as the
    reference's compiled program computes it: times the float32
    reciprocal of the cap."""
    return count.to(torch.float32) * _recip(cap)


def _columns(xs):
    """(p,) tensors -> (p, len(xs)); a view for one hop."""
    return xs[0][:, None] if len(xs) == 1 else torch.stack(xs, 1)


def route_wave(per_hop: Sequence[Mapping], hist):
    """Assemble one routing wave's telemetry from per-hop samples.

    ``per_hop[h]`` carries (p,) int32 ``demand_max`` (hottest bucket's
    message count), ``delivered`` (messages that fit), ``total`` (valid
    messages entering the hop), plus static ints ``cap`` and ``s``
    (peer-group size). ``hist`` is the hop-0 coarse histogram
    ``(p, HIST_BINS)`` int32."""
    f32 = torch.float32
    demand = [h["demand_max"].to(f32) for h in per_hop]
    return {
        "fill_max": _columns([d * _recip(h["cap"])
                              for d, h in zip(demand, per_hop)]),
        "fill_mean_sum": _columns([
            _over(h["delivered"], int(h["cap"]) * int(h["s"]))
            for h in per_hop]),
        "dest_frac_max": _columns([
            d / torch.clamp(h["total"].to(f32), min=1.0)
            for d, h in zip(demand, per_hop)]),
        "hist": hist.to(torch.int32),
        "rounds": torch.ones(demand[0].shape[0], dtype=torch.int32,
                             device=demand[0].device),
    }


def store_fill(p: int, depth: int, demand, cap: int):
    """A fill record for a non-routed capacity (sub/graph stores): the
    (p,) ``demand`` over the cap, carried in hop slot 0 of a
    route-shaped record so it merges uniformly with routing
    telemetry."""
    dev = demand.device
    rec = route_zero(p, depth, dev)
    fill = _over(demand, cap)
    fill_max = rec["fill_max"].clone()
    fill_max[:, 0] = fill
    mean = rec["fill_mean_sum"].clone()
    mean[:, 0] = torch.clamp(fill, max=1.0)
    rec["fill_max"] = fill_max
    rec["fill_mean_sum"] = mean
    rec["rounds"] = torch.ones(p, dtype=torch.int32, device=dev)
    return rec


# --------------------------------------------------------------------------
# the one device-to-host copy of a stage's record
# --------------------------------------------------------------------------

def to_host(tele, transport=None) -> dict:
    """A record of per-PE tensors as numpy arrays of the same shapes,
    through ONE device-to-host copy: every leaf's 32-bit words are laid
    side by side in one int32 tensor (float32 leaves bit-cast, not
    converted), copied, and split again on the host. With a
    ``transport`` whose leading axis holds only this process's PEs (the
    ``torch.distributed`` one), that buffer is first gathered from every
    rank in one uncounted call (``transport.gather_pes``), so the arrays
    cover all p PEs, as the virtual-PE transport's do."""
    leaves: list[tuple[tuple, torch.Tensor]] = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), v))

    walk(tele, ())
    p = leaves[0][1].shape[0]
    words = []
    for _, v in leaves:
        if v.dtype not in (torch.int32, torch.float32):
            raise TypeError(f"telemetry leaf of dtype {v.dtype}")
        words.append(v.contiguous().view(torch.int32).reshape(p, -1))
    flat = torch.cat(words, 1)
    if transport is not None:
        flat = transport.gather_pes(flat)
    flat = flat.cpu().numpy()
    p = flat.shape[0]
    out: dict = {}
    off = 0
    for (path, v), w in zip(leaves, words):
        width = w.shape[1]
        arr = flat[:, off:off + width]
        off += width
        if v.dtype == torch.float32:
            arr = arr.view(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr).reshape(
            (p,) + tuple(v.shape[1:]))
    return out


# --------------------------------------------------------------------------
# host half: aggregation across the PE axis
# --------------------------------------------------------------------------

def aggregate(per_pe):
    """Reduce a host telemetry record (:func:`to_host`) — every leaf
    carries a leading ``(p,)`` PE axis — to plain-python host values.
    MAX leaves reduce by max over PEs, additive leaves by sum; per-PE
    spread is preserved for the fill HWM (``fill_max_by_pe`` max over
    hops) so cross-PE skew stays visible."""
    def red(tree, key=None):
        if isinstance(tree, Mapping):
            return {k: red(v, k) for k, v in tree.items()}
        arr = np.asarray(tree)
        if key in MAX_KEYS:
            return arr.max(axis=0)
        return arr.sum(axis=0)

    agg = red(per_pe)

    def attach_spread(node, src):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                attach_spread(v, src[k])
            elif k == "fill_max":
                by_pe = np.asarray(src[k]).max(axis=-1)  # (p,)
                node["fill_max_pe_mean"] = float(by_pe.mean())

    attach_spread(agg, per_pe)
    return json_tele(agg)


def json_tele(tree):
    """Recursively convert telemetry leaves to JSON-safe python."""
    if isinstance(tree, Mapping):
        return {k: json_tele(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.ndim == 0:
        return float(arr) if np.issubdtype(arr.dtype, np.floating) else int(arr)
    return [json_tele(v) for v in arr.tolist()] if arr.dtype.kind == "O" \
        else [float(v) if np.issubdtype(arr.dtype, np.floating) else int(v)
              for v in arr.tolist()]


def utilization(agg: Mapping) -> dict:
    """Stage-level utilization summary from an aggregated record:
    ``util_max`` (worst mailbox fill HWM over hops and families) and
    ``util_mean`` (mean delivered fill over waves that actually ran).
    Always finite; a stage that routed nothing reports zeros."""
    util_max = 0.0
    mean_num = mean_den = 0.0
    for fam in STAGE_FAMILIES:
        rec = agg.get(fam)
        if not rec:
            continue
        rounds = float(rec.get("rounds", 0))
        if rec.get("fill_max"):
            util_max = max(util_max, max(rec["fill_max"]))
        if rounds > 0 and rec.get("fill_mean_sum"):
            mean_num += sum(rec["fill_mean_sum"])
            mean_den += rounds * len(rec["fill_mean_sum"])
    util_mean = (mean_num / mean_den) if mean_den else 0.0
    return {"util_max": float(util_max), "util_mean": float(util_mean)}


@dataclasses.dataclass(frozen=True)
class StageRecord:
    """One committed stage attempt's aggregated telemetry + the caps
    it was compiled with: ``caps[family] = (cap per hop/leg,)``."""
    label: str
    kind: str
    level: int
    caps: dict
    queue_cap: int
    tele: dict

    def to_json(self) -> dict:
        return {"label": self.label, "kind": self.kind, "level": self.level,
                "caps": {k: list(v) for k, v in self.caps.items()},
                "queue_cap": int(self.queue_cap), "tele": self.tele,
                **utilization(self.tele)}

    @classmethod
    def from_json(cls, d: Mapping) -> "StageRecord":
        return cls(label=d["label"], kind=d["kind"], level=int(d["level"]),
                   caps={k: tuple(v) for k, v in d["caps"].items()},
                   queue_cap=int(d["queue_cap"]), tele=d["tele"])


# --------------------------------------------------------------------------
# capacity headroom report
# --------------------------------------------------------------------------

def parse_scales(scales_str: str) -> dict:
    """``tuner.format_scales`` rendering ("chase=1,sub=2,...") → dict."""
    out = {}
    for part in str(scales_str).replace(";", ",").split(","):
        if "=" in part:
            k, _, v = part.strip().partition("=")
            try:
                out[k.strip()] = float(v)
            except ValueError:
                pass
    return out


def headroom_rows(records: Iterable[StageRecord],
                  final_scales: str | None = None) -> list[dict]:
    """The capacity headroom report: one row per (stage, family, hop)
    that saw traffic — observed max fill / compiled cap, headroom, and
    the escalation factor the final scales applied to that family (so
    every escalation in ``scales_log`` terms is explained by the fill
    that forced it)."""
    scales = parse_scales(final_scales) if final_scales else {}
    rows = []
    for rec in records:
        for fam in STAGE_FAMILIES:
            tele = rec.tele.get(fam)
            caps = rec.caps.get(fam)
            if not tele or not caps or not int(tele.get("rounds", 0)):
                continue
            fills = tele.get("fill_max", [])
            for hop, fill in enumerate(fills):
                cap = int(caps[min(hop, len(caps) - 1)])
                rows.append({
                    "stage": rec.label, "level": rec.level, "family": fam,
                    "hop": hop, "cap": cap, "fill_max": float(fill),
                    "headroom": 1.0 - float(fill),
                    "scale": float(scales.get(fam, 1.0)),
                    "dest_frac_max": float(tele["dest_frac_max"][hop]),
                    "rounds": int(tele["rounds"]),
                })
        if rec.queue_cap and int(rec.tele.get("queue_hwm", 0)):
            hwm = int(rec.tele["queue_hwm"])
            rows.append({
                "stage": rec.label, "level": rec.level, "family": "queue",
                "hop": 0, "cap": int(rec.queue_cap),
                "fill_max": hwm / max(int(rec.queue_cap), 1),
                "headroom": 1.0 - hwm / max(int(rec.queue_cap), 1),
                "scale": 1.0, "dest_frac_max": 0.0,
                "rounds": int(rec.tele.get("queue_hwm", 0) and 1)})
    return rows


def format_headroom_table(rows: Sequence[Mapping]) -> str:
    """Aligned-text capacity headroom report (mirrors
    ``obs.format_residual_table``)."""
    if not rows:
        return "(no telemetry recorded — run with cfg.telemetry=True)"
    hdr = ("stage", "family", "hop", "cap", "fill_max", "headroom",
           "scale", "skew")
    body = [(r["stage"], r["family"], str(r["hop"]), str(r["cap"]),
             f"{r['fill_max']:.3f}", f"{r['headroom']:+.3f}",
             f"x{r['scale']:g}", f"{r['dest_frac_max']:.3f}")
            for r in rows]
    widths = [max(len(h), *(len(b[i]) for b in body))
              for i, h in enumerate(hdr)]
    fmt = "  ".join(f"{{:<{w}}}" if i < 2 else f"{{:>{w}}}"
                    for i, w in enumerate(widths))
    lines = [fmt.format(*hdr), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*b) for b in body]
    worst = max(rows, key=lambda r: r["fill_max"])
    lines.append(
        f"worst fill {worst['fill_max']:.3f} of cap {worst['cap']} "
        f"({worst['stage']}/{worst['family']} hop {worst['hop']})")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# DKW back-test against tuner.estimate_capacities
# --------------------------------------------------------------------------

def dkw_margin(sample_size: int, n_buckets: int) -> float:
    """The DKW/Hoeffding additive margin ``tuner.estimate_capacities``
    adds to the hottest-bucket sample fraction (same formula)."""
    return math.sqrt(math.log(2.0 * n_buckets + 2.0)
                     / (2.0 * max(sample_size, 1)))


def dkw_backtest(max_frac: Sequence[float], sample_size: int,
                 hop_sizes: Sequence[int],
                 records: Iterable[StageRecord]) -> list[dict]:
    """Back-test the sampled-splitter estimate against observed fills.

    For each hop: the estimate's w.h.p. bound ``min(1, f_hat + margin)``
    on the hottest-bucket traffic fraction vs the worst
    ``dest_frac_max`` the telemetry actually observed across stages.
    ``ok`` means the observed skew stayed under the bound — the DKW
    margin held."""
    observed = {}
    for rec in records:
        for fam in STAGE_FAMILIES:
            tele = rec.tele.get(fam)
            if not tele or not int(tele.get("rounds", 0)):
                continue
            for hop, frac in enumerate(tele.get("dest_frac_max", [])):
                observed[hop] = max(observed.get(hop, 0.0), float(frac))
    rows = []
    for hop, (f_hat, s) in enumerate(zip(max_frac, hop_sizes)):
        margin = dkw_margin(sample_size, s)
        bound = min(1.0, float(f_hat) + margin)
        obs = observed.get(hop, 0.0)
        rows.append({"hop": hop, "hop_size": int(s),
                     "sampled_frac": float(f_hat), "margin": margin,
                     "bound": bound, "observed_frac": obs,
                     "ok": obs <= bound})
    return rows


__all__ = [
    "HIST_BINS", "MAX_KEYS", "STAGE_FAMILIES", "TELEMETRY_HELP",
    "route_zero", "stage_zero", "merge", "route_wave", "store_fill", "to_host", "aggregate", "json_tele", "utilization",
    "StageRecord",
    "parse_scales", "headroom_rows", "format_headroom_table",
    "dkw_margin", "dkw_backtest",
]
